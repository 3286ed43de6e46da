"""Multi-process parallelism on torch.distributed: the 1-D mesh of ranks,
the distributed NTT, the sharded commitment and the sharded prover.

Port of ``eth_lc_plonky2_tpu/parallel/``:

  mesh.py         the Mesh: a rank's blocks and the exchanges of field words
  distributed.py  initialize (ELP_* or env:// variables), the global mesh
  ntt.py          the point-sharded NTT: the four-step with three all-to-alls
  commit.py       column-sharded transforms, one all-to-all to points, local
                  leaves and levels, the cap gathered
  prover.py       shard_prover_data and prove_sharded: the one-device
                  prove's phases with every exchange scheduled here
"""
