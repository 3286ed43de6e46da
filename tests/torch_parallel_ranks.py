"""The ranks of tests/test_torch_parallel.py: each a spawned process that
imports only the port (no jax), joins a gloo group through a FileStore and
puts its results, as host words, on a queue."""

import json
import os
import time

import numpy as np
import torch

import chip_smoke
from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.parallel import commit as pcommit
from eth_lc_plonky2_tpu_torch.parallel import distributed as dist
from eth_lc_plonky2_tpu_torch.parallel import ntt as pntt
from eth_lc_plonky2_tpu_torch.parallel import prover as pprover
from eth_lc_plonky2_tpu_torch.prover import prove as pr

NTT_CASES = [(8, False), (8, True), (10, False), (10, True)]
LDE_LOG, LDE_RATE = 8, 2
COMMIT_SHAPE, RATE, CAP = (16, 256), 3, 4


def inputs() -> dict:
    rng = np.random.default_rng(11)
    return {
        "ntt": {log_n: rng.integers(0, gl.P, size=(2, 1 << log_n), dtype=np.uint64)
                for log_n in (8, 10)},
        "lde": rng.integers(0, gl.P, size=(3, 1 << LDE_LOG), dtype=np.uint64),
        "commit": rng.integers(0, gl.P, size=COMMIT_SHAPE, dtype=np.uint64),
    }


def _rank(rank: int, size: int, store: str, from_env: bool, queue) -> None:
    """One rank: every check's result, gathered to host words, on the queue."""
    torch.set_num_threads(1)
    from eth_lc_plonky2_tpu_torch.prover import serialize
    from eth_lc_plonky2_tpu_torch.prover.verify import verify

    if from_env:
        os.environ.update({"ELP_COORDINATOR": "file://" + store, "ELP_NUM_PROCESSES": str(size),
                           "ELP_PROCESS_ID": str(rank)})
        dist.initialize(device="cpu")
    else:
        dist.initialize("file://" + store, size, rank, device="cpu")
    mesh = dist.make_global_mesh()
    inp = inputs()
    out = {"world": (torch.distributed.get_world_size(), torch.distributed.get_rank()),
           "backend": mesh.backend, "multiprocess": dist.is_multiprocess()}
    mine = torch.arange(4, dtype=torch.int64) + (-1 << 63) + 10 * rank  # bit patterns, the sign bit set
    out["broadcast"] = mesh.broadcast(mine.clone()).tolist()
    out["gather"] = mesh.all_gather(mine).tolist()
    for log_n, inverse in NTT_CASES:
        x = gl.from_u64(inp["ntt"][log_n])[:, mesh.block(1 << log_n)]
        y = pntt.make_dist_ntt(mesh, 1 << log_n, inverse)(x)
        out[("ntt", log_n, inverse)] = dist.fetch(y, mesh, axis=1)
    x = gl.from_u64(inp["lde"])[:, mesh.block(1 << LDE_LOG)]
    y = pntt.make_dist_coset_lde(mesh, 1 << LDE_LOG, LDE_RATE)(x)
    out["lde"] = dist.fetch(y, mesh, axis=1)
    rows = pcommit.column_rows(mesh, COMMIT_SHAPE[0])
    values = pprover._rows_block(mesh, inp["commit"], rows)
    batch, window = pcommit.make_sharded_commit(mesh, RATE, CAP)(gl.from_u64(values), rows)
    out["commit"] = (dist.fetch(batch.lde, mesh, axis=1), dist.fetch(batch.tree.levels[0], mesh, axis=0),
                     batch.cap, batch.lde.data_ptr() == window.data_ptr())
    data, w = chip_smoke.dryrun_circuit()
    pd, vk = pr.preprocess(data, device="cpu")
    proof = pprover.prove_sharded(pd, w, mesh)
    verify(data, vk, proof)  # raises VerificationError
    out["proof"] = json.dumps(serialize.proof_to_dict(proof, include_indices=True))
    queue.put((rank, out))
    dist.shutdown()


def failing_rank(rank: int, size: int, how: str, queue) -> None:
    """Rank 0 waits without results; the last rank ``raise``s, or
    ``exit``s with code 0 before it puts any."""
    if rank == 0:
        time.sleep(120)
    if how == "raise":
        raise RuntimeError(f"rank {rank} fails")


def run_ranks(size: int, store: str, from_env: bool = False) -> dict:
    """Spawn ``size`` ranks and collect {rank: results}; a rank that fails
    fails the call at once."""
    procs, queue = dist.spawn_ranks(_rank, size, (store, from_env))
    return dist.collect_ranks(procs, queue, timeout_s=300)
