"""PyTorch/CUDA port of the eth_lc_plonky2_tpu prover, for one NVIDIA H100.

``prover.prove.prove(pd, witness)`` returns a whole proof (commitments,
permutation argument, quotient, openings, FRI), byte-identical to the JAX
package's, for every circuit the JAX package builds: the generic, SHA-256 and
Poseidon gates, the light-client circuit, the recursive verifier and the BLS
inner circuits.  ``cli.py`` proves the flagship (``--synthetic 512 --bls
dummy``) and the aggregate (``--bls aggregate:slices=N``); ``parallel/``
shards a proof over ranks.  Five hand-written CUDA sources carry it:
``csrc/ntt.cu``, ``csrc/poseidon.cu``, ``csrc/field.cu``, ``csrc/gates.cu``
and ``csrc/sha256.cu``.  Field tensors are int64 holding the canonical u64
bits.  A CUDA tensor runs the kernels; a CPU tensor runs the plain PyTorch
versions.  ELP_PROFILE=1 prints each proof's phase times
(``prover/profiler.py``).  Nothing here imports jax or the JAX package.
"""

__version__ = "0.1.0"
