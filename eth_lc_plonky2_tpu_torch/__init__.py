"""PyTorch/CUDA port of the eth_lc_plonky2_tpu prover, for one NVIDIA H100.

``prover.prove.prove(pd, witness)`` returns a whole proof (commitments,
permutation argument, quotient, openings, FRI), byte-identical to the JAX
package's, for circuits of the generic gates built with ``circuit.builder``.
Three hand-written CUDA sources carry it: ``csrc/ntt.cu``,
``csrc/poseidon.cu`` and ``csrc/field.cu``.  Field tensors are int64 holding
the canonical u64 bits.  A CUDA tensor runs the kernels; a CPU tensor runs
the plain PyTorch versions.  Nothing here imports jax or the JAX package.
"""
