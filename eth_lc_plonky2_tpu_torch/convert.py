"""Carry state from the JAX package into the port and back.

Neither jax nor the JAX package is imported: their arrays are read
through ``np.asarray``.

* a (lo, hi) u32 limb pair (the JAX package's field array) or a uint64
  ndarray becomes an int64 field tensor, and back;
* a JAX ``MerkleTree`` / ``CommitmentBatch`` becomes the port's, on the
  CPU (the card has no JAX; ``.to("cuda")`` moves a tensor there);
* a JAX ``CircuitData``, witness, ``Proof`` or ``VerifierKey`` becomes the
  port's, and a proof of the port one that the JAX package's verifier reads.
"""

from __future__ import annotations

import numpy as np
import torch

from .circuit.builder import CircuitData, Target, Witness
from .circuit.gates import gate_from_spec
from .ops import goldilocks as gl
from .prover.config import CircuitConfig, FriConfig
from .prover.fri import FriProof, FriQueryProof
from .prover.merkle import MerkleTree
from .prover.prove import CommitmentBatch, OpeningSet, Proof, VerifierKey


def field_to_torch(f) -> torch.Tensor:
    """(lo, hi) limb pair or uint64 array -> int64 field tensor."""
    if isinstance(f, tuple):
        lo = np.asarray(f[0], dtype=np.uint64)
        hi = np.asarray(f[1], dtype=np.uint64)
        f = (hi << np.uint64(32)) | lo
    return gl.from_u64(np.asarray(f, dtype=np.uint64))


def field_to_limbs(t: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """int64 field tensor -> (lo, hi) uint32 numpy pair, the JAX package's layout."""
    a = gl.to_u64(t)
    return (a & np.uint64(0xFFFF_FFFF)).astype(np.uint32), (a >> np.uint64(32)).astype(np.uint32)


def merkle_tree_from_jax(tree) -> MerkleTree:
    return MerkleTree(
        leaves=field_to_torch(tree.leaves),
        levels=[field_to_torch(level) for level in tree.levels],
        cap_height=tree.cap_height,
        leaf_axis=tree.leaf_axis,
    )


def commitment_batch_from_jax(batch) -> CommitmentBatch:
    tree = merkle_tree_from_jax(batch.tree)
    coeffs = field_to_torch(batch.coeffs)
    lde = tree.leaves if batch.lde is batch.tree.leaves else field_to_torch(batch.lde)
    return CommitmentBatch(coeffs=coeffs, lde=lde, tree=tree)


# ---------------------------------------------------------------------------
# Circuits, witnesses and proofs
# ---------------------------------------------------------------------------


def circuit_data_from_jax(data) -> CircuitData:
    """A JAX-package ``CircuitData`` -> the port's: the config's numbers, the
    gates through their (type, parameters) specs, copies of the numpy tables.
    The witness generators are carried over as they are (host closures over
    Python integers that reach their witness only through ``get`` / ``set``)."""
    c = data.config
    f = c.fri
    cfg = CircuitConfig(
        num_wires=c.num_wires, num_routed_wires=c.num_routed_wires,
        num_constants=c.num_constants, num_challenges=c.num_challenges,
        permutation_chunk_size=c.permutation_chunk_size,
        fri=FriConfig(rate_bits=f.rate_bits, cap_height=f.cap_height,
                      proof_of_work_bits=f.proof_of_work_bits,
                      num_query_rounds=f.num_query_rounds, final_poly_bits=f.final_poly_bits))
    gates = [gate_from_spec(_gate_spec(g)) for g in data.gates]
    return CircuitData(
        config=cfg, log_n=int(data.log_n), num_rows_used=int(data.num_rows_used),
        gate_names=list(data.gate_names), gates=gates,
        selectors=np.array(data.selectors, dtype=np.uint64),
        constants=np.array(data.constants, dtype=np.uint64),
        sigma=np.array(data.sigma, dtype=np.uint64),
        rep=np.array(data.rep, dtype=np.int64),
        generators=list(data.generators),
        public_input_targets=[Target(int(r), int(c2)) for r, c2 in data.public_input_targets],
        k_shifts=np.array(data.k_shifts, dtype=np.uint64))


def _gate_spec(g) -> dict:
    """The spec of a gate of either package, read from its plain attributes."""
    spec = {"type": g.name}
    for key in ("num_ops", "num_bits", "num_slots"):
        if hasattr(g, key):
            spec[key] = int(getattr(g, key))
    return spec


class MatrixWitness:
    """A witness given as its full (num_wires, n) matrix: what ``prove`` reads
    of a witness (``full_matrix`` and ``get``)."""

    def __init__(self, matrix: np.ndarray):
        self.matrix = np.ascontiguousarray(matrix, dtype=np.uint64)

    def full_matrix(self) -> np.ndarray:
        return self.matrix

    def get(self, t) -> int:
        return int(self.matrix[t[1], t[0]])


def witness_from_jax(witness, data: CircuitData) -> Witness:
    """A JAX-package ``Witness`` -> the port's ``Witness`` of ``data`` (the
    port's copy of the same circuit): its slot values and known flags."""
    w = Witness(data)
    w.values[:] = np.asarray(witness.values, dtype=np.uint64)
    w.known[:] = np.asarray(witness.known, dtype=bool)
    return w


def witness_matrix(witness) -> MatrixWitness:
    """A generated witness of either package -> one the port's ``prove`` takes."""
    return MatrixWitness(np.asarray(witness.full_matrix(), dtype=np.uint64))


def _copy_proof(proof) -> Proof:
    fp = proof.fri_proof
    u64 = lambda a: np.array(a, dtype=np.uint64)  # noqa: E731
    return Proof(
        public_inputs=u64(proof.public_inputs), wires_cap=u64(proof.wires_cap),
        zs_cap=u64(proof.zs_cap), quotient_cap=u64(proof.quotient_cap),
        openings=OpeningSet(values={(str(t), int(o)): u64(v)
                                    for (t, o), v in proof.openings.values.items()}),
        fri_proof=FriProof(
            layer_caps=[u64(c) for c in fp.layer_caps], final_poly=u64(fp.final_poly),
            pow_witness=int(fp.pow_witness), query_indices=[int(i) for i in fp.query_indices],
            query_proofs=[FriQueryProof(
                batch_leaves={t: u64(v) for t, v in qp.batch_leaves.items()},
                batch_paths={t: [u64(d) for d in v] for t, v in qp.batch_paths.items()},
                layer_leaves=[u64(v) for v in qp.layer_leaves],
                layer_paths=[[u64(d) for d in p] for p in qp.layer_paths])
                for qp in fp.query_proofs]))


def proof_from_jax(proof) -> Proof:
    """A JAX-package ``Proof`` -> the port's (numpy arrays and ints only)."""
    return _copy_proof(proof)


def verifier_key_from_jax(vk) -> VerifierKey:
    """A JAX-package ``VerifierKey`` -> the port's."""
    return VerifierKey(pre_cap=np.array(vk.pre_cap, dtype=np.uint64))


def proof_to_jax(proof: Proof) -> Proof:
    """The port's ``Proof`` for the JAX package's verifier, which reads a proof
    through its attributes only (numpy arrays and ints): a deep copy, so a
    caller may change it without touching the original."""
    return _copy_proof(proof)
