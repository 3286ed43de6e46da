"""SHA-256 Merkle tree / Merkle proof gadgets.

Copy of ``eth_lc_plonky2_tpu/circuit/gadgets_merkle.py`` (the port keeps
its own; host-only builder code):
  - add_virtual_merkle_tree_sha256 (full binary tree, 2^h leaves,
    next layer computed bottom-up);
  - add_verify_merkle_proof (fixed leaf index baked at build time,
    left/right ordering by index parity per level);
  - add_verify_merkle_proof_conditional (root equality gated by a
    boolean via mul-masking);
plus witness setters.

Every tree level is hashed by ONE batched SHA trace pass instead of
per-node generators.
"""

from __future__ import annotations

import dataclasses

import hashlib

from .builder import CircuitBuilder, Target
from .gadgets_sha256 import (
    Hash256,
    add_virtual_hash256,
    connect_hash256,
    set_hash256,
    two_to_one_sha256,
    two_to_one_sha256_batch,
)


@dataclasses.dataclass
class MerkleTreeSha256Target:
    root: Hash256
    leaves: list


@dataclasses.dataclass
class VerifyMerkleProofTarget:
    leaf: Hash256
    proof: list
    root: Hash256


@dataclasses.dataclass
class VerifyMerkleProofConditionalTarget:
    leaf: Hash256
    proof: list
    root: Hash256
    v: Target  # boolean: whether the root equality is enforced


def add_virtual_merkle_tree_sha256(b: CircuitBuilder, height: int) -> MerkleTreeSha256Target:
    """Full tree with 2^height leaf Hash256 targets; root recomputed
    level by level (each level one batched SHA call)."""
    num_leaves = 1 << height
    leaves = [add_virtual_hash256(b) for _ in range(num_leaves)]
    layer = leaves
    while len(layer) > 1:
        pairs = [(layer[i], layer[i + 1]) for i in range(0, len(layer), 2)]
        layer = two_to_one_sha256_batch(b, pairs)
    return MerkleTreeSha256Target(root=layer[0], leaves=leaves)


def add_verify_merkle_proof(b: CircuitBuilder, leaf_index: int, height: int) -> VerifyMerkleProofTarget:
    """Verify a Merkle branch for a build-time-fixed leaf index."""
    root = add_virtual_hash256(b)
    leaf = add_virtual_hash256(b)
    proof = []
    cur = leaf
    idx = leaf_index
    for _ in range(height):
        sib = add_virtual_hash256(b)
        proof.append(sib)
        if idx % 2 == 0:
            cur = two_to_one_sha256(b, cur, sib)
        else:
            cur = two_to_one_sha256(b, sib, cur)
        idx //= 2
    connect_hash256(b, cur, root)
    return VerifyMerkleProofTarget(leaf=leaf, proof=proof, root=root)


def add_verify_merkle_proof_conditional(
    b: CircuitBuilder, leaf_index: int, height: int
) -> VerifyMerkleProofConditionalTarget:
    """Like add_verify_merkle_proof, but the computed-root == claimed-root
    equality is enforced only when boolean v is 1 (mul-masked equality)."""
    root = add_virtual_hash256(b)
    leaf = add_virtual_hash256(b)
    v = b.add_virtual_bool_target()
    proof = []
    cur = leaf
    idx = leaf_index
    for _ in range(height):
        sib = add_virtual_hash256(b)
        proof.append(sib)
        if idx % 2 == 0:
            cur = two_to_one_sha256(b, cur, sib)
        else:
            cur = two_to_one_sha256(b, sib, cur)
        idx //= 2
    for i in range(8):
        masked_cur = b.mul(v, cur[i])
        masked_root = b.mul(v, root[i])
        b.assert_equal(masked_cur, masked_root)
    return VerifyMerkleProofConditionalTarget(leaf=leaf, proof=proof, root=root, v=v)


# ---------------------------------------------------------------------------
# Witness setters
# ---------------------------------------------------------------------------


def set_verify_merkle_proof_target(w, leaf32: bytes, proof32s: list, target: VerifyMerkleProofTarget):
    set_hash256(w, target.leaf, leaf32)
    for sib_t, sib in zip(target.proof, proof32s):
        set_hash256(w, sib_t, sib)


def set_partial_merkle_tree_sha256_target(w, leaves32: list, target: MerkleTreeSha256Target):
    for leaf_t, leaf in zip(target.leaves, leaves32):
        set_hash256(w, leaf_t, leaf)


def merkle_root_sha256(leaves32: list) -> bytes:
    """Host-side reference root (hashlib) for expected values."""
    layer = list(leaves32)
    while len(layer) > 1:
        layer = [
            hashlib.sha256(layer[i] + layer[i + 1]).digest() for i in range(0, len(layer), 2)
        ]
    return layer[0]
