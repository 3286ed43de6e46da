"""Minimal SSZ hash-tree-root for the beacon-chain containers this
framework proves over.

Copy of ``eth_lc_plonky2_tpu/eth/ssz.py`` (the port keeps its own;
standard library only).  The counterpart of upstream's `tree_hash` /
`eth-types` usage: BeaconBlockHeader root, SyncCommittee root,
SigningData root, ContractState root.  All host code must bit-match the
in-circuit subcircuits (``models/lc_circuit.py``, which follow upstream's
targets.rs).
"""

from __future__ import annotations

import hashlib


def sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def hash_pair(l: bytes, r: bytes) -> bytes:
    return sha256(l + r)


def uint64_leaf(v: int) -> bytes:
    """SSZ: uint64 little-endian, right-padded to 32 bytes."""
    return int(v).to_bytes(8, "little") + b"\x00" * 24


def uint256_leaf(v: int) -> bytes:
    return int(v).to_bytes(32, "little")


def merkleize(leaves: list[bytes]) -> bytes:
    """Merkleize chunks (pad with zero-chunks to next power of two)."""
    n = 1
    while n < len(leaves):
        n *= 2
    layer = list(leaves) + [b"\x00" * 32] * (n - len(leaves))
    while len(layer) > 1:
        layer = [hash_pair(layer[i], layer[i + 1]) for i in range(0, len(layer), 2)]
    return layer[0]


def beacon_block_header_root(slot: int, proposer_index: int, parent_root: bytes,
                             state_root: bytes, body_root: bytes) -> bytes:
    """hash_tree_root(BeaconBlockHeader) — height-3 tree of 8 leaves
    (5 fields + 3 zero pads), matching targets.rs:147-181."""
    leaves = [
        uint64_leaf(slot),
        uint64_leaf(proposer_index),
        parent_root,
        state_root,
        body_root,
    ]
    return merkleize(leaves + [b"\x00" * 32] * 3)


def pubkey_leaves(pubkey48: bytes) -> tuple[bytes, bytes]:
    """A 48-byte BLS pubkey spans two 32-byte chunks (second zero-padded)."""
    assert len(pubkey48) == 48
    return pubkey48[:32], pubkey48[32:] + b"\x00" * 16


def pubkey_root(pubkey48: bytes) -> bytes:
    l, r = pubkey_leaves(pubkey48)
    return hash_pair(l, r)


def sync_committee_root(pubkeys: list[bytes], aggregate_pubkey: bytes) -> bytes:
    """hash_tree_root(SyncCommittee{pubkeys: Vector[BLSPubkey, 512],
    aggregate_pubkey}) — matches sync_committee_pubkeys.rs:47-87:
    a height-10 tree over 1024 pubkey half-chunks, the aggregate's
    height-1 tree, then the 2-field container root.  Any power-of-two
    committee size is supported (reduced synthetic committees use the
    same shape at a smaller height)."""
    assert pubkeys and len(pubkeys) & (len(pubkeys) - 1) == 0
    chunks = []
    for pk in pubkeys:
        l, r = pubkey_leaves(pk)
        chunks.append(l)
        chunks.append(r)
    pubkeys_root = merkleize(chunks)  # 1024 chunks, height 10
    agg_root = pubkey_root(aggregate_pubkey)
    return hash_pair(pubkeys_root, agg_root)


def signing_data_root(object_root: bytes, domain: bytes) -> bytes:
    """hash_tree_root(SigningData) = merkleize([object_root, domain]) —
    the reference's compute_signing_root (utils.rs:229-237)."""
    return hash_pair(object_root, domain)


def contract_state_root(slot: int, header_root: bytes,
                        sync_committee_i: bytes, sync_committee_ii: bytes) -> bytes:
    """The ContractState root: height-2 tree of [slot, header,
    committee_i, committee_ii] (main.rs:21-27, targets.rs:334-389)."""
    return merkleize([
        uint64_leaf(slot), header_root, sync_committee_i, sync_committee_ii
    ])
