"""The light-client statement, worked out from an update's raw fields.

The circuit's 16 public inputs are the big-endian u32 limbs of two SSZ roots
of the light client's ``ContractState`` (slot, header root, committee i,
committee ii; a height-2 tree): the current state, and the new state after the
update's finalized header and the committee rollover.  Under the rollover the
new state's first committee is the signing committee, and its second is the
update's next committee.  Standard library only.
"""

from __future__ import annotations

import hashlib


def _h(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(left + right).digest()


def _merkleize(leaves: list) -> bytes:
    n = 1
    while n < len(leaves):
        n *= 2
    layer = list(leaves) + [b"\x00" * 32] * (n - len(leaves))
    while len(layer) > 1:
        layer = [_h(layer[i], layer[i + 1]) for i in range(0, len(layer), 2)]
    return layer[0]


def _u64(v: int) -> bytes:
    return int(v).to_bytes(8, "little") + b"\x00" * 24


def committee_root(pubkeys: list, aggregate: bytes) -> bytes:
    """hash_tree_root(SyncCommittee{pubkeys, aggregate_pubkey})."""
    def pk_chunks(pk):
        return [pk[:32], pk[32:] + b"\x00" * 16]

    chunks = [c for pk in pubkeys for c in pk_chunks(pk)]
    return _h(_merkleize(chunks), _merkleize(pk_chunks(aggregate)))


def header_root(h: dict) -> bytes:
    return _merkleize([_u64(h["slot"]), _u64(h["proposer_index"]), h["parent_root"],
                       h["state_root"], h["body_root"]])


def state_root(slot: int, header: bytes, committee_i: bytes, committee_ii: bytes) -> bytes:
    return _merkleize([_u64(slot), header, committee_i, committee_ii])


def expected_public_inputs(raw: dict) -> list:
    signing = committee_root(raw["signing_pubkeys"], raw["signing_aggregate"])
    nxt = committee_root(raw["next_pubkeys"], raw["next_aggregate"])
    fin = raw["finalized"]
    cur = state_root(raw["cur_slot"], raw["cur_header"], raw["cur_committee_i"], signing)
    new = state_root(fin["slot"], header_root(fin), signing, nxt)
    return [int.from_bytes(root[i:i + 4], "big") for root in (cur, new) for i in range(0, 32, 4)]
