"""Seeded light-client update pairs: the benchmark's inputs.

A copy of the program's synthetic generator (``eth/synthetic.py`` and the
parts of ``eth/ssz.py`` and ``eth/domain.py`` it uses), kept here so that the
inputs are the benchmark's own.  Standard library and numpy only.

A pair is consistent with every constraint of the light-client circuit: a
64-leaf attested-state tree holds the finalized header at leaf 41 and the
current and next committee roots at depth-5 nodes 22 and 23, so the finality
branch (height 6) and the committee branch (height 5) verify against the same
attested state root, and the committee branch's first sibling is the signing
committee's root (the rollover constraint).

``make_update`` returns ``(witness_kwargs, raw)``: ``witness_kwargs`` is what
the program's witness setter takes; ``raw`` is the update's fields as they
came from the generator, which the reference reads to work out the expected
public inputs itself.
"""

from __future__ import annotations

import hashlib

import numpy as np

SLOTS_PER_PERIOD = 32 * 256
DOMAIN_SYNC_COMMITTEE = bytes.fromhex("07000000")
MAINNET_GENESIS_VALIDATORS_ROOT = bytes.fromhex(
    "4b363db94e286120d76eb905340fdd4e54bfe9f06bf33ff6cf5ad27f511bfe95")
MAINNET_FORKS = [  # (fork epoch, version), ascending
    (0, "00000000"), (74240, "01000000"), (144896, "02000000"),
    (194048, "03000000"), (269568, "04000000"), (364032, "05000000"),
]
FINALIZED_HEADER_POS = 105 - 64
NEXT_COMMITTEE_POS = 55 - 32
CUR_COMMITTEE_POS = 54 - 32


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and a sub-stream."""
    return np.random.default_rng([seed % (1 << 64), *stream])


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


def _u64_leaf(v: int) -> bytes:
    return int(v).to_bytes(8, "little") + b"\x00" * 24


def _header_root(slot, proposer, parent, state, body) -> bytes:
    return _merkleize([_u64_leaf(slot), _u64_leaf(proposer), parent, state, body]
                      + [b"\x00" * 32] * 3)


def _committee_root(pubkeys: list, aggregate: bytes) -> bytes:
    chunks = []
    for pk in pubkeys + [aggregate]:
        chunks += [pk[:32], pk[32:] + b"\x00" * 16]
    agg = _h(chunks[-2], chunks[-1])
    return _h(_merkleize(chunks[:-2]), agg)


def _state_root(slot, header, committee_i, committee_ii) -> bytes:
    return _merkleize([_u64_leaf(slot), header, committee_i, committee_ii])


def _domain(slot: int) -> bytes:
    epoch = slot // 32
    version = next(v for e, v in reversed(MAINNET_FORKS) if epoch >= e)
    fork_data = _h(bytes.fromhex(version) + b"\x00" * 28, MAINNET_GENESIS_VALIDATORS_ROOT)
    return DOMAIN_SYNC_COMMITTEE + fork_data[:28]


def _bytes(rng, n: int) -> bytes:
    return bytes(rng.integers(0, 256, n, dtype=np.uint8))


def _branch(levels: list, pos: int, start: int) -> list:
    out, idx = [], pos
    for level in levels[start:-1]:
        out.append(level[idx ^ 1])
        idx //= 2
    return out


def make_update(rng, committee_size: int, participation: int) -> tuple[dict, dict]:
    """One consistent (cur, new) update pair with a rollover of the period."""
    signing = [_bytes(rng, 48) for _ in range(committee_size)]
    signing_agg = _bytes(rng, 48)
    c1 = _committee_root(signing, signing_agg)
    nxt = [_bytes(rng, 48) for _ in range(committee_size)]
    nxt_agg = _bytes(rng, 48)
    c2 = _committee_root(nxt, nxt_agg)

    period = 633
    cur_slot = period * SLOTS_PER_PERIOD + 96
    attested_slot = (period + 1) * SLOTS_PER_PERIOD + 630
    finalized_slot = (period + 1) * SLOTS_PER_PERIOD + 96

    fin = dict(slot=finalized_slot, proposer_index=int(rng.integers(0, 1 << 20)),
               parent_root=_bytes(rng, 32), state_root=_bytes(rng, 32), body_root=_bytes(rng, 32))
    fin_root = _header_root(fin["slot"], fin["proposer_index"], fin["parent_root"],
                            fin["state_root"], fin["body_root"])
    leaves = [_bytes(rng, 32) for _ in range(64)]
    leaves[FINALIZED_HEADER_POS] = fin_root
    depth5 = [_h(leaves[i], leaves[i + 1]) for i in range(0, 64, 2)]
    depth5[CUR_COMMITTEE_POS] = c1
    depth5[NEXT_COMMITTEE_POS] = c2
    levels = [leaves, depth5]
    while len(levels[-1]) > 1:
        cur = levels[-1]
        levels.append([_h(cur[i], cur[i + 1]) for i in range(0, len(cur), 2)])
    attested_state_root = levels[-1][0]
    finality_branch = _branch(levels, FINALIZED_HEADER_POS, 0)
    committee_branch = _branch(levels, NEXT_COMMITTEE_POS, 1)

    att = dict(slot=attested_slot, proposer_index=int(rng.integers(0, 1 << 20)),
               parent_root=_bytes(rng, 32), state_root=attested_state_root,
               body_root=_bytes(rng, 32))
    att_root = _header_root(att["slot"], att["proposer_index"], att["parent_root"],
                            att["state_root"], att["body_root"])
    domain = _domain(attested_slot)
    signing_root = _h(att_root, domain)
    cur_committee_i = _bytes(rng, 32)  # not read on the rollover path
    bits = [1] * participation + [0] * (committee_size - participation)
    cur_header = _bytes(rng, 32)
    signature = _bytes(rng, 96)

    witness_kwargs = dict(
        signing_root=signing_root, domain=domain,
        attested_slot=att["slot"], attested_proposer_index=att["proposer_index"],
        attested_parent_root=att["parent_root"], attested_state_root=att["state_root"],
        attested_body_root=att["body_root"],
        finalized_slot=fin["slot"], finalized_proposer_index=fin["proposer_index"],
        finalized_parent_root=fin["parent_root"], finalized_state_root=fin["state_root"],
        finalized_body_root=fin["body_root"],
        finality_branch=finality_branch,
        cur_state=_state_root(cur_slot, cur_header, cur_committee_i, c1),
        new_state=_state_root(finalized_slot, fin_root, committee_branch[0], c2),
        cur_slot=cur_slot, cur_header=cur_header,
        cur_sync_committee_i=cur_committee_i, cur_sync_committee_ii=c1,
        new_sync_committee_i=committee_branch[0], new_sync_committee_ii=c2,
        sync_committee_bits=bits, new_sync_committee_ii_branch=committee_branch,
        sync_committee_pubkeys=signing, sync_committee_aggregate=signing_agg,
        signature=signature,
    )
    raw = dict(
        cur_slot=cur_slot, cur_header=cur_header, cur_committee_i=cur_committee_i,
        signing_pubkeys=signing, signing_aggregate=signing_agg,
        next_pubkeys=nxt, next_aggregate=nxt_agg, finalized=fin,
        signing_root=signing_root, signature=signature, bits=bits,
    )
    return witness_kwargs, raw
