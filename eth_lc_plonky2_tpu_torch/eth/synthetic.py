"""Synthetic, fully consistent light-client update pairs.

Copy of ``eth_lc_plonky2_tpu/eth/synthetic.py`` (the port keeps its own).
Generates witness data satisfying EVERY constraint of the full LC
circuit (models/lc_circuit.py, which follows upstream's targets.rs) at
any power-of-two
committee size — so the complete end-to-end pipeline (the reference's
main.rs flow) can be proven and negatively tested without the 512-key
mainnet fixtures.

Construction: a real 64-leaf (height-6) attested-state Merkle tree is
built with
  - leaf 41  (generalized index 105, FINALIZED_HEADER_INDEX)  = finalized header root
  - depth-5 node 22 (generalized index 54, current committee) = signing-committee root
  - depth-5 node 23 (generalized index 55, next committee)    = next-committee root
so the finality branch (height 6) and the committee branch (height 5)
both verify against the same attested_state_root, exactly as in a real
beacon state. The committee branch's first sibling is node 22, which
makes the circuit's `new_sync_committee_i == cur_sync_committee_ii`
rollover constraint hold by construction (targets.rs:267-291).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import ssz
from .domain import (
    DOMAIN_SYNC_COMMITTEE,
    SLOTS_PER_PERIOD,
    compute_domain,
    compute_signing_root,
    fork_version_at_slot,
)

FINALIZED_HEADER_POS = 105 - 64  # leaf 41 in the 64-leaf (height-6) state tree
NEXT_COMMITTEE_POS = 55 - 32  # node 23 in the depth-5 (32-node) layer
CUR_COMMITTEE_POS = 54 - 32  # node 22


@dataclasses.dataclass
class SyntheticUpdate:
    """Everything `models.lc_circuit.set_proof_target` needs, plus the
    expected public-input roots."""

    witness_kwargs: dict
    cur_state: bytes
    new_state: bytes
    committee_size: int
    threshold: int


def _rand32(rng) -> bytes:
    return bytes(rng.integers(0, 256, 32, dtype=np.uint8))


def _branch(levels: list, pos: int, start_level: int) -> list:
    """Siblings along the path from `pos` at `start_level` up to the root.

    levels[k] is the list of nodes at depth (height - k); levels[0] is
    the widest layer passed in."""
    out = []
    idx = pos
    for lvl in levels[start_level:-1]:
        out.append(lvl[idx ^ 1])
        idx //= 2
    return out


def make_valid_pubkey(rng) -> bytes:
    """A compressed G1 point actually on the BLS12-381 curve (random x
    until x^3+4 is a square, random sign) — required by the in-circuit
    aggregate-pubkey path (models/bls_aggregate), which enforces the
    curve equation; random byte strings are almost never valid points."""
    q = int(
        "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
        "1eabfffeb153ffffb9feffffffffaaab",
        16,
    )
    while True:
        x = int.from_bytes(rng.integers(0, 256, 48, dtype=np.uint8).tobytes(), "big") % q
        rhs = (x * x * x + 4) % q
        y = pow(rhs, (q + 1) // 4, q)
        if (y * y) % q != rhs:
            continue
        out = bytearray(x.to_bytes(48, "big"))
        out[0] |= 0x80
        if (int(rng.integers(0, 2)) == 1) != (y > (q - 1) // 2):
            y = q - y
        if y > (q - 1) // 2:
            out[0] |= 0x20
        return bytes(out)


def make_synthetic_update_pair(
    committee_size: int = 8,
    seed: int = 0,
    rollover: bool = True,
    participation: int | None = None,
    valid_pubkeys: bool = False,
) -> SyntheticUpdate:
    """A consistent (cur, new) update pair at the given committee size.

    rollover=True puts the attested slot in the period after cur_slot's
    (the common mainnet case driven by main.rs); rollover=False keeps
    them in the same period.  valid_pubkeys=True draws the SIGNING
    committee's pubkeys from the actual curve (needed for
    --bls aggregate; slower: ~2 field exponentiations per key).
    """
    assert committee_size & (committee_size - 1) == 0
    rng = np.random.default_rng(seed)

    # --- committees -------------------------------------------------------
    if valid_pubkeys:
        signing_pubkeys = [make_valid_pubkey(rng) for _ in range(committee_size)]
    else:
        signing_pubkeys = [bytes(rng.integers(0, 256, 48, dtype=np.uint8)) for _ in range(committee_size)]
    signing_agg = bytes(rng.integers(0, 256, 48, dtype=np.uint8))
    c1 = ssz.sync_committee_root(signing_pubkeys, signing_agg)  # signing committee root

    next_pubkeys = [bytes(rng.integers(0, 256, 48, dtype=np.uint8)) for _ in range(committee_size)]
    next_agg = bytes(rng.integers(0, 256, 48, dtype=np.uint8))
    c2 = ssz.sync_committee_root(next_pubkeys, next_agg)  # next committee root

    # --- slots ------------------------------------------------------------
    period = 633
    cur_slot = period * SLOTS_PER_PERIOD + 96
    if rollover:
        attested_slot = (period + 1) * SLOTS_PER_PERIOD + 630
        finalized_slot = (period + 1) * SLOTS_PER_PERIOD + 96
    else:
        attested_slot = period * SLOTS_PER_PERIOD + 630
        finalized_slot = period * SLOTS_PER_PERIOD + 128

    # --- finalized header ---------------------------------------------------
    finalized_proposer_index = int(rng.integers(0, 1 << 20))
    finalized_parent_root = _rand32(rng)
    finalized_state_root = _rand32(rng)
    finalized_body_root = _rand32(rng)
    finalized_header_root = ssz.beacon_block_header_root(
        finalized_slot, finalized_proposer_index,
        finalized_parent_root, finalized_state_root, finalized_body_root,
    )

    # --- attested state tree (height 6, with committee overrides at depth 5)
    leaves = [_rand32(rng) for _ in range(64)]
    leaves[FINALIZED_HEADER_POS] = finalized_header_root
    depth5 = [ssz.hash_pair(leaves[i], leaves[i + 1]) for i in range(0, 64, 2)]
    depth5[CUR_COMMITTEE_POS] = c1
    depth5[NEXT_COMMITTEE_POS] = c2
    levels = [leaves, depth5]
    while len(levels[-1]) > 1:
        cur = levels[-1]
        levels.append([ssz.hash_pair(cur[i], cur[i + 1]) for i in range(0, len(cur), 2)])
    attested_state_root = levels[-1][0]

    finality_branch = _branch(levels, FINALIZED_HEADER_POS, 0)  # 6 siblings
    committee_branch = _branch(levels, NEXT_COMMITTEE_POS, 1)  # 5 siblings
    assert committee_branch[0] == c1

    # --- attested header + signing root ------------------------------------
    attested_proposer_index = int(rng.integers(0, 1 << 20))
    attested_parent_root = _rand32(rng)
    attested_body_root = _rand32(rng)
    attested_header_root = ssz.beacon_block_header_root(
        attested_slot, attested_proposer_index,
        attested_parent_root, attested_state_root, attested_body_root,
    )
    domain = compute_domain(DOMAIN_SYNC_COMMITTEE, fork_version_at_slot(attested_slot))
    signing_root = compute_signing_root(attested_header_root, domain)

    # --- committee roots as seen by the contract ----------------------------
    if rollover:
        cur_sync_committee_i = _rand32(rng)  # unused on the rollover path
        cur_sync_committee_ii = c1
    else:
        cur_sync_committee_i = c1
        cur_sync_committee_ii = _rand32(rng)
    new_sync_committee_i = committee_branch[0]  # node 22 == c1
    new_sync_committee_ii = c2

    # --- participation -------------------------------------------------------
    from ..models.lc_circuit import default_threshold

    threshold = default_threshold(committee_size)
    if participation is None:
        participation = committee_size
    bits = [1] * participation + [0] * (committee_size - participation)

    cur_header = _rand32(rng)
    cur_state = ssz.contract_state_root(cur_slot, cur_header, cur_sync_committee_i, cur_sync_committee_ii)
    new_state = ssz.contract_state_root(
        finalized_slot, finalized_header_root, new_sync_committee_i, new_sync_committee_ii
    )

    witness_kwargs = dict(
        signing_root=signing_root,
        domain=domain,
        attested_slot=attested_slot,
        attested_proposer_index=attested_proposer_index,
        attested_parent_root=attested_parent_root,
        attested_state_root=attested_state_root,
        attested_body_root=attested_body_root,
        finalized_slot=finalized_slot,
        finalized_proposer_index=finalized_proposer_index,
        finalized_parent_root=finalized_parent_root,
        finalized_state_root=finalized_state_root,
        finalized_body_root=finalized_body_root,
        finality_branch=finality_branch,
        cur_state=cur_state,
        new_state=new_state,
        cur_slot=cur_slot,
        cur_header=cur_header,
        cur_sync_committee_i=cur_sync_committee_i,
        cur_sync_committee_ii=cur_sync_committee_ii,
        new_sync_committee_i=new_sync_committee_i,
        new_sync_committee_ii=new_sync_committee_ii,
        sync_committee_bits=bits,
        new_sync_committee_ii_branch=committee_branch,
        sync_committee_pubkeys=signing_pubkeys,
        sync_committee_aggregate=signing_agg,
        signature=bytes(rng.integers(0, 256, 96, dtype=np.uint8)),
    )
    return SyntheticUpdate(
        witness_kwargs=witness_kwargs,
        cur_state=cur_state,
        new_state=new_state,
        committee_size=committee_size,
        threshold=threshold,
    )
