"""The Ethereum light-client update circuit (layer L6).

Copy of ``eth_lc_plonky2_tpu/models/lc_circuit.py`` (the port keeps its
own; host-only builder code).  It follows upstream's first-party circuit
(targets.rs): every subcircuit, its wiring, and its witness setter, built
on this package's gadget layer (batched SHA-256 segments, BigUint
gadgets, byte-order bridges).

Subcircuit map (reference lines in each docstring):
  SigningRoot          targets.rs:121-145
  BeaconBlockHeader    targets.rs:147-181
  FindSyncCommittee    targets.rs:184-235
  VerifySyncCommittee  targets.rs:237-302
  UpdateValidity       targets.rs:304-332
  ContractState        targets.rs:334-389
  SyncCommitteeSSZ     sync_committee_pubkeys.rs:15-87
  top-level composer   targets.rs:391-683
  witness setters      targets.rs:685-898

The BLS12-381 aggregate-signature sub-proof (reference layer L5,
`starky_bls12_381::aggregate_proof`) is a pluggable inner-proof
provider; its recursive absorption (targets.rs:468-482) is implemented
in models/bls.py (`absorb_bls_proof`, via circuit/recursion.py's
in-circuit verifier) and reachable from the CLI with `--bls dummy`.
The byte inputs it binds (signing_root_bytes, signature_bytes, pubkey
bytes) are allocated here with identical layout.
"""

from __future__ import annotations

import dataclasses

from ..circuit.builder import CircuitBuilder, Target
from ..circuit import gadgets_biguint as gb
from ..circuit import gadgets_merkle as gm
from ..circuit import gadgets_sha256 as gs

FINALIZED_HEADER_INDEX = 105
FINALIZED_HEADER_HEIGHT = 6
SYNC_COMMITTEE_HEIGHT = 5
SYNC_COMMITTEE_INDEX = 55
FINALITY_THRESHOLD = 342
N_SLOTS_PER_PERIOD = 8192
SYNC_COMMITTEE_SIZE = 512
G1_PUBKEY_SIZE = 48


def default_threshold(committee_size: int) -> int:
    """Participation threshold (participation must be STRICTLY greater).

    Mainnet: FINALITY_THRESHOLD = 342 (targets.rs:29).  Reduced
    synthetic committees use the same rule, ceil(2/3 * size).
    """
    if committee_size == SYNC_COMMITTEE_SIZE:
        return FINALITY_THRESHOLD
    return -(-2 * committee_size // 3)


# ---------------------------------------------------------------------------
# SigningRoot (targets.rs:121-145)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SigningRootTarget:
    signing_root: list
    header_root: list
    domain: list


def add_virtual_signing_root_target(b: CircuitBuilder) -> SigningRootTarget:
    header_root = gs.add_virtual_hash256(b)
    domain = gs.add_virtual_hash256(b)
    signing_root = gs.two_to_one_sha256(b, header_root, domain)
    return SigningRootTarget(signing_root=signing_root, header_root=header_root, domain=domain)


# ---------------------------------------------------------------------------
# BeaconBlockHeader (targets.rs:147-181)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BeaconBlockHeaderTarget:
    header_root: list
    slot: list
    proposer_index: list
    parent_root: list
    state_root: list
    body_root: list


def add_virtual_beacon_block_header_target(b: CircuitBuilder) -> BeaconBlockHeaderTarget:
    tree = gm.add_virtual_merkle_tree_sha256(b, 3)
    slot, proposer_index, parent_root, state_root, body_root = tree.leaves[:5]
    zero_h = gs.constant_hash256(b, b"\x00" * 32)
    for leaf in tree.leaves[5:]:
        gs.connect_hash256(b, leaf, zero_h)
    return BeaconBlockHeaderTarget(
        header_root=tree.root,
        slot=slot,
        proposer_index=proposer_index,
        parent_root=parent_root,
        state_root=state_root,
        body_root=body_root,
    )


# ---------------------------------------------------------------------------
# FindSyncCommittee (targets.rs:184-235)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FindSyncCommitteeTarget:
    cur_slot_big: list
    attested_slot_big: list
    cur_sync_committee_i: list
    cur_sync_committee_ii: list
    is_attested_from_next_period: Target
    sync_committee_for_attested_slot: list


def add_virtual_find_sync_committee_target(b: CircuitBuilder) -> FindSyncCommitteeTarget:
    attested_slot_big = gb.add_virtual_biguint_target(b, 8)
    cur_slot_big = gb.add_virtual_biguint_target(b, 8)
    cur_sync_committee_i = gs.add_virtual_hash256(b)
    cur_sync_committee_ii = gs.add_virtual_hash256(b)

    n_slot = gb.constant_biguint(b, N_SLOTS_PER_PERIOD, 1)
    one_big = gb.constant_biguint(b, 1, 1)
    attested_period, _ = gb.div_rem_biguint(b, attested_slot_big, n_slot)
    cur_period, _ = gb.div_rem_biguint(b, cur_slot_big, n_slot)
    next_period = gb.add_biguint(b, cur_period, one_big)

    is_cur = gb.is_equal_biguint(b, attested_period, cur_period)
    is_next = gb.is_equal_biguint(b, attested_period + [b.zero()], next_period)
    either = b.or_(is_cur, is_next)
    b.connect(either, b.one())

    # mux the committee root limb-wise: cur-period -> committee_i else _ii
    sync_committee_for_attested_slot = [
        b.select(is_cur, cur_sync_committee_i[i], cur_sync_committee_ii[i]) for i in range(8)
    ]
    return FindSyncCommitteeTarget(
        cur_slot_big=cur_slot_big,
        attested_slot_big=attested_slot_big,
        cur_sync_committee_i=cur_sync_committee_i,
        cur_sync_committee_ii=cur_sync_committee_ii,
        is_attested_from_next_period=is_next,
        sync_committee_for_attested_slot=sync_committee_for_attested_slot,
    )


# ---------------------------------------------------------------------------
# VerifySyncCommittee (targets.rs:237-302)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VerifySyncCommitteeTarget:
    is_attested_from_next_period: Target
    cur_sync_committee_i: list
    cur_sync_committee_ii: list
    new_sync_committee_i: list
    new_sync_committee_ii: list
    finalized_state_root: list
    new_sync_committee_ii_branch: list


def add_virtual_verify_sync_committee_target(b: CircuitBuilder) -> VerifySyncCommitteeTarget:
    is_next = b.add_virtual_bool_target()
    cur_i = gs.add_virtual_hash256(b)
    cur_ii = gs.add_virtual_hash256(b)
    new_i = gs.add_virtual_hash256(b)
    branch_target = gm.add_verify_merkle_proof(b, SYNC_COMMITTEE_INDEX, SYNC_COMMITTEE_HEIGHT)
    new_ii = branch_target.leaf
    finalized_state_root = branch_target.root

    # not next period  =>  new_i == cur_i   (mul-masked equality)
    not_next = b.not_(is_next)
    for i in range(8):
        a = b.mul(cur_i[i], not_next)
        c = b.mul(new_i[i], not_next)
        b.assert_equal(a, c)
    # next period  =>  new_i == cur_ii
    for i in range(8):
        a = b.mul(cur_ii[i], is_next)
        c = b.mul(new_i[i], is_next)
        b.assert_equal(a, c)

    return VerifySyncCommitteeTarget(
        is_attested_from_next_period=is_next,
        cur_sync_committee_i=cur_i,
        cur_sync_committee_ii=cur_ii,
        new_sync_committee_i=new_i,
        new_sync_committee_ii=new_ii,
        finalized_state_root=finalized_state_root,
        new_sync_committee_ii_branch=branch_target.proof,
    )


# ---------------------------------------------------------------------------
# UpdateValidity (targets.rs:304-332)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class UpdateValidityTarget:
    cur_slot_big: list
    finalized_slot_big: list
    participation_big: list


def add_virtual_update_validity_target(
    b: CircuitBuilder, threshold: int = FINALITY_THRESHOLD
) -> UpdateValidityTarget:
    cur_slot_big = gb.add_virtual_biguint_target(b, 8)
    finalized_slot_big = gb.add_virtual_biguint_target(b, 8)
    participation_big = gb.add_virtual_biguint_target(b, 1)

    # cur_slot <= finalized_slot
    le = gb.cmp_biguint(b, cur_slot_big, finalized_slot_big)
    b.connect(le, b.one())
    # NOT (participation <= threshold)
    threshold = gb.constant_biguint(b, threshold, 1)
    too_few = gb.cmp_biguint(b, participation_big, threshold)
    b.connect(too_few, b.zero())
    return UpdateValidityTarget(
        cur_slot_big=cur_slot_big,
        finalized_slot_big=finalized_slot_big,
        participation_big=participation_big,
    )


# ---------------------------------------------------------------------------
# ContractState (targets.rs:334-389)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ContractStateTarget:
    cur_state: list
    new_state: list
    cur_header: list
    cur_slot: list
    cur_sync_committee_i: list
    cur_sync_committee_ii: list
    new_header: list
    new_slot: list
    new_sync_committee_i: list
    new_sync_committee_ii: list


def add_virtual_contract_state_target(b: CircuitBuilder) -> ContractStateTarget:
    cur_tree = gm.add_virtual_merkle_tree_sha256(b, 2)
    new_tree = gm.add_virtual_merkle_tree_sha256(b, 2)
    return ContractStateTarget(
        cur_state=cur_tree.root,
        new_state=new_tree.root,
        cur_slot=cur_tree.leaves[0],
        cur_header=cur_tree.leaves[1],
        cur_sync_committee_i=cur_tree.leaves[2],
        cur_sync_committee_ii=cur_tree.leaves[3],
        new_slot=new_tree.leaves[0],
        new_header=new_tree.leaves[1],
        new_sync_committee_i=new_tree.leaves[2],
        new_sync_committee_ii=new_tree.leaves[3],
    )


# ---------------------------------------------------------------------------
# SyncCommittee SSZ (sync_committee_pubkeys.rs:15-87)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SyncCommitteeTarget:
    pubkeys: list  # size x 48 byte targets
    aggregate_pubkey: list  # 48 byte targets


def add_virtual_sync_committee_target(b: CircuitBuilder, size: int = SYNC_COMMITTEE_SIZE) -> SyncCommitteeTarget:
    pubkeys = [b.add_virtual_targets(G1_PUBKEY_SIZE) for _ in range(size)]
    aggregate_pubkey = b.add_virtual_targets(G1_PUBKEY_SIZE)
    return SyncCommitteeTarget(pubkeys=pubkeys, aggregate_pubkey=aggregate_pubkey)


def read_u32_be(b: CircuitBuilder, arr: list, index: int) -> Target:
    """Pack 4 byte targets (big-endian) into one u32 target
    (sync_committee_pubkeys.rs:31-45)."""
    acc = b.arithmetic(1 << 8, 1, arr[index + 2], b.one(), arr[index + 3])
    acc = b.arithmetic(1 << 16, 1, arr[index + 1], b.one(), acc)
    acc = b.arithmetic(1 << 24, 1, arr[index], b.one(), acc)
    return acc


def _pubkey_leaves(b: CircuitBuilder, pubkey_bytes: list) -> tuple[list, list]:
    """A 48-byte pubkey spans two 32-byte chunks (second half zero-padded)."""
    leaf0 = [read_u32_be(b, pubkey_bytes, 4 * i) for i in range(8)]
    zero = b.zero()
    leaf1 = [read_u32_be(b, pubkey_bytes, 32 + 4 * i) for i in range(4)] + [zero] * 4
    return leaf0, leaf1


def ssz_sync_committee(b: CircuitBuilder, sc: SyncCommitteeTarget) -> list:
    """SSZ hash_tree_root(SyncCommittee) — pubkey tree of 2 chunks per key,
    aggregate tree, and the 2-field container root."""
    size = len(sc.pubkeys)
    chunks = []
    for pk in sc.pubkeys:
        l0, l1 = _pubkey_leaves(b, pk)
        chunks.append(l0)
        chunks.append(l1)
    layer = chunks
    while len(layer) > 1:
        pairs = [(layer[i], layer[i + 1]) for i in range(0, len(layer), 2)]
        layer = gs.two_to_one_sha256_batch(b, pairs)
    pubkeys_root = layer[0]
    agg0, agg1 = _pubkey_leaves(b, sc.aggregate_pubkey)
    agg_root = gs.two_to_one_sha256(b, agg0, agg1)
    return gs.two_to_one_sha256(b, pubkeys_root, agg_root)


# ---------------------------------------------------------------------------
# Top-level composer (targets.rs:391-683)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ProofTarget:
    signing_root_bytes: list
    attested_header_root: list
    domain: list
    attested_slot: list
    attested_proposer_index: list
    attested_parent_root: list
    attested_state_root: list
    attested_body_root: list
    finalized_header_root: list
    finality_branch: list
    finalized_slot: list
    finalized_proposer_index: list
    finalized_parent_root: list
    finalized_state_root: list
    finalized_body_root: list
    cur_state: list
    cur_slot: list
    cur_header: list
    cur_sync_committee_i: list
    cur_sync_committee_ii: list
    new_state: list
    new_sync_committee_i: list
    new_sync_committee_ii: list
    sync_committee_bits: list
    cur_slot_big: list
    attested_slot_big: list
    new_sync_committee_ii_branch: list
    finalized_slot_big: list
    sync_committee: SyncCommitteeTarget
    signature_bytes: list


def add_virtual_proof_target(
    b: CircuitBuilder,
    committee_size: int = SYNC_COMMITTEE_SIZE,
    threshold: int | None = None,
) -> ProofTarget:
    """The whole light-client update circuit (minus the BLS recursive
    absorption, which plugs into signing_root_bytes / signature_bytes /
    pubkey bytes when the recursion layer is enabled).

    `threshold` defaults to default_threshold(committee_size): the
    mainnet FINALITY_THRESHOLD (342, targets.rs:29) at
    committee_size=512 and ceil(2/3 * size) for reduced synthetic
    committees."""
    if threshold is None:
        threshold = default_threshold(committee_size)
    signing_root_bytes = b.add_virtual_targets(32)
    signing_root = [read_u32_be(b, signing_root_bytes, 4 * i) for i in range(8)]
    domain = gs.add_virtual_hash256(b)

    attested_slot = gs.add_virtual_hash256(b)
    attested_slot_big = gb.add_virtual_biguint_target(b, 8)
    finalized_slot_big = gb.add_virtual_biguint_target(b, 8)
    cur_state = gs.add_virtual_hash256(b)
    cur_slot = gs.add_virtual_hash256(b)
    cur_slot_big = gb.add_virtual_biguint_target(b, 8)
    cur_header = gs.add_virtual_hash256(b)
    cur_sync_committee_i = gs.add_virtual_hash256(b)
    cur_sync_committee_ii = gs.add_virtual_hash256(b)
    new_state = gs.add_virtual_hash256(b)
    new_sync_committee_i = gs.add_virtual_hash256(b)
    new_sync_committee_ii = gs.add_virtual_hash256(b)

    sync_committee = add_virtual_sync_committee_target(b, committee_size)
    sync_committee_ssz = ssz_sync_committee(b, sync_committee)

    sync_committee_bits = [b.add_virtual_bool_target() for _ in range(committee_size)]
    signature_bytes = b.add_virtual_targets(96)
    participation = b.add_many(sync_committee_bits)

    # subcircuits
    signing_root_t = add_virtual_signing_root_target(b)
    attested_header_t = add_virtual_beacon_block_header_target(b)
    finalized_header_t = add_virtual_beacon_block_header_target(b)
    finality_branch_t = gm.add_verify_merkle_proof(b, FINALIZED_HEADER_INDEX, FINALIZED_HEADER_HEIGHT)
    contract_state_t = add_virtual_contract_state_target(b)
    find_sc_t = add_virtual_find_sync_committee_target(b)
    verify_sc_t = add_virtual_verify_sync_committee_target(b)
    update_validity_t = add_virtual_update_validity_target(b, threshold)

    # *** signing root ***
    gs.connect_hash256(b, signing_root_t.signing_root, signing_root)
    gs.connect_hash256(b, signing_root_t.header_root, attested_header_t.header_root)
    gs.connect_hash256(b, signing_root_t.domain, domain)

    # *** attested block header ***
    gs.connect_hash256(b, attested_header_t.slot, attested_slot)

    # *** finality branch: finalized header root proven against attested state root ***
    gs.connect_hash256(b, finality_branch_t.leaf, finalized_header_t.header_root)
    gs.connect_hash256(b, finality_branch_t.root, attested_header_t.state_root)

    # *** sync committee lookup ***
    gb.connect_biguint(b, find_sc_t.cur_slot_big, cur_slot_big)
    gb.connect_biguint(b, find_sc_t.attested_slot_big, attested_slot_big)
    gs.connect_hash256(b, find_sc_t.cur_sync_committee_i, cur_sync_committee_i)
    gs.connect_hash256(b, find_sc_t.cur_sync_committee_ii, cur_sync_committee_ii)
    gs.connect_hash256(b, find_sc_t.sync_committee_for_attested_slot, sync_committee_ssz)

    # *** update sync committee ***
    b.connect(find_sc_t.is_attested_from_next_period, verify_sc_t.is_attested_from_next_period)
    gs.connect_hash256(b, verify_sc_t.cur_sync_committee_i, cur_sync_committee_i)
    gs.connect_hash256(b, verify_sc_t.cur_sync_committee_ii, cur_sync_committee_ii)
    gs.connect_hash256(b, verify_sc_t.new_sync_committee_i, new_sync_committee_i)
    gs.connect_hash256(b, verify_sc_t.new_sync_committee_ii, new_sync_committee_ii)
    # NOTE: the reference wires this "finalized_state_root" to the
    # ATTESTED state root (targets.rs:577-580)
    gs.connect_hash256(b, verify_sc_t.finalized_state_root, attested_header_t.state_root)

    # *** update validity ***
    gb.connect_biguint(b, update_validity_t.cur_slot_big, cur_slot_big)
    gb.connect_biguint(b, update_validity_t.finalized_slot_big, finalized_slot_big)
    b.connect(update_validity_t.participation_big[0], participation)

    # *** contract state ***
    gs.connect_hash256(b, contract_state_t.cur_state, cur_state)
    gs.connect_hash256(b, contract_state_t.new_state, new_state)
    gs.connect_hash256(b, contract_state_t.cur_header, cur_header)
    gs.connect_hash256(b, contract_state_t.cur_slot, cur_slot)
    gs.connect_hash256(b, contract_state_t.cur_sync_committee_i, cur_sync_committee_i)
    gs.connect_hash256(b, contract_state_t.cur_sync_committee_ii, cur_sync_committee_ii)
    gs.connect_hash256(b, contract_state_t.new_header, finalized_header_t.header_root)
    gs.connect_hash256(b, contract_state_t.new_slot, finalized_header_t.slot)
    gs.connect_hash256(b, contract_state_t.new_sync_committee_i, new_sync_committee_i)
    gs.connect_hash256(b, contract_state_t.new_sync_committee_ii, new_sync_committee_ii)

    # *** slot value <-> SSZ-leaf byte-order bridges ***
    gb.biguint_hash256_connect(b, cur_slot_big, cur_slot)
    gb.biguint_hash256_connect(b, attested_slot_big, attested_slot)
    gb.biguint_hash256_connect(b, finalized_slot_big, finalized_header_t.slot)

    return ProofTarget(
        signing_root_bytes=signing_root_bytes,
        attested_header_root=attested_header_t.header_root,
        domain=domain,
        attested_slot=attested_slot,
        attested_proposer_index=attested_header_t.proposer_index,
        attested_parent_root=attested_header_t.parent_root,
        attested_state_root=attested_header_t.state_root,
        attested_body_root=attested_header_t.body_root,
        finalized_header_root=finalized_header_t.header_root,
        finality_branch=finality_branch_t.proof,
        finalized_slot=finalized_header_t.slot,
        finalized_proposer_index=finalized_header_t.proposer_index,
        finalized_parent_root=finalized_header_t.parent_root,
        finalized_state_root=finalized_header_t.state_root,
        finalized_body_root=finalized_header_t.body_root,
        cur_state=cur_state,
        cur_slot=cur_slot,
        cur_header=cur_header,
        cur_sync_committee_i=cur_sync_committee_i,
        cur_sync_committee_ii=cur_sync_committee_ii,
        new_state=new_state,
        new_sync_committee_i=new_sync_committee_i,
        new_sync_committee_ii=new_sync_committee_ii,
        sync_committee_bits=sync_committee_bits,
        cur_slot_big=cur_slot_big,
        attested_slot_big=attested_slot_big,
        new_sync_committee_ii_branch=verify_sc_t.new_sync_committee_ii_branch,
        finalized_slot_big=finalized_slot_big,
        sync_committee=sync_committee,
        signature_bytes=signature_bytes,
    )


# ---------------------------------------------------------------------------
# Witness setters (targets.rs:685-898)
# ---------------------------------------------------------------------------


def _set_u64_leaf(w, h256, value: int):
    """u64 slot little-endian packed into a 32-byte leaf (targets.rs:819-821)."""
    leaf = int(value).to_bytes(8, "little") + b"\x00" * 24
    gs.set_hash256(w, h256, leaf)


def set_proof_target(
    w,
    t: ProofTarget,
    *,
    signing_root: bytes,
    domain: bytes,
    attested_slot: int,
    attested_proposer_index: int,
    attested_parent_root: bytes,
    attested_state_root: bytes,
    attested_body_root: bytes,
    finalized_slot: int,
    finalized_proposer_index: int,
    finalized_parent_root: bytes,
    finalized_state_root: bytes,
    finalized_body_root: bytes,
    finality_branch: list,
    cur_state: bytes,
    new_state: bytes,
    cur_slot: int,
    cur_header: bytes,
    cur_sync_committee_i: bytes,
    cur_sync_committee_ii: bytes,
    new_sync_committee_i: bytes,
    new_sync_committee_ii: bytes,
    sync_committee_bits: list,
    new_sync_committee_ii_branch: list,
    sync_committee_pubkeys: list,
    sync_committee_aggregate: bytes,
    signature: bytes,
):
    for i, byte in enumerate(signing_root):
        w.set(t.signing_root_bytes[i], byte)
    gs.set_hash256(w, t.domain, domain)
    _set_u64_leaf(w, t.attested_slot, attested_slot)
    _set_u64_leaf(w, t.attested_proposer_index, attested_proposer_index)
    gs.set_hash256(w, t.attested_parent_root, attested_parent_root)
    gs.set_hash256(w, t.attested_state_root, attested_state_root)
    gs.set_hash256(w, t.attested_body_root, attested_body_root)
    _set_u64_leaf(w, t.finalized_slot, finalized_slot)
    _set_u64_leaf(w, t.finalized_proposer_index, finalized_proposer_index)
    gs.set_hash256(w, t.finalized_parent_root, finalized_parent_root)
    gs.set_hash256(w, t.finalized_state_root, finalized_state_root)
    gs.set_hash256(w, t.finalized_body_root, finalized_body_root)
    for sib_t, sib in zip(t.finality_branch, finality_branch):
        gs.set_hash256(w, sib_t, sib)
    gs.set_hash256(w, t.cur_state, cur_state)
    gs.set_hash256(w, t.new_state, new_state)
    _set_u64_leaf(w, t.cur_slot, cur_slot)
    gs.set_hash256(w, t.cur_header, cur_header)
    gs.set_hash256(w, t.cur_sync_committee_i, cur_sync_committee_i)
    gs.set_hash256(w, t.cur_sync_committee_ii, cur_sync_committee_ii)
    gs.set_hash256(w, t.new_sync_committee_i, new_sync_committee_i)
    gs.set_hash256(w, t.new_sync_committee_ii, new_sync_committee_ii)
    for bt, bit in zip(t.sync_committee_bits, sync_committee_bits):
        w.set(bt, int(bit))
    gb.set_biguint_target(w, t.cur_slot_big, cur_slot)
    gb.set_biguint_target(w, t.attested_slot_big, attested_slot)
    gb.set_biguint_target(w, t.finalized_slot_big, finalized_slot)
    for sib_t, sib in zip(t.new_sync_committee_ii_branch, new_sync_committee_ii_branch):
        gs.set_hash256(w, sib_t, sib)
    for pk_t, pk in zip(t.sync_committee.pubkeys, sync_committee_pubkeys):
        for bt, byte in zip(pk_t, pk):
            w.set(bt, byte)
    for bt, byte in zip(t.sync_committee.aggregate_pubkey, sync_committee_aggregate):
        w.set(bt, byte)
    for bt, byte in zip(t.signature_bytes, signature):
        w.set(bt, byte)
