"""BLS sub-proof absorption (L5 boundary + the recursion call site).

Port of ``eth_lc_plonky2_tpu/models/bls.py`` (the dummy inner circuit, its
proof on the card, the absorption of one or several sliced inner proofs and
the file artifacts; the in-circuit aggregate inner circuit, which keeps this
module's layout and digest, is ``models/bls_aggregate.py``).

Upstream verifies a starky_bls12_381 recursive proof inside the app
circuit and binds its public inputs to the committee inputs
(targets.rs:468-482), with bound
value layout `[0..32)=signing_root bytes, [32..128)=signature bytes,
then committee_size x (48 pubkey bytes + 1 participation bit)` —
25,216 values at mainnet size 512.

PI hashing: binding 25,216 values as LITERAL public inputs blows up
both sides (the inner prover's quotient kernel carries one Lagrange
term per PI; the outer in-circuit verifier pays an ext inversion per
PI), so — like plonky2 itself, which hashes every circuit's public
inputs to a 4-element Poseidon digest before they touch the constraint
system — the inner circuit here hashes the bound values in-circuit
(`hash_no_pad`, rate 8: 3,152 Poseidon rows at size 512) and registers
only the 4-element digest as its public inputs.  The outer circuit
hashes its OWN copies of the bound wires with the same in-circuit
sponge and connects the two digests, which binds every value
index-for-index through a collision-resistant channel.

The BLS prover itself is pluggable (its artifacts may be produced
offline and loaded from files, as upstream's README documents);
this module provides

  * `absorb_bls_proof`     — the in-circuit verification + digest
                             binding into the app circuit,
  * `build_dummy_bls_circuit` / `prove_dummy_bls` — a stand-in inner
                             circuit with the exact bound-value layout
                             and digest convention, used until a real
                             BLS STARK artifact is supplied (same
                             affordance the reference documents).
"""

from __future__ import annotations

from ..circuit import recursion as rec
from ..circuit.builder import CircuitBuilder, CircuitData
from ..circuit.gates_poseidon import hash_no_pad_circuit
from ..prover.config import CircuitConfig, FriConfig
from ..prover import prove as pr

G1_PUBKEY_SIZE = 48
SIGNATURE_SIZE = 96
SIGNING_ROOT_SIZE = 32
DIGEST_LEN = 4  # Poseidon digest elements = the inner circuit's PIs


def num_bls_bound_values(committee_size: int) -> int:
    """32 + 96 + size*(48+1); 25,216 at size 512 (targets.rs:471-482).

    These are the values BOUND between the inner proof and the app
    circuit; the inner circuit's registered public inputs are the
    4-element Poseidon digest of them (see module docstring)."""
    return SIGNING_ROOT_SIZE + SIGNATURE_SIZE + committee_size * (G1_PUBKEY_SIZE + 1)


def bound_value_targets(t, slice_index: int = 0, num_slices: int = 1) -> list:
    """The app-circuit wires bound to the inner proof, in the canonical
    targets.rs:471-482 order (the exact order both sides hash).

    With num_slices > 1 (sliced aggregate sub-proofs,
    models/bls_aggregate), the member range is the contiguous slice
    [slice_index * size/num_slices, ...); signing root and signature
    are bound by every slice."""
    size = len(t.sync_committee.pubkeys)
    assert size % num_slices == 0
    per = size // num_slices
    lo = slice_index * per
    out = list(t.signing_root_bytes) + list(t.signature_bytes)
    for pk, bit in zip(
        t.sync_committee.pubkeys[lo : lo + per], t.sync_committee_bits[lo : lo + per]
    ):
        out.extend(pk)
        out.append(bit)
    return out


# ---------------------------------------------------------------------------
# In-circuit absorption (targets.rs:468-482)
# ---------------------------------------------------------------------------


def absorb_bls_proof(b: CircuitBuilder, t, bls_data: CircuitData, pin_vk=None,
                     slice_index: int = 0, num_slices: int = 1):
    """Verify a BLS inner proof in-circuit and bind its values.

    `t` is the app-circuit ProofTarget (models.lc_circuit).  Mirrors
    targets.rs:468-482 through the PI-hash channel: the outer circuit
    Poseidon-hashes its own signing_root_bytes / signature_bytes /
    pubkey bytes / participation bits (canonical order,
    `bound_value_targets`) and connects the digest to the inner
    proof's 4 public inputs — which the inner circuit constrains to be
    the same hash of ITS values, so every value is bound
    index-for-index.

    `pin_vk`: the expected inner VerifierKey.  When given, the verifier
    data (the preprocessed-commitment cap) is pinned to circuit
    CONSTANTS of that key, so a prover cannot substitute a different
    same-shape inner circuit's vk/proof pair.  The reference leaves the
    verifier data as a plain witness (targets.rs:469) and relies on the
    operator passing the right artifacts; pin the vk whenever the inner
    circuit is known at build time (the CLI's --bls dummy path does).
    Without pinning, the absorption only attests "some proof of some
    circuit with this digest convention verifies" — fine for the
    dummy, a soundness hole for a real BLS artifact.

    Returns (proof_target, verifier_data_target) for the witness side
    (set via set_bls_proof_target, the counterpart of
    targets.rs:896-897).
    """
    pt = rec.add_virtual_proof_with_pis(b, bls_data)
    vd = rec.add_virtual_verifier_data(b, bls_data)
    if pin_vk is not None:
        for d_t, d_v in zip(vd.pre_cap, pin_vk.pre_cap):
            for wire, val in zip(d_t, d_v):
                b.connect(wire, b.constant(int(val)))
    rec.verify_proof_circuit(b, pt, vd, bls_data)

    assert len(pt.public_inputs) == DIGEST_LEN, (
        f"inner proof has {len(pt.public_inputs)} public inputs; expected "
        f"the {DIGEST_LEN}-element bound-value digest (see models.bls)"
    )
    bound = bound_value_targets(t, slice_index, num_slices)
    assert len(bound) == num_bls_bound_values(
        len(t.sync_committee.pubkeys) // num_slices
    )
    if num_slices > 1:
        # pin the slice identity so a proof for slice j cannot stand
        # in for slice k (models/bls_aggregate hashes the same pair)
        bound.append(b.constant(slice_index))
        bound.append(b.constant(num_slices))
    digest = hash_no_pad_circuit(b, bound)
    for d, p in zip(digest, pt.public_inputs):
        b.connect(d, p)
    return pt, vd


def absorb_bls_proofs(b: CircuitBuilder, t, datas: list, pin_vks: list | None = None):
    """Absorb `len(datas)` sliced inner proofs (slice i covers the
    i-th contiguous block of committee members).  Returns the list of
    (proof_target, verifier_data_target) pairs, one per slice."""
    n = len(datas)
    pin_vks = pin_vks or [None] * n
    return [
        absorb_bls_proof(b, t, data, pin_vk=vk, slice_index=i, num_slices=n)
        for i, (data, vk) in enumerate(zip(datas, pin_vks))
    ]


def set_bls_proof_target(w, pt, vd, proof, vk):
    """Witness half (targets.rs:896-897)."""
    rec.set_proof_with_pis_target(w, pt, proof)
    rec.set_verifier_data_target(w, vd, vk)


# ---------------------------------------------------------------------------
# Dummy inner circuit (stand-in for the BLS STARK wrapper)
# ---------------------------------------------------------------------------


def build_dummy_bls_circuit(
    committee_size: int, fri: FriConfig | None = None
) -> CircuitData:
    """An inner circuit with the exact 32+96+size*49 bound-value layout
    and the 4-element PI-digest convention (module docstring).

    Bits are constrained boolean (as the real wrapper's would be);
    byte inputs are free wires — their integrity comes from the app
    circuit's own SHA-256/SSZ constraints on the same values, exactly
    as in the reference, where the BLS proof attests the *signature
    check* while the app circuit attests the committee structure.
    """
    from ..circuit.gates_poseidon import NUM_WIRES_REQUIRED

    cfg = CircuitConfig(
        num_wires=NUM_WIRES_REQUIRED,  # in-circuit Poseidon for the PI digest
        fri=fri or FriConfig(proof_of_work_bits=8, num_query_rounds=12),
    )
    b = CircuitBuilder(cfg)
    signing_root = b.add_virtual_targets(SIGNING_ROOT_SIZE)
    signature = b.add_virtual_targets(SIGNATURE_SIZE)
    members = []
    for _ in range(committee_size):
        pk = b.add_virtual_targets(G1_PUBKEY_SIZE)
        bit = b.add_virtual_bool_target()
        members.append((pk, bit))
    values = list(signing_root) + list(signature)
    for pk, bit in members:
        values.extend(pk)
        values.append(bit)
    digest = hash_no_pad_circuit(b, values)
    b.register_public_inputs(digest)
    data = b.build()
    data._dummy_bls_inputs = (signing_root, signature, members)  # type: ignore[attr-defined]
    return data


def dummy_bls_witness(data: CircuitData, signing_root: bytes, signature: bytes,
                      pubkeys: list, bits: list):
    """The generated witness of the dummy inner circuit for these values."""
    sr_t, sig_t, members = data._dummy_bls_inputs  # type: ignore[attr-defined]
    w = data.new_witness()
    for t, byte in zip(sr_t, signing_root):
        w.set(t, byte)
    for t, byte in zip(sig_t, signature):
        w.set(t, byte)
    for (pk_t, bit_t), pk, bit in zip(members, pubkeys, bits):
        for t, byte in zip(pk_t, pk):
            w.set(t, byte)
        w.set(bit_t, int(bit))
    w.generate()
    return w


def prove_dummy_bls(
    data: CircuitData,
    signing_root: bytes,
    signature: bytes,
    pubkeys: list,
    bits: list,
    device="cuda",
):
    """Prove the dummy inner circuit for the given witness values, on
    ``device`` (the card by default; ``"cpu"`` runs the plain versions).

    Returns (proof, verifier_key)."""
    pd, vk = pr.preprocess(data, device=device)
    proof = pr.prove(pd, dummy_bls_witness(data, signing_root, signature, pubkeys, bits))
    return proof, vk


# ---------------------------------------------------------------------------
# File-based inner-proof artifacts
# ---------------------------------------------------------------------------
#
# Upstream documents that the BLS artifacts (plonky2_proof,
# verifier_data, common_data) may be produced offline by another
# process and loaded from files (its README).  The
# equivalents here are ALL non-executable (nothing is unpickled):
#   circuit.json  the inner circuit's common data — config, gate specs,
#                 public-input rows, k_shifts (the shape the in-circuit
#                 verifier needs; prover.serialize.common_data_to_dict)
#   proof.json    the inner proof, hex-string JSON (same encoding as
#                 docs/proof_format.md §7)
#   vk.json       the inner verifier key (pre_cap digests)


def save_bls_artifacts(dirpath: str, data: CircuitData, proof, vk) -> None:
    import json
    import os

    from ..prover import serialize as ser

    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "circuit.json"), "w") as f:
        json.dump(ser.common_data_to_dict(data), f)
    with open(os.path.join(dirpath, "proof.json"), "w") as f:
        json.dump(ser.proof_to_dict(proof, include_indices=True), f)
    with open(os.path.join(dirpath, "vk.json"), "w") as f:
        json.dump({"pre_cap": [[hex(int(v)) for v in row] for row in vk.pre_cap]}, f)


def load_bls_artifacts(dirpath: str):
    """Returns (CircuitData, proof, VerifierKey); the caller absorbs via
    absorb_bls_proof(..., pin_vk=vk) + set_bls_proof_target.

    All three files are plain JSON — loading executes no artifact
    code.  The returned CircuitData is shape-only (no tables or
    witness generators), which is exactly what in-circuit verification
    of an offline-produced proof requires."""
    import json
    import os

    import numpy as np

    from ..prover import serialize as ser
    from ..prover.prove import VerifierKey

    with open(os.path.join(dirpath, "circuit.json")) as f:
        data = ser.common_data_from_dict(json.load(f))
    with open(os.path.join(dirpath, "proof.json")) as f:
        proof = ser.proof_from_dict(json.load(f))
    with open(os.path.join(dirpath, "vk.json")) as f:
        cap = json.load(f)["pre_cap"]
    vk = VerifierKey(
        pre_cap=np.array([[int(v, 16) for v in row] for row in cap], dtype=np.uint64)
    )
    return data, proof, vk
