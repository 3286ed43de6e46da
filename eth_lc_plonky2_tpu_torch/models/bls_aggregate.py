"""In-circuit BLS12-381 aggregate-pubkey computation (the
`ec_aggregate_pk` half of upstream's BLS sub-prover).

Port of ``eth_lc_plonky2_tpu/models/bls_aggregate.py`` (host-only builder
code; the proofs run on the card unless ``device="cpu"`` is given).
Upstream proves, via `starky_bls12_381::aggregate_proof` (main.rs:172-176,
branch `feat/ec_aggregate_pk`), that the aggregate public key is the sum
of the committee pubkeys selected by the participation bits, plus
hash-to-curve and the pairing check.  This module rebuilds the
aggregation statement as an inner circuit of THIS proof system:

    agg = sum_{i: bits[i]=1} PK_i            (G1, affine)

with, per committee member:
  * prover-supplied affine coordinates (x_i, y_i), each < q,
  * x_i BOUND to the 48 compressed pubkey bytes (big-endian, 3 flag
    bits in byte 0 — compression=1, infinity=0, sign=bit 5),
  * y_i bound by the curve equation y^2 = x^3 + 4 and the sign flag
    (y > (q-1)/2 iff sign=1), which determines y uniquely,
  * bit-gated accumulation acc_{i+1} = select(bit_i, acc_i + PK_i,
    acc_i) with the division-free chord constraints of
    circuit/gadgets_bls12_381 (the x-unequal precondition is enforced
    by an inverse witness; starting from the offset point T = G1
    generator makes accidental x-collisions cryptographically
    negligible for honest inputs),
  * final unbinding agg + T == acc_N, exposing the prover-supplied
    aggregate as a constrained witness.

The circuit keeps the exact bound-value layout and 4-element Poseidon
PI-digest convention of models/bls.py (targets.rs:471-482), so the app
circuit absorbs it through the SAME recursion path as the dummy
stand-in — `--bls aggregate` is a drop-in upgrade of `--bls dummy`
that additionally proves the aggregation.  For large committees the
work can be split into `slices` independent inner circuits (each
aggregates a contiguous slice; each binds signing_root/signature plus
its slice of members, and appends [slice_index, num_slices] to the
hashed values when slices > 1 so a proof for slice j cannot be
replayed as slice k).  Hash-to-curve and the pairing remain pluggable
(models/bls.py artifacts path).
"""

from __future__ import annotations

from ..circuit import gadgets_bls12_381 as bls381
from ..circuit.builder import CircuitBuilder, CircuitData
from ..circuit.gates_poseidon import hash_no_pad_circuit
from ..prover.config import CircuitConfig, FriConfig
from ..prover import prove as pr
from .bls import (
    G1_PUBKEY_SIZE,
    SIGNATURE_SIZE,
    SIGNING_ROOT_SIZE,
)

Q = bls381.Q
HALF_Q = (Q - 1) // 2


# ---------------------------------------------------------------------------
# Host-side decompression (witness + test reference)
# ---------------------------------------------------------------------------


def decompress_g1(comp: bytes) -> tuple[int, int]:
    """48-byte compressed G1 -> affine (x, y); raises if not on curve.

    Zcash/BLS serialization: byte0 bit7 = compressed flag (must be 1),
    bit6 = infinity (must be 0 here), bit5 = sign (y lexicographically
    largest iff 1); remaining 381 bits are big-endian x.
    """
    assert len(comp) == G1_PUBKEY_SIZE
    b0 = comp[0]
    if not (b0 & 0x80):
        raise ValueError("not in compressed form")
    if b0 & 0x40:
        raise ValueError("point at infinity")
    sign = (b0 >> 5) & 1
    x = int.from_bytes(bytes([b0 & 0x1F]) + comp[1:], "big")
    if x >= Q:
        raise ValueError("x out of range")
    rhs = (x * x * x + 4) % Q
    y = pow(rhs, (Q + 1) // 4, Q)  # q = 3 (mod 4)
    if (y * y) % Q != rhs:
        raise ValueError("x is not on the curve")
    if (y > HALF_Q) != bool(sign):
        y = Q - y
    return x, y


def compress_g1(point: tuple[int, int]) -> bytes:
    x, y = point
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80
    if y > HALF_Q:
        out[0] |= 0x20
    return bytes(out)


def host_aggregate(pubkeys: list, bits: list) -> tuple[int, int] | None:
    """Reference aggregate: sum of decompressed pubkeys with bit=1
    (affine chord/tangent arithmetic); None if no bit set."""
    acc = None
    for pk, bit in zip(pubkeys, bits):
        if not int(bit):
            continue
        p = decompress_g1(bytes(pk))
        if acc is None:
            acc = p
        elif acc[0] == p[0]:
            acc = bls381.host_g1_double(p) if acc[1] == p[1] else None
        else:
            acc = bls381.host_g1_add(acc, p)
    return acc


# ---------------------------------------------------------------------------
# Circuit
# ---------------------------------------------------------------------------


def _bind_compressed_x(b: CircuitBuilder, pk_bytes: list, point):
    """Constrain point.x == the big-endian x encoded in the 48 pubkey
    byte wires, check the flag bits, and return the sign bit target.

    Byte-ness of the wires themselves comes from the app circuit's
    SHA-256/SSZ constraints on the same values through the digest
    binding (models/bls.py docstring) — the same trust split as the
    reference, where the BLS STARK consumes the committee bytes the
    plonky2 circuit hashes.
    """
    bits0 = b.split_le(pk_bytes[0], 8)
    one = b.one()
    b.connect(bits0[7], one)  # compressed flag
    b.assert_zero(bits0[6])  # not infinity
    sign = bits0[5]
    top5 = b.zero()
    for i in reversed(range(5)):
        top5 = b.arithmetic(2, 1, top5, one, bits0[i])  # top5 = 2*top5 + bit
    # little-endian u32 limbs from big-endian bytes: limb k covers
    # byte positions 47-4k .. 44-4k (weights 256^0..256^3)
    for k in range(11):
        acc = pk_bytes[47 - 4 * k]
        for j in range(1, 4):
            acc = b.arithmetic(1 << (8 * j), 1, pk_bytes[47 - 4 * k - j], one, acc)
        b.connect(acc, point.x[k])
    # top limb: bytes 3,2,1 + the masked 5 bits of byte 0
    acc = pk_bytes[3]
    acc = b.arithmetic(1 << 8, 1, pk_bytes[2], one, acc)
    acc = b.arithmetic(1 << 16, 1, pk_bytes[1], one, acc)
    acc = b.arithmetic(1 << 24, 1, top5, one, acc)
    b.connect(acc, point.x[11])
    return sign


def _bind_y_sign(b: CircuitBuilder, point, sign):
    """sign == (y > (q-1)/2): with y < q enforced, this pins y to one
    of the two curve roots."""
    from ..circuit import gadgets_biguint as bu

    half = bu.constant_biguint(b, HALF_Q, bls381.FQ_LIMBS)
    le = bu.cmp_biguint(b, point.y, half)  # y <= (q-1)/2
    b.assert_equal(b.not_(le), sign)


def _g1_select(b: CircuitBuilder, c, p_then, p_else):
    return bls381.G1AffineTarget(
        x=[b.select(c, t, e) for t, e in zip(p_then.x, p_else.x)],
        y=[b.select(c, t, e) for t, e in zip(p_then.y, p_else.y)],
    )


def _g1_const(b: CircuitBuilder, point: tuple[int, int]):
    from ..circuit import gadgets_biguint as bu

    return bls381.G1AffineTarget(
        x=bu.constant_biguint(b, point[0], bls381.FQ_LIMBS),
        y=bu.constant_biguint(b, point[1], bls381.FQ_LIMBS),
    )


def build_aggregate_bls_circuit(
    committee_size: int,
    fri: FriConfig | None = None,
    num_slices: int = 1,
    slice_size: int | None = None,
    num_wires: int | None = None,
) -> CircuitData:
    """Inner circuit: bound-value layout of models/bls.py for
    `slice_size` members (default: the whole committee), plus the
    aggregate-pubkey constraints over those members.

    committee_size is the FULL committee; with num_slices > 1 this
    circuit covers one contiguous slice and appends two extra WITNESS
    wires [slice_index, num_slices] to the hashed values — the outer
    circuit hashes its own CONSTANTS in those positions, so the digest
    equality pins the slice identity without baking it into the
    circuit.  Consequence: ONE build / preprocess / verifier key /
    compiled kernel set serves every slice; only the witness differs.
    The digest is over signing_root ++ signature ++ slice members
    (48 pubkey bytes + bit each) — for num_slices == 1 this is exactly
    the targets.rs:471-482 layout models/bls.py absorbs.
    """
    from ..circuit.gates_poseidon import NUM_WIRES_REQUIRED

    if slice_size is None:
        slice_size = committee_size
    assert slice_size * num_slices == committee_size

    cfg = CircuitConfig(
        # >= the Poseidon gate's wire needs; callers may pass the app
        # circuit's 184 so every slice shares the same kernel shapes
        num_wires=num_wires or NUM_WIRES_REQUIRED,
        fri=fri or FriConfig(proof_of_work_bits=8, num_query_rounds=12),
    )
    b = CircuitBuilder(cfg)
    signing_root = b.add_virtual_targets(SIGNING_ROOT_SIZE)
    signature = b.add_virtual_targets(SIGNATURE_SIZE)
    members = []
    for _ in range(slice_size):
        pk = b.add_virtual_targets(G1_PUBKEY_SIZE)
        bit = b.add_virtual_bool_target()
        members.append((pk, bit))

    # ---- aggregation constraints ----
    points = []
    acc = _g1_const(b, bls381.G1_GEN)  # offset point T
    for pk, bit in members:
        p = bls381.add_virtual_g1(b)
        sign = _bind_compressed_x(b, pk, p)
        _bind_y_sign(b, p, sign)
        bls381.assert_on_curve_g1(b, p)
        summed = bls381.g1_add_unequal(b, acc, p)
        acc = _g1_select(b, bit, summed, acc)
        points.append(p)
    # unbind: agg + T == acc_N  (agg prover-supplied, constrained)
    agg = bls381.add_virtual_g1(b)
    chained = bls381.g1_add_unequal(b, agg, _g1_const(b, bls381.G1_GEN))
    bls381.fq_assert_equal(b, chained.x, acc.x)
    bls381.fq_assert_equal(b, chained.y, acc.y)

    # ---- PI digest (same convention as models/bls.py) ----
    values = list(signing_root) + list(signature)
    for pk, bit in members:
        values.extend(pk)
        values.append(bit)
    slice_wires = None
    if num_slices > 1:
        slice_wires = (b.add_virtual_target(), b.add_virtual_target())
        values.extend(slice_wires)
    digest = hash_no_pad_circuit(b, values)
    b.register_public_inputs(digest)
    data = b.build()
    data._agg_inputs = (signing_root, signature, members, points, agg, slice_wires)  # type: ignore[attr-defined]
    data._agg_slice = (num_slices, slice_size)  # type: ignore[attr-defined]
    return data


def set_aggregate_witness(
    data: CircuitData,
    w,
    signing_root: bytes,
    signature: bytes,
    pubkeys: list,
    bits: list,
    slice_index: int = 0,
):
    """Fill the aggregate circuit's witness: bytes, bits, decompressed
    affine points, and the expected aggregate (host-computed)."""
    sr_t, sig_t, members, points, agg_t, slice_wires = data._agg_inputs  # type: ignore[attr-defined]
    num_slices, slice_size = data._agg_slice  # type: ignore[attr-defined]
    if slice_wires is not None:
        w.set(slice_wires[0], slice_index)
        w.set(slice_wires[1], num_slices)
    lo = slice_index * slice_size
    sl_pks = pubkeys[lo : lo + slice_size]
    sl_bits = bits[lo : lo + slice_size]
    for t, byte in zip(sr_t, signing_root):
        w.set(t, byte)
    for t, byte in zip(sig_t, signature):
        w.set(t, byte)
    for (pk_t, bit_t), pk, bit in zip(members, sl_pks, sl_bits):
        for t, byte in zip(pk_t, pk):
            w.set(t, byte)
        w.set(bit_t, int(bit))
    for p_t, pk in zip(points, sl_pks):
        x, y = decompress_g1(bytes(pk))
        bls381.set_g1(w, p_t, (x, y))
    agg = host_aggregate(sl_pks, sl_bits)
    assert agg is not None, "aggregate circuit needs at least one set bit per slice"
    bls381.set_g1(w, agg_t, agg)


def aggregate_witness(data: CircuitData, signing_root: bytes, signature: bytes,
                      pubkeys: list, bits: list, slice_index: int = 0):
    """The generated witness of one slice of the aggregate circuit."""
    w = data.new_witness()
    set_aggregate_witness(data, w, signing_root, signature, pubkeys, bits, slice_index)
    w.generate()
    return w


def prove_aggregate_bls(
    data: CircuitData,
    signing_root: bytes,
    signature: bytes,
    pubkeys: list,
    bits: list,
    slice_index: int = 0,
    pd=None,
    vk=None,
    device="cuda",
):
    """Prove the aggregate inner circuit on ``device`` (the card by
    default; ``"cpu"`` runs the plain versions); returns (proof,
    verifier_key, prover_data).

    Pass (pd, vk) from a previous call to reuse the preprocess across
    slices — every slice shares the circuit; ``device`` is then pd's."""
    if pd is None:
        pd, vk = pr.preprocess(data, device=device)
    w = aggregate_witness(data, signing_root, signature, pubkeys, bits, slice_index)
    proof = pr.prove(pd, w)
    return proof, vk, pd
