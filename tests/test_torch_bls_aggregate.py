"""The port's in-circuit BLS12-381 aggregate (``circuit/gadgets_bls12_381.py``,
``models/bls_aggregate.py``) against the JAX package's, exactly: one script
builds each circuit in both packages, and the tables, the generated witnesses
and the values read from them must be equal.

- The Fq and G1 gadgets on seeded values, against the host references.
- The host decompression, compression and aggregate, with the cases of the
  JAX package's own tests (its vectors, partial participation, the negatives
  of a wrong aggregate and a flipped sign) held in both packages.
- The aggregate inner circuit at 2 members (8,946 rows on 2^14), and at 4
  members in 2 slices: each slice's witness, its digest (the inner circuit's
  4 public inputs), and the digest's binding of the slice identity and the
  participation bits to the hash the outer circuit takes of its own values
  (``models/bls.py:absorb_bls_proof``).  The outer circuit absorbing both
  slices has the JAX package's tables.

Two ``heavy`` tests, run with ``-m heavy``: the port's CPU proof of the
2-member aggregate circuit byte for byte against the JAX package's, and
``cli.run`` at committee 4 with ``aggregate:slices=2`` on the CPU, checked by
the port's verifier and ``tools/verify_standalone.py``.  The plain versions
take minutes of one CPU core for a proof at 2^14 rows."""

import importlib.util
import io
import json
import os
import types

import numpy as np
import pytest
import torch

import torch_circuits
from eth_lc_plonky2_tpu.circuit import gadgets_bls12_381 as jg1
from eth_lc_plonky2_tpu.models import bls_aggregate as jagg
from eth_lc_plonky2_tpu_torch import cli, convert
from eth_lc_plonky2_tpu_torch.circuit import gadgets_bls12_381 as g1
from eth_lc_plonky2_tpu_torch.models import bls_aggregate as agg
from eth_lc_plonky2_tpu_torch.ops import poseidon as pos
from torch_circuits import cfg, same_circuit, same_witness, violations

# each package's modules, with its BLS12-381 gadgets and aggregate circuit
JAX = types.SimpleNamespace(**vars(torch_circuits.JAX), g1=jg1, agg=jagg)
PORT = types.SimpleNamespace(**vars(torch_circuits.PORT), g1=g1, agg=agg)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGNING_ROOT = bytes(range(32))
SIGNATURE = bytes(range(96))
Q = PORT.g1.Q


def _fri(pkg):
    return pkg.config.FriConfig(proof_of_work_bits=4, num_query_rounds=4)


def _pubkeys(count: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [PORT.syn.make_valid_pubkey(rng) for _ in range(count)]


def _fq(rng) -> int:
    return int.from_bytes(rng.integers(0, 256, 48, dtype=np.uint8).tobytes(), "big") % Q


# ---------------------------------------------------------------------------
# Fq and G1 gadgets
# ---------------------------------------------------------------------------


def _gadget_circuit(pkg):
    g1 = pkg.g1
    b = pkg.builder.CircuitBuilder(cfg(pkg))
    x, y = g1.add_virtual_fq(b), g1.add_virtual_fq(b)
    fq = {"add": g1.fq_add(b, x, y), "sub": g1.fq_sub(b, x, y), "mul": g1.fq_mul(b, x, y),
          "mul_const": g1.fq_mul_const(b, x, 7), "reduce": g1.fq_reduce(b, x + y)}
    p1, p2 = g1.add_virtual_g1(b), g1.add_virtual_g1(b)
    g1.assert_on_curve_g1(b, p1)
    g1.assert_on_curve_g1(b, p2)
    points = {"add": g1.g1_add_unequal(b, p1, p2), "double": g1.g1_double(b, p1)}
    return b.build(), (x, y, p1, p2, fq, points)


@pytest.fixture(scope="module")
def gadgets():
    return {pkg.port: _gadget_circuit(pkg) for pkg in (PORT, JAX)}


def test_gadget_circuit_equals_the_jax_packages(gadgets):
    same_circuit(gadgets[True][0], gadgets[False][0])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fq_and_g1_gadgets_equal_host_and_jax(gadgets, seed):
    rng = np.random.default_rng(seed)
    xv, yv = _fq(rng), _fq(rng)
    pt1, pt2 = (PORT.agg.decompress_g1(pk) for pk in _pubkeys(2, seed))
    want_fq = {"add": (xv + yv) % Q, "sub": (xv - yv) % Q, "mul": xv * yv % Q,
               "mul_const": 7 * xv % Q, "reduce": (xv + (yv << (32 * 12))) % Q}
    want_points = {"add": PORT.g1.host_g1_add(pt1, pt2), "double": PORT.g1.host_g1_double(pt1)}
    ws = {}
    for pkg in (PORT, JAX):
        data, (x, y, p1, p2, fq, points) = gadgets[pkg.port]
        w = data.new_witness()
        pkg.g1.set_fq(w, x, xv)
        pkg.g1.set_fq(w, y, yv)
        pkg.g1.set_g1(w, p1, pt1)
        pkg.g1.set_g1(w, p2, pt2)
        w.generate()
        assert {k: pkg.g1.fq_value(w, t) for k, t in fq.items()} == want_fq
        assert {k: (pkg.g1.fq_value(w, p.x), pkg.g1.fq_value(w, p.y))
                for k, p in points.items()} == want_points
        assert violations(pkg, data, w) == []
        ws[pkg.port] = w
    same_witness(ws[True], ws[False])
    # the JAX package's host references are the port's
    assert JAX.g1.host_g1_add(pt1, pt2) == want_points["add"]
    assert JAX.g1.host_g1_double(pt1) == want_points["double"]


def test_a_wrong_g1_sum_is_rejected_by_both_packages(gadgets):
    """An output of the chord rule pinned to another point conflicts."""
    pt1, pt2 = (PORT.agg.decompress_g1(pk) for pk in _pubkeys(2, 5))
    for pkg in (PORT, JAX):
        data, (_, _, p1, p2, _, points) = gadgets[pkg.port]
        w = data.new_witness()
        pkg.g1.set_g1(w, p1, pt1)
        pkg.g1.set_g1(w, p2, pt2)
        pkg.g1.set_fq(w, points["add"].x, pt1[0])
        with pytest.raises(ValueError, match="conflicting"):
            w.generate()


# ---------------------------------------------------------------------------
# Host references
# ---------------------------------------------------------------------------


def test_decompression_vectors_hold_in_both_packages():
    keys = _pubkeys(8, 42)
    for pkg in (PORT, JAX):
        for pk in keys:
            x, y = pkg.agg.decompress_g1(pk)
            assert (y * y - (x * x * x + 4)) % Q == 0
            assert pkg.agg.compress_g1((x, y)) == pk
        assert pkg.agg.decompress_g1(pkg.agg.compress_g1(pkg.g1.G1_GEN)) == pkg.g1.G1_GEN
    assert [PORT.agg.decompress_g1(pk) for pk in keys] == [JAX.agg.decompress_g1(pk) for pk in keys]
    assert (PORT.g1.Q, PORT.g1.FQ_LIMBS, PORT.g1.G1_GEN) == (JAX.g1.Q, JAX.g1.FQ_LIMBS,
                                                             JAX.g1.G1_GEN)


def _bad_keys() -> dict:
    x_off = bytearray(PORT.agg.compress_g1(PORT.g1.G1_GEN))
    gen = bytes(x_off)
    x_off[1:] = b"\xff" * 47
    x_off[0] = 0x80 | 0x1F
    x = next(x for x in range(1, 100) if pow((x ** 3 + 4) % Q, (Q - 1) // 2, Q) != 1)
    not_on_curve = bytearray(x.to_bytes(48, "big"))
    not_on_curve[0] |= 0x80  # x^3 + 4 is not a square mod q
    return {"not in compressed form": bytes([gen[0] & 0x7F]) + gen[1:],
            "point at infinity": bytes([gen[0] | 0x40]) + gen[1:],
            "x out of range": bytes(x_off), "not on the curve": bytes(not_on_curve)}


@pytest.mark.parametrize("why", list(_bad_keys()))
def test_bad_keys_are_refused_by_both_packages(why):
    for pkg in (PORT, JAX):
        with pytest.raises(ValueError, match=why):
            pkg.agg.decompress_g1(_bad_keys()[why])


@pytest.mark.parametrize("bits", [[1, 1, 1, 1], [0, 1, 0, 1], [1, 0, 0, 0], [0, 0, 0, 0]])
def test_host_aggregate_equals_the_jax_packages(bits):
    keys = _pubkeys(4, 9)
    got = PORT.agg.host_aggregate(keys, bits)
    assert got == JAX.agg.host_aggregate(keys, bits)
    pts = [PORT.agg.decompress_g1(pk) for pk, bit in zip(keys, bits) if bit]
    want = pts[0] if pts else None
    for p in pts[1:]:
        want = PORT.g1.host_g1_add(want, p)
    assert got == want


# ---------------------------------------------------------------------------
# The aggregate inner circuit at 2 members
# ---------------------------------------------------------------------------

PUBKEYS = _pubkeys(2, 42)


@pytest.fixture(scope="module")
def two():
    return {pkg.port: pkg.agg.build_aggregate_bls_circuit(2, fri=_fri(pkg)) for pkg in (PORT, JAX)}


def _agg_witness(pkg, data, bits, pubkeys=PUBKEYS, slice_index=0):
    w = data.new_witness()
    pkg.agg.set_aggregate_witness(data, w, SIGNING_ROOT, SIGNATURE, pubkeys, bits, slice_index)
    w.generate()
    return w


def test_aggregate_circuit_equals_the_jax_packages(two):
    data = two[True]
    same_circuit(data, two[False])
    assert (data.num_rows_used, data.log_n) == (8946, 14)
    assert data.config.num_wires == PORT.gp.NUM_WIRES_REQUIRED
    assert len(data.public_input_targets) == PORT.bls.DIGEST_LEN


@pytest.mark.parametrize("bits", [[1, 1], [0, 1], [1, 0]])
def test_aggregate_witness_equals_the_jax_packages(two, bits):
    """All members, and partial participation: the constrained aggregate is the
    host's, the constraints hold, and the witness is the JAX package's."""
    ws = {}
    for pkg in (PORT, JAX):
        w = ws[pkg.port] = _agg_witness(pkg, two[pkg.port], bits)
        agg_t = two[pkg.port]._agg_inputs[4]
        assert (pkg.g1.fq_value(w, agg_t.x), pkg.g1.fq_value(w, agg_t.y)) == \
            PORT.agg.host_aggregate(PUBKEYS, bits)
    assert violations(PORT, two[True], ws[True]) == []
    same_witness(ws[True], ws[False])
    assert PORT.agg.aggregate_witness(two[True], SIGNING_ROOT, SIGNATURE, PUBKEYS,
                                      bits).full_matrix().tolist() == \
        ws[True].full_matrix().tolist()


def _members_set(pkg, data, w, pubkeys, bits):
    sr_t, sig_t, members, points, agg_t, _ = data._agg_inputs
    for t, byte in zip(sr_t, SIGNING_ROOT):
        w.set(t, byte)
    for t, byte in zip(sig_t, SIGNATURE):
        w.set(t, byte)
    for (pk_t, bit_t), pk, bit in zip(members, pubkeys, bits):
        for t, byte in zip(pk_t, pk):
            w.set(t, byte)
        w.set(bit_t, int(bit))
    return points, agg_t


def _outcome(pkg, data, w) -> str:
    try:
        w.generate()
    except ValueError as e:
        assert "conflicting" in str(e)
        return "conflict"
    return "violations" if violations(pkg, data, w) else "accepted"


def test_a_wrong_aggregate_is_rejected_by_both_packages(two):
    """The unbinding agg + T == acc pins the true sum: PK_0 in its place conflicts."""
    got = []
    for pkg in (PORT, JAX):
        data = two[pkg.port]
        w = data.new_witness()
        points, agg_t = _members_set(pkg, data, w, PUBKEYS, [1, 1])
        for p_t, pk in zip(points, PUBKEYS):
            pkg.g1.set_g1(w, p_t, pkg.agg.decompress_g1(pk))
        pkg.g1.set_g1(w, agg_t, pkg.agg.decompress_g1(PUBKEYS[0]))
        got.append(_outcome(pkg, data, w))
    assert got[0] == got[1] != "accepted"


def test_a_flipped_sign_is_rejected_by_both_packages(two):
    """Point 0's y replaced by the other root q - y: the sign binding refuses it."""
    got = []
    for pkg in (PORT, JAX):
        data = two[pkg.port]
        w = data.new_witness()
        points, agg_t = _members_set(pkg, data, w, PUBKEYS, [1, 1])
        _, y = pkg.agg.decompress_g1(PUBKEYS[0])
        for t, limb in zip(points[0].y, [((Q - y) >> (32 * i)) & 0xFFFFFFFF for i in range(12)]):
            sid = w._sid(t)
            w.values[sid] = limb
            w.known[sid] = True
        pkg.g1.set_g1(w, points[1], pkg.agg.decompress_g1(PUBKEYS[1]))
        pkg.g1.set_g1(w, agg_t, pkg.agg.host_aggregate(PUBKEYS, [1, 1]))
        got.append(_outcome(pkg, data, w))
    assert got[0] == got[1] != "accepted"


def test_a_slice_without_a_set_bit_is_refused(two):
    for pkg in (PORT, JAX):
        with pytest.raises(AssertionError, match="at least one set bit"):
            _agg_witness(pkg, two[pkg.port], [0, 0])


# ---------------------------------------------------------------------------
# Four members in two slices, and the outer circuit absorbing both
# ---------------------------------------------------------------------------

SLICE_KEYS = _pubkeys(4, 11)
SLICE_BITS = [1, 0, 1, 1]


@pytest.fixture(scope="module")
def sliced():
    out = {}
    for pkg in (PORT, JAX):
        inner = pkg.agg.build_aggregate_bls_circuit(4, fri=_fri(pkg), num_slices=2, slice_size=2,
                                                    num_wires=184)
        syn = pkg.syn.make_synthetic_update_pair(4, seed=7, valid_pubkeys=True)
        b = pkg.builder.CircuitBuilder(cfg(pkg))
        t = pkg.lc.add_virtual_proof_target(b, committee_size=4, threshold=syn.threshold)
        pkg.bls.absorb_bls_proofs(b, t, [inner, inner])
        b.register_public_inputs(t.cur_state)
        b.register_public_inputs(t.new_state)
        out[pkg.port] = (inner, b.build())
    return out


def _bound_values(pubkeys, bits, slice_index: int, num_slices: int = 2) -> list:
    """What the outer circuit hashes for a slice: signing root, signature, the
    slice's members (48 bytes and a bit each), then its constants
    [slice_index, num_slices]."""
    per = len(pubkeys) // num_slices
    vals = list(SIGNING_ROOT) + list(SIGNATURE)
    for pk, bit in list(zip(pubkeys, bits))[slice_index * per:(slice_index + 1) * per]:
        vals += list(pk) + [int(bit)]
    return vals + [slice_index, num_slices]


def _digest(data, w) -> list:
    return [w.get(t) for t in data.public_input_targets]


def test_sliced_circuit_and_outer_equal_the_jax_packages(sliced):
    (inner, outer), (jinner, jouter) = sliced[True], sliced[False]
    same_circuit(inner, jinner)
    assert (inner.num_rows_used, inner.log_n, inner.config.num_wires) == (8946, 14, 184)
    assert inner._agg_slice == (2, 2)
    same_circuit(outer, jouter)
    assert (outer.num_rows_used, outer.log_n) == (14745, 14)


@pytest.mark.parametrize("slice_index", [0, 1])
def test_slice_witnesses_equal_the_jax_packages(sliced, slice_index):
    ws = {pkg.port: _agg_witness(pkg, sliced[pkg.port][0], SLICE_BITS, SLICE_KEYS, slice_index)
          for pkg in (PORT, JAX)}
    inner = sliced[True][0]
    same_witness(ws[True], ws[False])
    assert violations(PORT, inner, ws[True]) == []
    agg_t = inner._agg_inputs[4]
    lo = 2 * slice_index
    assert (PORT.g1.fq_value(ws[True], agg_t.x), PORT.g1.fq_value(ws[True], agg_t.y)) == \
        PORT.agg.host_aggregate(SLICE_KEYS[lo:lo + 2], SLICE_BITS[lo:lo + 2])
    # the digest is the host hash of what the outer circuit hashes for this slice
    assert _digest(inner, ws[True]) == [
        int(v) for v in pos.hash_no_pad_host(_bound_values(SLICE_KEYS, SLICE_BITS, slice_index))]


def test_slice_digests_bind_the_slice_and_its_bits(sliced):
    """Each slice's digest hashes its own [slice_index, num_slices], so slice 0's
    proof cannot stand in for slice 1's; a participation bit flipped in slice 0
    changes its digest, which then differs from the hash the outer circuit
    takes of its own values."""
    inner = sliced[True][0]
    d0, d1 = (_digest(inner, _agg_witness(PORT, inner, SLICE_BITS, SLICE_KEYS, i)) for i in (0, 1))
    assert d0 != d1
    assert d0 != [int(v) for v in pos.hash_no_pad_host(_bound_values(SLICE_KEYS, SLICE_BITS, 1))]
    flipped = [1, 1] + SLICE_BITS[2:]
    d0_flipped = _digest(inner, _agg_witness(PORT, inner, flipped, SLICE_KEYS, 0))
    outer_hash = [int(v) for v in pos.hash_no_pad_host(_bound_values(SLICE_KEYS, SLICE_BITS, 0))]
    assert d0 == outer_hash != d0_flipped
    jinner = sliced[False][0]
    assert _digest(jinner, _agg_witness(JAX, jinner, flipped, SLICE_KEYS, 0)) == d0_flipped


# ---------------------------------------------------------------------------
# Proofs on the CPU (heavy)
# ---------------------------------------------------------------------------


@pytest.mark.heavy
def test_cpu_proof_of_the_two_member_aggregate_equals_the_jax_packages(two):
    proof, vk, pd = PORT.agg.prove_aggregate_bls(two[True], SIGNING_ROOT, SIGNATURE, PUBKEYS,
                                                 [1, 1], device="cpu")
    assert pd.device.type == "cpu"
    jproof, jvk, _ = JAX.agg.prove_aggregate_bls(two[False], SIGNING_ROOT, SIGNATURE, PUBKEYS,
                                                 [1, 1])
    assert np.array_equal(vk.pre_cap, jvk.pre_cap)
    assert PORT.ser.proof_to_dict(proof, True) == JAX.ser.proof_to_dict(jproof, True)
    PORT.verify.verify(two[True], vk, proof)
    JAX.verify.verify(two[False], jvk, convert.proof_to_jax(proof))


@pytest.mark.heavy
def test_cli_run_proves_two_aggregate_slices_on_the_cpu(tmp_path):
    syn = PORT.syn.make_synthetic_update_pair(4, seed=3, valid_pubkeys=True)
    keep: dict = {}
    path = str(tmp_path / "bundle.json")
    report = cli.run(syn.witness_kwargs, 4, syn.threshold, pow_bits=4, query_rounds=4,
                     bls_mode="aggregate:slices=2", bls_save_dir=str(tmp_path / "inner"),
                     export_bundle_path=path, out=io.StringIO(), device="cpu", keep=keep)
    assert (report["cur_state"], report["new_state"]) == (syn.cur_state.hex(),
                                                          syn.new_state.hex())
    assert len(keep["bls_inners"]) == 2
    assert sorted(os.listdir(tmp_path / "inner")) == ["slice_0", "slice_1"]
    data, _, _ = keep["bls_inners"][0]
    for _, proof, vk in keep["bls_inners"]:
        PORT.verify.verify(data, vk, proof)
    spec = importlib.util.spec_from_file_location(
        "verify_standalone", os.path.join(REPO, "tools", "verify_standalone.py"))
    vs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vs)
    with open(path) as f:
        assert vs.verify_bundle(json.load(f)) is True
    # the outer takes the inner artifacts back from their slice directories
    again: dict = {}
    cli.run(syn.witness_kwargs, 4, syn.threshold, pow_bits=4, query_rounds=4, skip_prove=True,
            bls_mode=f"artifacts={tmp_path / 'inner'}", out=io.StringIO(), device="cpu",
            keep=again)
    assert (again["witness"].full_matrix() == keep["witness"].full_matrix()).all()
