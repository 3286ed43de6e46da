"""The port's BigUint and extension-field gadgets and the light-client circuit
(``models/lc_circuit.py``) against the JAX package's: one script builds each
circuit in both packages, and the tables (gates, constants, sigma, public-input
rows), the generated witnesses and the values read from them must be equal.
The negative cases fail in both packages, at witness generation or through
``check_constraints``.  Vectors come from numpy seeds and the host SSZ code;
every comparison is exact."""

import hashlib

import numpy as np
import pytest
import torch

from eth_lc_plonky2_tpu_torch.eth import ssz
from eth_lc_plonky2_tpu_torch.ops import goldilocks_ext as ge
from eth_lc_plonky2_tpu_torch.ops import sha256 as shaops
from torch_circuits import JAX, PORT, cfg, preprocess, same_circuit, same_witness, violations

torch.set_num_threads(1)


def _both(script, *args):
    """(port data, port witness, port outputs), checked equal to the JAX package's."""
    data, w, out = script(PORT, *args)
    jdata, jw, jout = script(JAX, *args)
    same_circuit(data, jdata)
    same_witness(w, jw)
    assert out == jout
    return data, w, out


def _digest(w, h) -> bytes:
    return shaops.bytes_from_words(np.array([w.get(t) for t in h], dtype=np.uint32))


# ---------------------------------------------------------------------------
# BigUint gadgets
# ---------------------------------------------------------------------------


def _biguint(pkg, xv, yv):
    b = pkg.builder.CircuitBuilder(cfg(pkg, 96))
    x = pkg.gb.add_virtual_biguint_target(b, 8)
    y = pkg.gb.add_virtual_biguint_target(b, 8)
    s = pkg.gb.add_biguint(b, x, y)
    m = pkg.gb.mul_biguint(b, x[:2], y[:2])
    le = pkg.gb.cmp_biguint(b, x, y)
    eq = pkg.gb.is_equal_biguint(b, x, y)
    q, r = pkg.gb.div_rem_biguint(b, x[:2], pkg.gb.constant_biguint(b, 8192, 1))
    h = pkg.gs.add_virtual_hash256(b)
    pkg.gb.biguint_hash256_connect(b, x, h)
    b.register_public_input(q[0])
    b.register_public_input(r[0])
    data = b.build()
    w = data.new_witness()
    pkg.gb.set_biguint_target(w, x, xv)
    pkg.gb.set_biguint_target(w, y, yv)
    w.generate()
    out = {"sum": pkg.gb.biguint_value(w, s), "mul": pkg.gb.biguint_value(w, m),
           "le": w.get(le), "eq": w.get(eq), "q": w.get(q[0]), "r": w.get(r[0]),
           "hash": [w.get(t) for t in h]}
    return data, w, out


@pytest.mark.parametrize("xv,yv", [(5188822, 5188822), (0xDEADBEEF_CAFEBABE, 0x12345678_9ABCDEF0),
                                   ((1 << 200) + 25000, (1 << 200) + (1 << 64))])
def test_biguint_gadgets_equal_the_jax_packages(xv, yv):
    _, _, out = _both(_biguint, xv, yv)
    lo = xv & ((1 << 64) - 1)
    assert out["sum"] == xv + yv and out["mul"] == lo * (yv & ((1 << 64) - 1))
    assert (out["le"], out["eq"]) == (int(xv <= yv), int(xv == yv))
    assert (out["q"], out["r"]) == ((lo // 8192) & 0xFFFF_FFFF, lo % 8192)  # the low limbs
    assert out["hash"] == [int(v) for v in np.frombuffer(xv.to_bytes(32, "little"), dtype=">u4")]


def _div_rem(pkg):
    b = pkg.builder.CircuitBuilder(cfg(pkg, 96))
    slot = pkg.gb.add_virtual_biguint_target(b, 2)
    q, r = pkg.gb.div_rem_biguint(b, slot, pkg.gb.constant_biguint(b, 8192, 1))
    b.register_public_input(q[0])
    b.register_public_input(r[0])
    data = b.build()
    w = data.new_witness()
    pkg.gb.set_biguint_target(w, slot, 5188822)
    w.generate()
    return data, w, (q, r)


def test_div_rem_proof_equals_the_jax_packages_and_a_forged_quotient_fails():
    data, w, (q, r) = _div_rem(PORT)
    jdata, jw, _ = _div_rem(JAX)
    same_circuit(data, jdata)
    pd, vk = preprocess(PORT, data)
    jpd, jvk = preprocess(JAX, jdata)
    proof = PORT.pr.prove(pd, w)
    assert PORT.ser.proof_to_dict(proof, True) == JAX.ser.proof_to_dict(JAX.pr.prove(jpd, jw), True)
    assert [int(v) for v in proof.public_inputs] == [633, 5188822 % 8192]
    PORT.verify.verify(data, vk, proof)
    # q - 1 and r + 8192 keep x = q * d + r but break r < d
    nw = data.config.num_wires
    forged = {}
    for pkg, d, wit in ((PORT, data, w), (JAX, jdata, jw)):
        sid_q, sid_r = (int(d.rep[t.row * nw + t.col]) for t in (q[0], r[0]))
        wit.values[sid_q] = int(wit.values[sid_q]) - 1
        wit.values[sid_r] = int(wit.values[sid_r]) + 8192
        forged[pkg.port] = violations(pkg, d, wit)
    assert forged[True] == forged[False] and forged[True]
    with pytest.raises(PORT.verify.VerificationError):
        PORT.verify.verify(data, vk, PORT.pr.prove(pd, w))


# ---------------------------------------------------------------------------
# Extension-field gadgets
# ---------------------------------------------------------------------------

X = (123456789123456789, 987654321987654321)
Y = (111111111111111, 22222222222222222)


def _ext(pkg):
    gx = pkg.gx
    b = pkg.builder.CircuitBuilder(cfg(pkg, 96))
    xt = gx.add_virtual_ext(b)
    x, y = gx.ext_constant(b, X), gx.ext_constant(b, Y)
    m, s, d, q = gx.ext_mul(b, x, y), gx.ext_add(b, x, y), gx.ext_sub(b, x, y), gx.ext_div(b, xt, y)
    inv = gx.ext_inverse(b, xt)
    mc = gx.ext_mul_const(b, x, Y)
    pows = gx.ext_pow2_chain(b, x, 3)
    e = gx.ext_exp_bits(b, pows[:3], [b.constant(1), b.constant(0), b.constant(1)])
    bits = [b.constant(1), b.constant(0), b.constant(1)]
    ra = gx.random_access(b, bits, [b.constant(100 + i) for i in range(8)])
    dg = gx.random_access_digest(b, bits[:2], [[b.constant(10 * i + j) for j in range(4)]
                                               for i in range(4)])
    sel = gx.ext_select(b, bits[1], x, y)
    split = gx.split_64(b, b.constant(0xDEADBEEF12345678))
    mb = gx.ext_mul_base(b, x, b.constant(9))
    outs = [m.re, m.im, s.re, s.im, d.re, d.im, q.re, q.im, inv.re, inv.im, mc.re, mc.im, e.re,
            e.im, ra, *dg, sel.re, sel.im, mb.re, mb.im]
    b.register_public_inputs(outs)
    data = b.build()
    w = data.new_witness()
    gx.set_ext(w, xt, X)
    w.generate()
    return data, w, [w.get(t) for t in outs] + [w.get(t) for t in split]


def test_ext_gadgets_equal_the_jax_packages():
    data, w, out = _both(_ext)
    want = [*ge.h_mul(X, Y), *ge.h_add(X, Y), *ge.h_sub(X, Y), *ge.h_mul(X, ge.h_inv(Y)),
            *ge.h_inv(X), *ge.h_mul(X, Y), *ge.h_pow(X, 5), 105, 10, 11, 12, 13, *Y,
            *ge.h_mul(X, (9, 0))]
    assert out[:len(want)] == want
    assert out[len(want):] == [(0xDEADBEEF12345678 >> i) & 1 for i in range(64)]
    assert violations(PORT, data, w) == []


# ---------------------------------------------------------------------------
# The light-client subcircuits
# ---------------------------------------------------------------------------


def _rand32(rng):
    return bytes(rng.integers(0, 256, 32, dtype=np.uint8))


def _signing_root_and_header(pkg, seed):
    rng = np.random.default_rng(seed)
    lc, gs = pkg.lc, pkg.gs
    b = pkg.builder.CircuitBuilder(cfg(pkg))
    sr = lc.add_virtual_signing_root_target(b)
    hd = lc.add_virtual_beacon_block_header_target(b)
    data = b.build()
    w = data.new_witness()
    header_root, dom = _rand32(rng), _rand32(rng)
    gs.set_hash256(w, sr.header_root, header_root)
    gs.set_hash256(w, sr.domain, dom)
    slot, proposer = int(rng.integers(0, 1 << 40)), int(rng.integers(0, 1 << 20))
    roots = [_rand32(rng) for _ in range(3)]
    lc._set_u64_leaf(w, hd.slot, slot)
    lc._set_u64_leaf(w, hd.proposer_index, proposer)
    for t, v in zip((hd.parent_root, hd.state_root, hd.body_root), roots):
        gs.set_hash256(w, t, v)
    w.generate()
    assert _digest(w, sr.signing_root) == ssz.signing_data_root(header_root, dom)
    assert _digest(w, hd.header_root) == ssz.beacon_block_header_root(slot, proposer, *roots)
    return data, w, _digest(w, hd.header_root)


def _contract_state(pkg, seed):
    rng = np.random.default_rng(seed)
    lc, gs = pkg.lc, pkg.gs
    b = pkg.builder.CircuitBuilder(cfg(pkg))
    t = lc.add_virtual_contract_state_target(b)
    data = b.build()
    w = data.new_witness()
    cur_slot, new_slot = 5188736, 5201076
    cur_h, new_h, com_i, com_ii = (_rand32(rng) for _ in range(4))
    lc._set_u64_leaf(w, t.cur_slot, cur_slot)
    gs.set_hash256(w, t.cur_header, cur_h)
    gs.set_hash256(w, t.cur_sync_committee_i, com_i)
    gs.set_hash256(w, t.cur_sync_committee_ii, com_ii)
    lc._set_u64_leaf(w, t.new_slot, new_slot)
    gs.set_hash256(w, t.new_header, new_h)
    gs.set_hash256(w, t.new_sync_committee_i, com_i)
    gs.set_hash256(w, t.new_sync_committee_ii, com_ii)
    w.generate()
    out = (_digest(w, t.cur_state), _digest(w, t.new_state))
    assert out == (ssz.contract_state_root(cur_slot, cur_h, com_i, com_ii),
                   ssz.contract_state_root(new_slot, new_h, com_i, com_ii))
    return data, w, out


def _find_sync_committee(pkg, attested_slot):
    lc, gb, gs = pkg.lc, pkg.gb, pkg.gs
    b = pkg.builder.CircuitBuilder(cfg(pkg))
    t = lc.add_virtual_find_sync_committee_target(b)
    for tt in t.sync_committee_for_attested_slot:
        b.register_public_input(tt)
    data = b.build()
    w = data.new_witness()
    gb.set_biguint_target(w, t.cur_slot_big, 5188736)
    gb.set_biguint_target(w, t.attested_slot_big, attested_slot)
    gs.set_hash256(w, t.cur_sync_committee_i, b"\x01" * 32)
    gs.set_hash256(w, t.cur_sync_committee_ii, b"\x02" * 32)
    w.generate()
    return data, w, (w.get(t.is_attested_from_next_period),
                     _digest(w, t.sync_committee_for_attested_slot))


def _verify_sync_committee(pkg, is_next, new_i):
    rng = np.random.default_rng(11)
    leaves = [_rand32(rng) for _ in range(32)]
    lc, gs = pkg.lc, pkg.gs
    idx = lc.SYNC_COMMITTEE_INDEX - 32
    committee_ii, layer, branch = leaves[idx], list(leaves), []
    while len(layer) > 1:
        branch.append(layer[idx ^ 1])
        layer = [hashlib.sha256(layer[i] + layer[i + 1]).digest() for i in range(0, len(layer), 2)]
        idx //= 2
    b = pkg.builder.CircuitBuilder(cfg(pkg))
    t = lc.add_virtual_verify_sync_committee_target(b)
    data = b.build()
    w = data.new_witness()
    w.set(t.is_attested_from_next_period, is_next)
    gs.set_hash256(w, t.cur_sync_committee_i, b"\x01" * 32)
    gs.set_hash256(w, t.cur_sync_committee_ii, b"\x02" * 32)
    gs.set_hash256(w, t.new_sync_committee_i, new_i)
    gs.set_hash256(w, t.new_sync_committee_ii, committee_ii)
    gs.set_hash256(w, t.finalized_state_root, layer[0])
    for sib_t, sib in zip(t.new_sync_committee_ii_branch, branch):
        gs.set_hash256(w, sib_t, sib)
    w.generate()
    return data, w, None


def _update_validity(pkg, cur_slot, finalized_slot, participation):
    gb = pkg.gb
    b = pkg.builder.CircuitBuilder(cfg(pkg))
    t = pkg.lc.add_virtual_update_validity_target(b)
    data = b.build()
    w = data.new_witness()
    gb.set_biguint_target(w, t.cur_slot_big, cur_slot)
    gb.set_biguint_target(w, t.finalized_slot_big, finalized_slot)
    gb.set_biguint_target(w, t.participation_big, participation)
    w.generate()
    return data, w, None


def _sync_committee_ssz(pkg, size):
    rng = np.random.default_rng(5)
    pubkeys = [bytes(rng.integers(0, 256, 48, dtype=np.uint8)) for _ in range(size)]
    agg = bytes(rng.integers(0, 256, 48, dtype=np.uint8))
    b = pkg.builder.CircuitBuilder(cfg(pkg))
    sc = pkg.lc.add_virtual_sync_committee_target(b, size)
    root = pkg.lc.ssz_sync_committee(b, sc)
    data = b.build()
    w = data.new_witness()
    for pk_t, pk in zip(sc.pubkeys, pubkeys):
        for bt, byte in zip(pk_t, pk):
            w.set(bt, byte)
    for bt, byte in zip(sc.aggregate_pubkey, agg):
        w.set(bt, byte)
    w.generate()
    assert _digest(w, root) == ssz.sync_committee_root(pubkeys, agg)
    return data, w, _digest(w, root)


def _finality_branch(pkg, root):
    kw = pkg.syn.make_synthetic_update_pair(4, seed=2).witness_kwargs
    b = pkg.builder.CircuitBuilder(cfg(pkg))
    t = pkg.gm.add_verify_merkle_proof(b, pkg.lc.FINALIZED_HEADER_INDEX,
                                       pkg.lc.FINALIZED_HEADER_HEIGHT)
    data = b.build()
    w = data.new_witness()
    header = ssz.beacon_block_header_root(
        kw["finalized_slot"], kw["finalized_proposer_index"], kw["finalized_parent_root"],
        kw["finalized_state_root"], kw["finalized_body_root"])
    pkg.gm.set_verify_merkle_proof_target(w, header, kw["finality_branch"], t)
    pkg.gs.set_hash256(w, t.root, root or kw["attested_state_root"])
    w.generate()
    return data, w, None


SUBCIRCUITS = {
    "signing_root_and_header": (_signing_root_and_header, 3),
    "contract_state": (_contract_state, 4),
    "find_sync_committee_same_period": (_find_sync_committee, 5188822),
    "find_sync_committee_next_period": (_find_sync_committee, 5201076),
    "verify_sync_committee_next": (_verify_sync_committee, 1, b"\x02" * 32),
    "verify_sync_committee_not_next": (_verify_sync_committee, 0, b"\x01" * 32),
    "update_validity": (_update_validity, 100, 200, 433),
    "sync_committee_ssz_4": (_sync_committee_ssz, 4),
    "finality_branch": (_finality_branch, None),
}


@pytest.mark.parametrize("name", sorted(SUBCIRCUITS))
def test_subcircuits_equal_the_jax_packages(name):
    script, *args = SUBCIRCUITS[name]
    data, w, out = _both(script, *args)
    assert violations(PORT, data, w) == []
    if name.startswith("find_sync_committee"):
        assert out == ((0, b"\x01" * 32) if name.endswith("same_period") else (1, b"\x02" * 32))


NEGATIVE = {
    "wrong_finality_root": (_finality_branch, b"\xab" * 32),
    "two_periods_ahead": (_find_sync_committee, 5188736 + 2 * 8192),
    "rollover_wrong_new_i": (_verify_sync_committee, 1, b"\x01" * 32),
    "not_next_wrong_new_i": (_verify_sync_committee, 0, b"\x02" * 32),
    "slot_regression": (_update_validity, 200, 100, 433),
    "low_participation": (_update_validity, 100, 200, 300),
}


@pytest.mark.parametrize("name", sorted(NEGATIVE))
def test_negative_subcircuits_fail_in_both_packages(name):
    script, *args = NEGATIVE[name]
    for pkg in (PORT, JAX):
        with pytest.raises(ValueError):
            script(pkg, *args)


# ---------------------------------------------------------------------------
# The whole light-client circuit at committee 4
# ---------------------------------------------------------------------------

SIZE = 4


def _lc_circuit(pkg):
    s = pkg.syn.make_synthetic_update_pair(SIZE, seed=7)
    b = pkg.builder.CircuitBuilder(cfg(pkg))
    t = pkg.lc.add_virtual_proof_target(b, committee_size=SIZE, threshold=s.threshold)
    b.register_public_inputs(t.cur_state)
    b.register_public_inputs(t.new_state)
    data = b.build()
    w = data.new_witness()
    pkg.lc.set_proof_target(w, t, **s.witness_kwargs)
    w.generate()
    return data, w, t, s


@pytest.fixture(scope="module")
def lc4():
    data, w, t, s = _lc_circuit(PORT)
    jdata, jw, jt, _ = _lc_circuit(JAX)
    return data, w, t, s, jdata, jw


def test_light_client_circuit_equals_the_jax_packages(lc4):
    data, w, t, s, jdata, jw = lc4
    same_circuit(data, jdata)
    same_witness(w, jw)
    assert (data.num_rows_used, data.log_n) == (6232, 13)
    assert _digest(w, t.cur_state) == s.cur_state and _digest(w, t.new_state) == s.new_state
    assert violations(PORT, data, w) == [] == violations(JAX, jdata, jw)


@pytest.mark.parametrize("gate", ["sha256", "arith", "basesum2"])
def test_a_forged_light_client_witness_fails_in_both_packages(lc4, gate):
    """One wire of a ``gate`` row changed after generation: both packages'
    ``check_constraints`` report the same violations."""
    data, w, _, _, jdata, jw = lc4
    nw = data.config.num_wires
    row = int(np.flatnonzero(data.selectors[data.gate_names.index(gate)])[5])
    got = {}
    for pkg, d, wit in ((PORT, data, w), (JAX, jdata, jw)):
        forged = d.new_witness()
        forged.values, forged.known = wit.values.copy(), wit.known.copy()
        sid = int(d.rep[row * nw + 1])
        forged.values[sid] = (int(forged.values[sid]) + 1) % ((1 << 64) - (1 << 32) + 1)
        got[pkg.port] = violations(pkg, d, forged)
    assert got[True] == got[False]
    assert got[True], f"a forged {gate} wire goes unnoticed"


def test_wrong_public_input_fails_in_both_packages(lc4):
    data, w, _, _, jdata, jw = lc4
    pis = [w.get(t) for t in data.public_input_targets]
    pis[3] ^= 1
    got = PORT.debug.check_constraints(data, w.full_matrix(), pis)
    assert got == JAX.debug.check_constraints(jdata, jw.full_matrix(), pis)
    assert [v[0] for v in got] == ["public_input"]


def test_low_participation_fails_in_both_packages():
    for pkg in (PORT, JAX):
        s = pkg.syn.make_synthetic_update_pair(SIZE, seed=7, participation=1)
        b = pkg.builder.CircuitBuilder(cfg(pkg))
        t = pkg.lc.add_virtual_proof_target(b, committee_size=SIZE, threshold=s.threshold)
        w = b.build().new_witness()
        pkg.lc.set_proof_target(w, t, **s.witness_kwargs)
        with pytest.raises(ValueError):
            w.generate()
