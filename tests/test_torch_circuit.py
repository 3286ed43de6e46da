"""The port's host layer against the JAX package: the ``Challenger`` on a seeded
sequence of observes and squeezes, both circuit builders on the same gadget
calls (tables, ``rep`` and witness matrix equal), the gates and their specs,
the two algebras, the config, and the circuit conversion.  Exact."""

import dataclasses

import numpy as np
import pytest
import torch

from eth_lc_plonky2_tpu.circuit import algebra as jalgebra
from eth_lc_plonky2_tpu.circuit import builder as jbuilder
from eth_lc_plonky2_tpu.circuit import gates as jgates
from eth_lc_plonky2_tpu.ops import goldilocks as jgl
from eth_lc_plonky2_tpu.prover import config as jconfig
from eth_lc_plonky2_tpu.prover.transcript import Challenger as JChallenger
from eth_lc_plonky2_tpu_torch import convert
from eth_lc_plonky2_tpu_torch.circuit import algebra, builder, gates
from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.prover import config
from eth_lc_plonky2_tpu_torch.prover.transcript import Challenger

torch.set_num_threads(1)

P = gl.P


# ---------------------------------------------------------------------------
# Transcript
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_challenger_on_a_seeded_sequence(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = Challenger(), JChallenger()
    for _ in range(12):
        kind = int(rng.integers(0, 5))
        if kind == 0:
            xs = [int(v) for v in rng.integers(0, P, size=int(rng.integers(1, 20)), dtype=np.uint64)]
            ours.observe_many(xs)
            theirs.observe_many(xs)
        elif kind == 1:
            cap = rng.integers(0, P, size=(4, 4), dtype=np.uint64)
            ours.observe_cap(cap)
            theirs.observe_cap(cap)
        elif kind == 2:
            x = (int(rng.integers(0, P, dtype=np.uint64)), int(rng.integers(0, P, dtype=np.uint64)))
            ours.observe_ext(x)
            theirs.observe_ext(x)
        elif kind == 3:
            k = int(rng.integers(1, 12))
            assert ours.challenges(k) == theirs.challenges(k)
        else:
            assert ours.challenge_ext() == theirs.challenge_ext()
    assert ours.challenge() == theirs.challenge()
    assert ours.state == theirs.state


# ---------------------------------------------------------------------------
# Builders: the same gadget calls through both
# ---------------------------------------------------------------------------


def _drive(mod, cfg_mod, which):
    """Run one gadget script on one package's builder; returns (data, witness)."""
    fri = cfg_mod.FriConfig(proof_of_work_bits=8, num_query_rounds=12)
    if which == "narrow":
        cfg = cfg_mod.CircuitConfig(num_wires=16, num_routed_wires=16, num_constants=2,
                                    permutation_chunk_size=2, fri=fri)
    else:
        cfg = cfg_mod.CircuitConfig(fri=fri)
    b = mod.CircuitBuilder(cfg)
    values = {}
    if which == "arith":
        x, y = b.add_virtual_target(), b.add_virtual_target()
        out = b.add_const(b.add(b.mul(x, y), x), 7)
        d = b.sub(out, b.mul_const(3, y))
        flag = b.add_virtual_bool_target()
        e = b.select(flag, d, b.constant(999))
        f = b.or_(flag, b.not_(b.and_(flag, flag)))
        b.register_public_inputs([out, e, f])
        values = {x: 5, y: 11, flag: 1}
    elif which == "bits":
        v = b.add_virtual_target()
        bits = b.split_le(v, 32)
        b.assert_equal(b.le_sum(bits), v)
        small = b.add_virtual_target()
        b.range_check_u32(small)
        low = b.split_le(small, 12)
        b.register_public_input(b.add_many(low))
        values = {v: 0xDEADBEEF, small: 0xABC}
    elif which == "equal":
        u, v, w = b.add_virtual_targets(3)
        b.register_public_inputs([b.is_equal(u, v), b.is_equal(u, w)])
        b.assert_zero(b.sub(u, v))
        values = {u: 42, v: 42, w: 43}
    else:  # narrow: a long chain on 16 wires
        x = b.add_virtual_target()
        acc = x
        while len(b.rows) < 40:
            acc = b.mul_add(acc, x, x)
        b.register_public_input(acc)
        values = {x: 3}
    data = b.build()
    w = data.new_witness()
    for t, v in values.items():
        w.set(t, v)
    w.generate()
    return data, w


SCRIPTS = ["arith", "bits", "equal", "narrow"]


@pytest.mark.parametrize("which", SCRIPTS)
def test_both_builders_give_the_same_tables_and_witness(which):
    ours, w_ours = _drive(builder, config, which)
    theirs, w_theirs = _drive(jbuilder, jconfig, which)
    assert (ours.log_n, ours.num_rows_used, ours.gate_names) == (
        theirs.log_n, theirs.num_rows_used, theirs.gate_names)
    for name in ("selectors", "constants", "sigma", "rep", "k_shifts"):
        got, want = getattr(ours, name), getattr(theirs, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert [tuple(t) for t in ours.public_input_targets] == [
        tuple(t) for t in theirs.public_input_targets]
    assert [gates.gate_to_spec(g) for g in ours.gates] == [
        jgates.gate_to_spec(g) for g in theirs.gates]
    assert np.array_equal(w_ours.full_matrix(), w_theirs.full_matrix())
    assert [w_ours.get(t) for t in ours.public_input_targets] == [
        w_theirs.get(t) for t in theirs.public_input_targets]


def test_witness_conflicts_and_stuck_generators_raise():
    b = builder.CircuitBuilder(config.CircuitConfig())
    x, y = b.add_virtual_target(), b.add_virtual_target()
    b.connect(x, y)
    z = b.mul(x, b.add_virtual_target())
    data = b.build()
    w = data.new_witness()
    w.set(x, 1)
    with pytest.raises(ValueError):
        w.set(y, 2)
    with pytest.raises(KeyError):
        w.get(z)
    with pytest.raises(RuntimeError):
        w.generate()  # the second factor was never set


# ---------------------------------------------------------------------------
# Gates, algebras, config
# ---------------------------------------------------------------------------


GATES = [("noop", {}), ("arith", {"num_ops": 4}), ("arith", {"num_ops": 20}),
         ("basesum2", {"num_bits": 32, "num_slots": 2}), ("const", {"num_slots": 6})]


@pytest.mark.parametrize("kind,params", GATES)
def test_gates_evaluate_alike_in_both_algebras(kind, params):
    spec = {"type": kind, **params}
    ours, theirs = gates.gate_from_spec(spec), jgates.gate_from_spec(spec)
    assert gates.gate_to_spec(ours) == jgates.gate_to_spec(theirs) == spec
    assert (ours.name, ours.num_constraints, ours.degree, ours.wire_offsets) == (
        theirs.name, theirs.num_constraints, theirs.degree, theirs.wire_offsets)
    rng = np.random.default_rng(3)
    wires_u = rng.integers(0, P, size=(80, 16), dtype=np.uint64)
    consts_u = rng.integers(0, P, size=(6, 16), dtype=np.uint64)
    # base field, over a domain of 16 points
    wt, ct = gl.from_u64(wires_u), gl.from_u64(consts_u)
    got = ours.eval(algebra.DeviceBaseAlgebra((16,), "cpu"),
                    lambda col, offset=0: wt[col], lambda i: ct[i])
    want = theirs.eval(jalgebra.DeviceBaseAlgebra((16,)),
                       lambda col, offset=0: jgl.from_u64(wires_u[col]),
                       lambda i: jgl.from_u64(consts_u[i]))
    assert len(got) == len(want) == ours.num_constraints
    for g, w in zip(got, want):
        assert np.array_equal(gl.to_u64(g), jgl.to_u64(w))
    # extension field, at one point
    ext = lambda row: (int(row[0]), int(row[1]))  # noqa: E731
    got = ours.eval(algebra.HostExtAlgebra(), lambda col, offset=0: ext(wires_u[col]),
                    lambda i: ext(consts_u[i]))
    want = theirs.eval(jalgebra.HostExtAlgebra(), lambda col, offset=0: ext(wires_u[col]),
                       lambda i: ext(consts_u[i]))
    assert got == want


@pytest.mark.parametrize("kind", ["poseidon", "sha256"])
def test_unported_gate_specs_raise(kind):
    """No gate of the JAX package is unported any more: these two specs, which
    raised "not ported yet" before the gates came over, build their gates, and
    only an unknown type raises."""
    gate = gates.gate_from_spec({"type": kind})
    theirs = jgates.gate_from_spec({"type": kind})
    assert (gate.name, gate.num_constraints, gate.degree, tuple(gate.wire_offsets)) == (
        theirs.name, theirs.num_constraints, theirs.degree, tuple(theirs.wire_offsets))
    assert gates.gate_to_spec(gate) == jgates.gate_to_spec(theirs) == {"type": kind}
    with pytest.raises(ValueError):
        gates.gate_from_spec({"type": "nonsense"})


def test_algebras_small_helpers():
    a, ja = algebra.DeviceBaseAlgebra((4,), "cpu"), jalgebra.DeviceBaseAlgebra((4,))
    x = np.array([1, P - 1, 5, 1 << 40], dtype=np.uint64)
    for c in (0, 1, 7, P - 1):
        assert np.array_equal(gl.to_u64(a.constant(c)), jgl.to_u64(ja.constant(c)))
    assert np.array_equal(gl.to_u64(a.mul_small(9, gl.from_u64(x))),
                          jgl.to_u64(ja.mul_small(9, jgl.from_u64(x))))
    assert np.array_equal(gl.to_u64(a.add_many([gl.from_u64(x)] * 3)),
                          jgl.to_u64(ja.add_many([jgl.from_u64(x)] * 3)))
    assert np.array_equal(gl.to_u64(a.add_many([])), jgl.to_u64(ja.add_many([])))
    assert np.array_equal(gl.to_u64(a.one()), jgl.to_u64(ja.one()))
    h, jh = algebra.HostExtAlgebra(), jalgebra.HostExtAlgebra()
    assert h.add_many([(1, 2), (P - 1, 5)]) == jh.add_many([(1, 2), (P - 1, 5)])
    assert h.mul_small(9, (P - 1, 5)) == jh.mul_small(9, (P - 1, 5))
    assert (h.constant(P + 3), h.zero(), h.one()) == (jh.constant(P + 3), jh.zero(), jh.one())


def test_config_copy_matches_original():
    assert dataclasses.asdict(config.CircuitConfig()) == dataclasses.asdict(jconfig.CircuitConfig())
    ours, theirs = config.CircuitConfig(num_wires=184), jconfig.CircuitConfig(num_wires=184)
    for name in ("num_permutation_chunks", "num_partial_products", "rate_bits", "cap_height"):
        assert getattr(ours, name) == getattr(theirs, name)


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", SCRIPTS)
def test_circuit_data_from_jax(which):
    theirs, w_theirs = _drive(jbuilder, jconfig, which)
    ours, _ = _drive(builder, config, which)
    carried = convert.circuit_data_from_jax(theirs)
    assert isinstance(carried, builder.CircuitData) and isinstance(carried.config, config.CircuitConfig)
    assert carried.config == ours.config
    assert all(type(g).__module__ == gates.__name__ for g in carried.gates)
    for name in ("selectors", "constants", "sigma", "rep", "k_shifts"):
        assert np.array_equal(getattr(carried, name), getattr(ours, name)), name
    assert carried.public_input_targets == ours.public_input_targets
    mw = convert.witness_matrix(w_theirs)
    assert np.array_equal(mw.full_matrix(), w_theirs.full_matrix())
    assert [mw.get(t) for t in carried.public_input_targets] == [
        w_theirs.get(t) for t in theirs.public_input_targets]
