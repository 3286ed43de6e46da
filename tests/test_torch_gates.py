"""The port's SHA-256 and Poseidon gates against the JAX package (numpy
backend): the witness traces, the builder's tables and witnesses, each gate's
``eval`` and its selector-weighted alpha combination on random field words,
the launch plan of ``csrc/gates.cu`` (offset arithmetic against ``roll_lde``,
argument checks, the constraint index layout), and whole proofs of the
Poseidon circuits.  Same numpy-seeded inputs through both packages; every comparison
is exact (tolerance 0)."""

import hashlib
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from eth_lc_plonky2_tpu.circuit import algebra as jalgebra
from eth_lc_plonky2_tpu.circuit import builder as jbuilder
from eth_lc_plonky2_tpu.circuit import gadgets_merkle as jgm
from eth_lc_plonky2_tpu.circuit import gadgets_sha256 as jgs
from eth_lc_plonky2_tpu.circuit import gates_poseidon as jgp
from eth_lc_plonky2_tpu.circuit import gates_sha256 as jgsha
from eth_lc_plonky2_tpu.ops import goldilocks as jgl
from eth_lc_plonky2_tpu.ops import ntt as jntt
from eth_lc_plonky2_tpu.ops import poseidon as jpos
from eth_lc_plonky2_tpu.ops import sha256 as jsha
from eth_lc_plonky2_tpu.prover import config as jconfig
from eth_lc_plonky2_tpu.prover import prove as jpr
from eth_lc_plonky2_tpu.prover import serialize as jserialize
from eth_lc_plonky2_tpu.prover.verify import verify as jverify
from eth_lc_plonky2_tpu_torch import convert
from eth_lc_plonky2_tpu_torch.circuit import algebra
from eth_lc_plonky2_tpu_torch.circuit import builder
from eth_lc_plonky2_tpu_torch.circuit import gadgets_merkle as gm
from eth_lc_plonky2_tpu_torch.circuit import gadgets_sha256 as gs
from eth_lc_plonky2_tpu_torch.circuit import gates
from eth_lc_plonky2_tpu_torch.circuit import gates_poseidon as gp
from eth_lc_plonky2_tpu_torch.circuit import gates_sha256 as gsha
from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.ops import kernels
from eth_lc_plonky2_tpu_torch.ops import ntt
from eth_lc_plonky2_tpu_torch.ops import poseidon as pos
from eth_lc_plonky2_tpu_torch.ops import sha256 as sha
from eth_lc_plonky2_tpu_torch.prover import config
from eth_lc_plonky2_tpu_torch.prover import prove as pr
from eth_lc_plonky2_tpu_torch.prover.verify import verify

torch.set_num_threads(1)

P = gl.P
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Pkg:
    """The same names of one package, so that one circuit-building script serves both."""

    def __init__(self, builder_mod, config_mod, gs_mod, gm_mod, gp_mod):
        self.CircuitBuilder = builder_mod.CircuitBuilder
        self.config = config_mod
        self.gs, self.gm, self.gp = gs_mod, gm_mod, gp_mod

    def new_builder(self):
        fri = self.config.FriConfig(proof_of_work_bits=8, num_query_rounds=12)
        return self.CircuitBuilder(self.config.CircuitConfig(num_wires=184, fri=fri))


JAX = Pkg(jbuilder, jconfig, jgs, jgm, jgp)
PORT = Pkg(builder, config, gs, gm, gp)


# ---------------------------------------------------------------------------
# Witness traces and host hashing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 70])
def test_compress_trace_np_equals_the_jax_packages(n):
    rng = np.random.default_rng(n)
    state = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint32)
    block = rng.integers(0, 1 << 32, size=(n, 16), dtype=np.uint32)
    got, want = sha.compress_trace_np(state, block), jsha.compress_trace_np(state, block)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
    assert np.array_equal(sha.compress_np(state, block), want["out"])
    assert np.array_equal(sha.message_schedule_np(block), want["w"])


def test_two_to_one_np_is_sha256():
    rng = np.random.default_rng(1)
    raw = [bytes(rng.integers(0, 256, 64, dtype=np.uint8)) for _ in range(5)]
    left = np.stack([sha.words_from_bytes(r[:32]) for r in raw])
    right = np.stack([sha.words_from_bytes(r[32:]) for r in raw])
    out = sha.two_to_one_np(left, right)
    assert np.array_equal(out, jsha.two_to_one_np(left, right))
    for k, r in enumerate(raw):
        assert sha.bytes_from_words(out[k]) == hashlib.sha256(r).digest()
    assert np.array_equal(sha.K, jsha.K) and np.array_equal(sha.IV, jsha.IV)
    assert np.array_equal(sha.PAD_BLOCK_64B, jsha.PAD_BLOCK_64B)


@pytest.mark.parametrize("n", [5, 70])  # the Python-integer path and the numpy path
def test_permute_trace_np_equals_the_jax_packages(n):
    states = np.random.default_rng(n).integers(0, P, size=(n, 12), dtype=np.uint64)
    states[0, :3] = (0, P - 1, 1 << 32)
    adv, out = pos.permute_trace_np(states)
    jadv, jout = jpos.permute_trace_np(states)
    assert adv.shape == (n, gp.NUM_ADVICE) and np.array_equal(adv, jadv)
    assert np.array_equal(out, jout)
    assert [int(v) for v in out[1]] == pos.permute_host([int(v) for v in states[1]])


# ---------------------------------------------------------------------------
# The same builder calls in both packages
# ---------------------------------------------------------------------------


def _two_to_one(pkg):
    b = pkg.new_builder()
    left, right = pkg.gs.add_virtual_hash256(b), pkg.gs.add_virtual_hash256(b)
    out = pkg.gs.two_to_one_sha256(b, left, right)
    expected = pkg.gs.add_virtual_hash256(b)
    pkg.gs.connect_hash256(b, out, expected)
    b.register_public_inputs(out)
    data = b.build()
    w = data.new_witness()
    lb, rb = b"\x11" * 32, b"\x22" * 32
    pkg.gs.set_hash256(w, left, lb)
    pkg.gs.set_hash256(w, right, rb)
    pkg.gs.set_hash256(w, expected, hashlib.sha256(lb + rb).digest())
    w.generate()
    return data, w


def _merkle_height_2(pkg):
    b = pkg.new_builder()
    tree = pkg.gm.add_virtual_merkle_tree_sha256(b, 2)
    expected = pkg.gs.add_virtual_hash256(b)
    pkg.gs.connect_hash256(b, expected, tree.root)
    b.register_public_inputs(tree.root)
    data = b.build()
    w = data.new_witness()
    rng = np.random.default_rng(7)
    leaves = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(4)]
    pkg.gm.set_partial_merkle_tree_sha256_target(w, leaves, tree)
    pkg.gs.set_hash256(w, expected, pkg.gm.merkle_root_sha256(leaves))
    w.generate()
    return data, w


def _poseidon_chain(pkg):
    b = pkg.new_builder()
    state_in = b.add_virtual_targets(12)
    out = pkg.gp.add_poseidon_permutations(b, [state_in])[0]
    out2 = pkg.gp.add_poseidon_permutations(b, [out])[0]
    b.register_public_inputs(out2[:4])
    data = b.build()
    w = data.new_witness()
    for t, v in zip(state_in, range(1, 13)):
        w.set(t, v)
    w.generate()
    return data, w


def _hash_no_pad(pkg):
    b = pkg.new_builder()
    inputs = b.add_virtual_targets(11)  # two chunks: 8 + 3
    b.register_public_inputs(pkg.gp.hash_no_pad_circuit(b, inputs))
    data = b.build()
    w = data.new_witness()
    for t, v in zip(inputs, range(21, 32)):
        w.set(t, v)
    w.generate()
    return data, w


def _compress(pkg):
    b = pkg.new_builder()
    left, right = b.add_virtual_targets(4), b.add_virtual_targets(4)
    b.register_public_inputs(pkg.gp.compress_circuit(b, left, right))
    data = b.build()
    w = data.new_witness()
    for t, v in zip(left + right, range(1, 9)):
        w.set(t, v)
    w.generate()
    return data, w


CIRCUITS = {"two_to_one": _two_to_one, "merkle_height_2": _merkle_height_2,
            "poseidon_chain": _poseidon_chain, "hash_no_pad": _hash_no_pad,
            "compress": _compress}
TABLES = ("selectors", "constants", "sigma", "rep", "k_shifts")


def _same_circuit(got, want):
    assert (got.log_n, got.num_rows_used, got.gate_names) == (
        want.log_n, want.num_rows_used, want.gate_names)
    for key in TABLES:
        assert np.array_equal(getattr(got, key), getattr(want, key)), key
    assert [tuple(t) for t in got.public_input_targets] == [
        tuple(t) for t in want.public_input_targets]
    assert [(g.name, g.num_constraints, g.degree, tuple(g.wire_offsets)) for g in got.gates] == [
        (g.name, g.num_constraints, g.degree, tuple(g.wire_offsets)) for g in want.gates]


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_builder_tables_and_witness_equal(name):
    jdata, jw = CIRCUITS[name](JAX)
    data, w = CIRCUITS[name](PORT)
    _same_circuit(data, jdata)
    assert np.array_equal(w.full_matrix(), jw.full_matrix())
    carried = convert.circuit_data_from_jax(jdata)
    _same_circuit(carried, data)
    assert [type(g) for g in carried.gates] == [type(g) for g in data.gates]
    assert pr.wire_offsets_used(data) == jpr.wire_offsets_used(jdata)
    assert pr.opening_point_specs(data) == jpr.opening_point_specs(jdata)


def test_sha_circuits_open_twelve_points():
    data, _ = _two_to_one(PORT)
    assert pr.wire_offsets_used(data) == [-16, -15, -7, -4, -3, -2, -1, 0]
    assert len(pr.opening_point_specs(data)) == 12
    assert max(g.num_constraints for g in data.gates) == 105  # 130 once a Poseidon row is in


def test_gate_from_spec_builds_both_gates():
    assert isinstance(gates.gate_from_spec({"type": "sha256"}), gsha.Sha256RoundGate)
    assert isinstance(gates.gate_from_spec({"type": "poseidon"}), gp.PoseidonGate)
    for g in (gsha.Sha256RoundGate(), gp.PoseidonGate()):
        assert gates.gate_from_spec(gates.gate_to_spec(g)).num_constraints == g.num_constraints
    with pytest.raises(ValueError):
        gates.gate_from_spec({"type": "sha3"})


def test_two_to_one_witness_is_sha256():
    data, w = _two_to_one(PORT)
    got = sha.bytes_from_words(np.array([w.get(t) for t in data.public_input_targets],
                                        dtype=np.uint32))
    assert got == hashlib.sha256(b"\x11" * 32 + b"\x22" * 32).digest()


def test_wrong_expected_root_fails_at_generation():
    b = PORT.new_builder()
    left, right = gs.add_virtual_hash256(b), gs.add_virtual_hash256(b)
    expected = gs.add_virtual_hash256(b)
    gs.connect_hash256(b, gs.two_to_one_sha256(b, left, right), expected)
    w = b.build().new_witness()
    gs.set_hash256(w, left, b"\x00" * 32)
    gs.set_hash256(w, right, b"\x00" * 32)
    gs.set_hash256(w, expected, b"\xff" * 32)
    with pytest.raises(ValueError):
        w.generate()


# ---------------------------------------------------------------------------
# eval and the alpha combination on random field words
# ---------------------------------------------------------------------------

N_LDE, RATE = 256, 3
EDGE = np.array([0, 1, P - 1, (1 << 32) - 1, 1 << 32], dtype=np.uint64)


def _gate_inputs(num_constraints, num_wires, seed, n_lde=N_LDE):
    """Random field words (not only bits), the edge words among them."""
    rng = np.random.default_rng(seed)
    wires = rng.integers(0, P, size=(num_wires, n_lde), dtype=np.uint64)
    wires[:, : len(EDGE)] = EDGE
    wires[::3, n_lde - len(EDGE):] = EDGE[::-1]
    consts = rng.integers(0, P, size=(4, n_lde), dtype=np.uint64)
    sel = rng.integers(0, P, size=(n_lde,), dtype=np.uint64)
    apow = [rng.integers(0, P, size=(num_constraints,), dtype=np.uint64) for _ in range(2)]
    accs = [rng.integers(0, P, size=(n_lde,), dtype=np.uint64) for _ in range(2)]
    return wires, consts, sel, apow, accs


def _port_closures(wires_u, consts_u, rate=RATE):
    wires_t, consts_t = gl.from_u64(wires_u), gl.from_u64(consts_u)
    return (wires_t, lambda col, offset=0: ntt.roll_lde(wires_t[col], offset, rate),
            lambda i: consts_t[i])


def _jax_closures(wires_u, consts_u, rate=RATE):
    wires_j, consts_j = jgl.from_u64(wires_u), jgl.from_u64(consts_u)
    return (lambda col, offset=0: jntt.roll_lde((wires_j[0][col], wires_j[1][col]), offset, rate),
            lambda i: (consts_j[0][i], consts_j[1][i]))


GATES = {"sha256": (gsha.Sha256RoundGate, jgsha.Sha256RoundGate, gsha.NUM_WIRES_REQUIRED),
         "poseidon": (gp.PoseidonGate, jgp.PoseidonGate, gp.NUM_WIRES_REQUIRED)}


@pytest.mark.parametrize("name", sorted(GATES))
def test_gate_eval_and_alpha_combination_equal_the_jax_packages(name):
    gate_cls, jgate_cls, num_wires = GATES[name]
    gate, jgate = gate_cls(), jgate_cls()
    nc = gate.num_constraints
    assert nc == jgate.num_constraints
    wires_u, consts_u, sel_u, apow_u, accs_u = _gate_inputs(nc, num_wires, 11)
    _, wires, consts = _port_closures(wires_u, consts_u)
    jwires, jconsts = _jax_closures(wires_u, consts_u)
    cons = gate.eval(algebra.DeviceBaseAlgebra((N_LDE,), "cpu"), wires, consts)
    jcons = jgate.eval(jalgebra.DeviceBaseAlgebra((N_LDE,)), jwires, jconsts)
    assert len(cons) == len(jcons) == nc
    for k in range(nc):
        assert np.array_equal(gl.to_u64(cons[k]), jgl.to_u64(jcons[k])), k
    # the JAX package's generic loop: one absorb per constraint
    jsel = jgl.from_u64(sel_u)
    want = []
    for j in range(2):
        acc = jgl.from_u64(accs_u[j])
        for k, cval in enumerate(jcons):
            p = jgl.from_u64(np.broadcast_to(apow_u[j][k], (N_LDE,)).copy())
            acc = jgl.add(acc, jgl.mul(p, jgl.mul(jsel, cval)))
        want.append(jgl.to_u64(acc))
    got = gates.absorb_quotient_generic(
        gate, algebra.DeviceBaseAlgebra((N_LDE,), "cpu"), wires, consts, gl.from_u64(sel_u),
        [gl.from_u64(a) for a in apow_u], [gl.from_u64(a) for a in accs_u])
    for j in range(2):
        assert np.array_equal(gl.to_u64(got[j]), want[j]), j


def test_gate_eval_on_the_host_algebra_equals_the_jax_packages():
    """The verifier's side: eval on GF(p^2) scalars."""
    rng = np.random.default_rng(5)
    vals = rng.integers(0, P, size=(9, 184, 2), dtype=np.uint64)
    offsets = {o: i for i, o in enumerate((0, -1, -2, -3, -4, -7, -15, -16))}
    wires = lambda col, offset=0: tuple(int(v) for v in vals[offsets[offset], col])  # noqa: E731
    consts = lambda i: tuple(int(v) for v in vals[8, i])  # noqa: E731
    for name, (gate_cls, jgate_cls, _) in GATES.items():
        got = gate_cls().eval(algebra.HostExtAlgebra(), wires, consts)
        assert got == jgate_cls().eval(jalgebra.HostExtAlgebra(), wires, consts), name


# ---------------------------------------------------------------------------
# The launch plan of csrc/gates.cu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0, 1, 3])
@pytest.mark.parametrize("n_lde", [128, 4096])
def test_neighbour_columns_is_roll_lde(n_lde, rate):
    arr = gl.from_u64(np.random.default_rng(n_lde + rate).integers(0, P, size=(n_lde,),
                                                                    dtype=np.uint64))
    for offset in gsha.Sha256RoundGate.wire_offsets + (1, 16):
        cols = kernels.neighbour_columns(n_lde, offset, rate)
        assert cols.min() >= 0 and cols.max() < n_lde
        assert torch.equal(arr[cols], ntt.roll_lde(arr, offset, rate)), offset
    # offset -16 at rate 3 wraps around the start of the domain
    assert int(kernels.neighbour_columns(n_lde, -16, 3)[0]) == n_lde - 128


def _plan_args(nch=2, n_lde=64, num_wires=8, nc=5):
    wires = torch.zeros((num_wires, n_lde), dtype=torch.int64)
    rows = {"sel": torch.zeros(n_lde, dtype=torch.int64)}
    apow = [torch.zeros(nc, dtype=torch.int64) for _ in range(nch)]
    accs = [torch.zeros(n_lde, dtype=torch.int64) for _ in range(nch)]
    return wires, rows, apow, accs, nc


@pytest.mark.parametrize("form", ["dense", "row-sliced wires", "alpha rows of a power table"])
def test_gate_quotient_plan_gives_columns_and_row_stride(form):
    wires, rows, apow, accs, nc = _plan_args()
    want = (64, 64)
    if form == "row-sliced wires":  # a view of a wider array keeps its row stride
        wires, want = torch.zeros((8, 128), dtype=torch.int64)[:, :64], (64, 128)
    elif form == "alpha rows of a power table":  # slices of one table, as prove() passes them
        table = torch.zeros(nc + 7, dtype=torch.int64)
        apow = [table[3 : 3 + nc]] * 2
    assert kernels.gate_quotient_plan(wires, rows, apow, accs, nc) == want


@pytest.mark.parametrize("nch", [1, 3])
def test_gate_quotient_plan_takes_the_provers_two_challenges_only(nch):
    assert kernels.GATES_CHALLENGES == config.CircuitConfig().num_challenges == 2
    wires, rows, apow, accs, nc = _plan_args(nch)
    with pytest.raises(ValueError, match="2 challenges"):
        kernels.gate_quotient_plan(wires, rows, apow, accs, nc)


@pytest.mark.parametrize("case", ["columns not a power of two", "strided columns",
                                  "strided selector", "short alpha row", "wrong dtype",
                                  "counts differ", "2-D accumulator"])
def test_gate_quotient_plan_refuses(case):
    wires, rows, apow, accs, nc = _plan_args()
    if case == "columns not a power of two":
        wires = wires[:, :48]
        rows = {"sel": rows["sel"][:48]}
        accs = [a[:48] for a in accs]
    elif case == "strided columns":
        wires = torch.zeros((8, 128), dtype=torch.int64)[:, ::2]
    elif case == "strided selector":
        rows = {"sel": torch.zeros(128, dtype=torch.int64)[::2]}
    elif case == "short alpha row":
        apow = [a[:-1] for a in apow]
    elif case == "wrong dtype":
        accs = [a.to(torch.int32) for a in accs]
    elif case == "counts differ":
        apow = apow[:1]
    elif case == "2-D accumulator":
        accs = [a[None] for a in accs]
    with pytest.raises(ValueError):
        kernels.gate_quotient_plan(wires, rows, apow, accs, nc)


def test_gate_kernels_raise_on_a_cpu_tensor():
    """A wrapper launches its kernel or raises; it never computes on the CPU."""
    wires_u, consts_u, sel_u, apow_u, accs_u = _gate_inputs(105, 184, 3, n_lde=128)
    wires_t, _, consts = _port_closures(wires_u, consts_u)
    args = (wires_t, consts, gl.from_u64(sel_u), [gl.from_u64(a) for a in apow_u],
            [gl.from_u64(a) for a in accs_u], RATE)
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        gsha.Sha256RoundGate().absorb_quotient_device(*args)
    with pytest.raises(ValueError):
        gp.PoseidonGate().absorb_quotient_device(
            args[0], consts, args[2], [a.repeat(2)[:130] for a in args[3]], args[4], RATE)
    assert kernels.launches == before


def test_constraint_index_layout_mirrors_eval():
    """Singles 0-5, booleanity 6-101, carries 102-104, as csrc/gates.cu has them."""
    n = 16
    wires_u, consts_u, *_ = _gate_inputs(105, 184, 2, n_lde=n)
    _, wires, consts = _port_closures(wires_u, consts_u, rate=0)
    cons = gsha.Sha256RoundGate().eval(algebra.DeviceBaseAlgebra((n,), "cpu"), wires, consts)
    assert len(cons) == gsha.NUM_CONSTRAINTS == 105
    m_round, m_sched, m_bits = (consts(i) for i in (gsha.CONST_ROUND, gsha.CONST_SCHED,
                                                    gsha.CONST_BITS))
    for g, (first, word_col) in enumerate(((gsha.A_BITS, gsha.COL_WA), (gsha.E_BITS, gsha.COL_WE),
                                           (gsha.W_BITS, gsha.COL_WW))):
        word = gl.zeros((n,), "cpu")
        for i in range(32):
            b = wires(first + i)
            word = gl.add(word, gl.mul(b, gl.full((n,), 1 << i, "cpu")))
            want = gl.mul(m_bits, gl.sub(gl.mul(b, b), b))
            assert torch.equal(cons[gsha.K_BOOL + 32 * g + i], want), (g, i)
        assert torch.equal(cons[gsha.K_WORD + g], gl.mul(m_bits, gl.sub(wires(word_col), word))), g
    for k, (col, hi, mask) in enumerate(((gsha.CARRY_A, 6, m_round), (gsha.CARRY_E, 6, m_round),
                                         (gsha.CARRY_W, 3, m_sched))):
        c = wires(col)
        prod = c
        for v in range(1, hi + 1):
            prod = gl.mul(prod, gl.sub(c, gl.full((n,), v, "cpu")))
        assert torch.equal(cons[gsha.K_CARRY + k], gl.mul(mask, prod)), k
    assert (gsha.K_ROUND_E, gsha.K_ROUND_A, gsha.K_SCHED) == (0, 1, 2)


def test_kernel_source_holds_the_modules_constants():
    with open(os.path.join(REPO, "eth_lc_plonky2_tpu_torch", "csrc", "gates.cu")) as f:
        source = f.read()
    found = {m.group(1): int(m.group(2))
             for m in re.finditer(r"constexpr int (\w+) = (\d+);", source)}
    want = {"K_ROUND_E": gsha.K_ROUND_E, "K_ROUND_A": gsha.K_ROUND_A, "K_SCHED": gsha.K_SCHED,
            "K_WORD": gsha.K_WORD, "K_BOOL": gsha.K_BOOL, "K_CARRY": gsha.K_CARRY,
            "SHA_CONSTRAINTS": gsha.NUM_CONSTRAINTS, "NCH": kernels.GATES_CHALLENGES,
            "WIDTH": pos.WIDTH,
            "HALF_FULL": pos.N_FULL_ROUNDS // 2, "PARTIAL": pos.N_PARTIAL_ROUNDS}
    assert {k: found.get(k) for k in want} == want
    assert gp.PoseidonGate().num_constraints == gp.NUM_ADVICE + pos.WIDTH == 130
    table = gl.to_u64(gp.kernel_table("cpu"))
    assert table.shape == (30 * 12 + 12 + 1,)
    assert np.array_equal(table[:360], pos.round_constants())
    assert list(table[360:]) == pos.MDS_CIRC + [pos.MDS_DIAG[0]]
    assert sum(pos.MDS_CIRC) + pos.MDS_DIAG[0] < 1 << 9  # the kernel's wide sums stay below 2^44
    assert "gates.cu" in kernels.SOURCES and kernels.launches["gates"] == 0


# ---------------------------------------------------------------------------
# Whole proofs of the Poseidon circuits (the SHA-256 ones: test_torch_verify.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["poseidon_chain", "hash_no_pad", "compress"])
def test_poseidon_circuit_proofs_equal_the_jax_packages(name):
    jdata, jw = CIRCUITS[name](JAX)
    data, w = CIRCUITS[name](PORT)
    jpd, jvk = jpr.preprocess(jdata)
    pd, vk = pr.preprocess(data, device="cpu")
    assert np.array_equal(vk.pre_cap, jvk.pre_cap)
    jproof = jpr.prove(jpd, jw)
    before = dict(kernels.launches)
    proof = pr.prove(pd, w)
    assert kernels.launches == before  # a CPU tensor never reaches a kernel
    got = chip_smoke.proof_dict(proof)
    assert chip_smoke.first_difference(
        got, jserialize.proof_to_dict(jproof, include_indices=True)) is None
    want_pi = {"poseidon_chain": pos.permute_host(pos.permute_host(list(range(1, 13))))[:4],
               "hash_no_pad": pos.hash_no_pad_host(list(range(21, 32))),
               "compress": pos.compress_host([1, 2, 3, 4], [5, 6, 7, 8])}[name]
    assert [int(v) for v in proof.public_inputs] == want_pi
    verify(data, vk, proof)
    jverify(jdata, jvk, convert.proof_to_jax(proof))
    verify(convert.circuit_data_from_jax(jdata), vk, convert.proof_from_jax(jproof))
