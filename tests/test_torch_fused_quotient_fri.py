"""The generic gates' share of the quotient (``generic_gate_quotient_kernel``
of ``csrc/gates.cu``), FRI's G (``fri_g_kernel``) and FRI's fold
(``fri_fold_kernel``) of ``csrc/field.cu``, on the CPU.

A CUDA kernel cannot run here, so this file holds the plain versions against
the JAX package (numpy backend) on the same seeded inputs, exactly, walks
each kernel's per-column algorithm in Python (host integers, the launch
plan's parameters, the kernel's order of visits and sums) against the plain
versions, and tests the plans.  ``tests/test_torch_cuda.py`` holds the
kernels against the plain versions on the card."""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from eth_lc_plonky2_tpu.circuit import algebra as jalgebra
from eth_lc_plonky2_tpu.circuit import gates as jgates
from eth_lc_plonky2_tpu.circuit import gates_poseidon as jgp
from eth_lc_plonky2_tpu.circuit import gates_sha256 as jgsha
from eth_lc_plonky2_tpu.ops import goldilocks as jgl
from eth_lc_plonky2_tpu.prover import fri as jfri
from eth_lc_plonky2_tpu_torch.circuit import algebra
from eth_lc_plonky2_tpu_torch.circuit import gates
from eth_lc_plonky2_tpu_torch.circuit import gates_poseidon as gp
from eth_lc_plonky2_tpu_torch.circuit import gates_sha256 as gsha
from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.ops import kernels
from eth_lc_plonky2_tpu_torch.prover import fri
from eth_lc_plonky2_tpu_torch.prover import prove as pr

torch.set_num_threads(1)

P = gl.P
EDGE = np.array([0, 1, P - 1, 1 << 32, 1 << 63], dtype=np.uint64)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _same(torch_field, jax_field):
    return np.array_equal(gl.to_u64(torch_field), jgl.to_u64(jax_field))


def _with_edges(a):
    """The edge words in the first columns of every row, and in the last
    columns of every other row."""
    a = a.copy()
    k = min(a.shape[-1], len(EDGE))
    a[..., :k] = EDGE[:k]
    if a.ndim == 2:
        a[1::2, a.shape[1] - k:] = EDGE[::-1][:k]
    return a


# ---------------------------------------------------------------------------
# The generic gates and the public inputs
# ---------------------------------------------------------------------------

# (port gates, JAX gates) in the order of a circuit's selectors
GATE_SETS = {
    # phase 6 (chip_smoke.flagship_circuit): arith 20 ops, basesum2, const 6, noop
    "phase 6": ([gates.ArithmeticGate(20), gates.BaseSum2Gate(), gates.ConstantGate(6),
                 gates.NoopGate()],
                [jgates.ArithmeticGate(20), jgates.BaseSum2Gate(), jgates.ConstantGate(6),
                 jgates.NoopGate()]),
    # phase 7 (the light-client circuit CircuitBuilder makes): the same generic gates,
    # and the Poseidon and SHA-256 gates, which the generic kernel leaves out
    "phase 7": ([gates.ArithmeticGate(20), gates.BaseSum2Gate(), gates.ConstantGate(6),
                 gates.NoopGate(), gp.PoseidonGate(), gsha.Sha256RoundGate()],
                [jgates.ArithmeticGate(20), jgates.BaseSum2Gate(), jgates.ConstantGate(6),
                 jgates.NoopGate(), jgp.PoseidonGate(), jgsha.Sha256RoundGate()]),
    # other widths: the dryrun circuit's arith 4 and const 2, fewer bits a slot
    "narrow": ([gates.ArithmeticGate(4), gates.BaseSum2Gate(num_bits=7, num_slots=3),
                gates.ConstantGate(2), gates.NoopGate()],
               [jgates.ArithmeticGate(4), jgates.BaseSum2Gate(num_bits=7, num_slots=3),
                jgates.ConstantGate(2), jgates.NoopGate()]),
}
NUM_WIRES, NUM_CONSTANTS, NUM_PI = 184, 6, 12
M = 10  # permutation chunks: the public inputs' powers start at 1 + M


def _generic_inputs(gate_set: str, n_lde: int, seed: int, broken_arith: bool = False):
    """Seeded words for one quotient's generic share, with the edge words:
    wires (184, n_lde); the preprocessed rows (selectors, then 6 constant
    rows, then 4 more rows); 12 Lagrange rows and public inputs at seeded
    columns; two alpha rows; two accumulators.  With ``broken_arith`` the
    arith wires satisfy every op but one (op 7 at column 3)."""
    port_gates, _ = GATE_SETS[gate_set]
    num_sel = len(port_gates)
    rng = np.random.default_rng(seed)
    wires = _with_edges(rng.integers(0, P, size=(NUM_WIRES, n_lde), dtype=np.uint64))
    pre = _with_edges(rng.integers(0, P, size=(num_sel + NUM_CONSTANTS + 4, n_lde),
                                   dtype=np.uint64))
    if broken_arith:
        ops = port_gates[0].num_ops
        c0, c1 = (pre[num_sel + i].astype(object) for i in range(2))
        for i in range(ops):
            a, b, c = (wires[4 * i + r].astype(object) for r in range(3))
            wires[4 * i + 3] = np.array((c0 * a * b + c1 * c) % P, dtype=np.uint64)
        wires[4 * 7 + 3, 3] = (int(wires[4 * 7 + 3, 3]) + 1) % P
    lr = _with_edges(rng.integers(0, P, size=(NUM_PI, n_lde), dtype=np.uint64))
    pi = rng.integers(0, P, size=NUM_PI, dtype=np.uint64)
    pi[:len(EDGE)] = EDGE
    pi_cols = rng.integers(0, NUM_WIRES, size=NUM_PI)
    pi_cols[0] = pi_cols[1]  # two public inputs in one column
    max_con = max(g.num_constraints for g in port_gates)
    apows = rng.integers(0, P, size=(2, 1 + M + NUM_PI + max_con), dtype=np.uint64)
    apows[:, -len(EDGE):] = EDGE
    accs = _with_edges(rng.integers(0, P, size=(2, n_lde), dtype=np.uint64))
    return dict(wires=wires, pre=pre, num_sel=num_sel, lr=lr, pi=pi, pi_cols=pi_cols,
                apows=apows, accs=accs, pi0=1 + M, k0=1 + M + NUM_PI)


def _port_plain(gate_set: str, inp) -> list:
    port_gates, _ = GATE_SETS[gate_set]
    n_lde = inp["wires"].shape[1]
    wires_t, pre_t = gl.from_u64(inp["wires"]), gl.from_u64(inp["pre"])
    return pr.generic_quotient_terms_plain(
        pr.split_gates(SimpleNamespace(gates=port_gates))[0],
        algebra.DeviceBaseAlgebra((n_lde,), "cpu"), lambda col, offset=0: wires_t[col],
        lambda i: pre_t[inp["num_sel"] + i], pre_t, gl.from_u64(inp["lr"]), gl.from_u64(inp["pi"]),
        [int(c) for c in inp["pi_cols"]], [gl.from_u64(a) for a in inp["apows"]],
        [gl.from_u64(a) for a in inp["accs"]], inp["pi0"], inp["k0"])


def _jax_generic_loop(gate_set: str, inp) -> list:
    """The JAX package's quotient loop (eth_lc_plonky2_tpu/prover/prove.py:484-520)
    over the public inputs and the generic gates, on its own gates and field
    ops: one absorb a term."""
    _, jax_gates = GATE_SETS[gate_set]
    n_lde = inp["wires"].shape[1]
    jA = jalgebra.DeviceBaseAlgebra((n_lde,))
    jwires = lambda col, offset=0: jgl.from_u64(inp["wires"][col])  # noqa: E731
    jconsts = lambda i: jgl.from_u64(inp["pre"][inp["num_sel"] + i])  # noqa: E731
    accs = [jgl.from_u64(a) for a in inp["accs"]]

    def absorb(j, idx, t):
        p = jgl.from_u64(np.full(n_lde, inp["apows"][j][idx], dtype=np.uint64))
        accs[j] = jgl.add(accs[j], jgl.mul(p, t))

    for i, col in enumerate(inp["pi_cols"]):
        piv = jgl.from_u64(np.full(n_lde, inp["pi"][i], dtype=np.uint64))
        t = jgl.mul(jgl.from_u64(inp["lr"][i]), jgl.sub(jwires(int(col)), piv))
        for j in range(2):
            absorb(j, inp["pi0"] + i, t)
    generic = {gi for gi, _ in pr.split_gates(SimpleNamespace(gates=GATE_SETS[gate_set][0]))[0]}
    for gi, g in enumerate(jax_gates):
        if gi not in generic:
            continue
        s = jgl.from_u64(inp["pre"][gi])
        for k, cval in enumerate(g.eval(jA, jwires, jconsts)):
            sc = jgl.mul(s, cval)
            for j in range(2):
                absorb(j, inp["k0"] + k, sc)
    return accs


@pytest.mark.parametrize("n_lde", [1 << 7, 1 << 10])
@pytest.mark.parametrize("gate_set", sorted(GATE_SETS))
def test_generic_quotient_plain_equals_the_jax_packages(gate_set, n_lde):
    inp = _generic_inputs(gate_set, n_lde, n_lde + len(gate_set))
    got = _port_plain(gate_set, inp)
    want = _jax_generic_loop(gate_set, inp)
    assert len(got) == 2 and all(_same(g, w) for g, w in zip(got, want))


def test_generic_quotient_plain_with_one_broken_arith_constraint():
    """Arith wires that satisfy every op but one: the arith gate's share is
    zero but in that column, and both packages give the same words."""
    inp = _generic_inputs("phase 6", 1 << 7, 5, broken_arith=True)
    got = _port_plain("phase 6", inp)
    assert all(_same(g, w) for g, w in zip(got, _jax_generic_loop("phase 6", inp)))
    # without the arith gate's selector the result changes in column 3 only
    inp_off = dict(inp, pre=inp["pre"].copy())
    inp_off["pre"][0] = 0
    off = _port_plain("phase 6", inp_off)
    for g, o in zip(got, off):
        diff = np.flatnonzero(gl.to_u64(g) != gl.to_u64(o))
        assert diff.tolist() == [3]


def test_generic_quotient_plain_skips_the_gates_with_their_own_kernels():
    inp = _generic_inputs("phase 7", 1 << 7, 9)
    got = _port_plain("phase 7", inp)
    only_generic = _port_plain("phase 6", dict(inp, pre=np.delete(inp["pre"], [4, 5], axis=0),
                                               num_sel=4))
    assert all(torch.equal(g, o) for g, o in zip(got, only_generic))


def _emulate_generic_kernel(plan, inp, x: int, reads: list | None = None) -> list:
    """generic_gate_quotient_kernel for column x, as csrc/gates.cu computes
    it, on host integers: the shared alpha layout, the public inputs, the one
    pass over the wire columns with each word given to every gate that reads
    it, the selectors, and acc_j + total_j.  ``reads`` collects the wire
    columns the pass loads, in order."""
    num_pi, slots, num_sel = plan["num_pi"], plan["slots"], inp["num_sel"]
    per = num_pi + slots
    alpha = [[int(inp["apows"][j][inp["pi0"] + t]) if t < num_pi
              else int(inp["apows"][j][inp["k0"] + t - num_pi]) for t in range(per)]
             for j in range(2)]
    ak = [row[num_pi:] for row in alpha]
    w_at = lambda w: int(inp["wires"][w, x])  # noqa: E731
    total = [0, 0]
    for i in range(num_pi):
        t = int(inp["lr"][i, x]) * (w_at(int(inp["pi_cols"][i])) - int(inp["pi"][i])) % P
        for j in range(2):
            total[j] = (total[j] + alpha[j][i] * t) % P
    consts = lambda i: int(inp["pre"][num_sel + i, x])  # noqa: E731
    c0, c1 = consts(0), consts(1)
    arith, bs, cst = [0, 0], [0, 0], [0, 0]
    a = ab = c = value = bits = 0
    slot = r = 0
    nb = plan["bs_bits"]
    for w in range(plan["visit"]):
        v = w_at(w)
        if reads is not None:
            reads.append(w)
        if w < 4 * plan["arith_ops"]:
            role = w & 3
            if role == 0:
                a = v
            elif role == 1:
                ab = a * v % P
            elif role == 2:
                c = v
            else:
                con = (c0 * ab + c1 * c - v) % P
                for j in range(2):
                    arith[j] += ak[j][w >> 2] * con
        if w < kernels.GEN_BS_STRIDE * plan["bs_slots"]:
            first = slot * (1 + nb)
            if r == 0:
                value, bits = v, 0
            elif r <= nb:
                bits += v << (r - 1)
                for j in range(2):
                    bs[j] += ak[j][first + r] * (v * v - v)
            if r == nb:
                for j in range(2):
                    bs[j] += ak[j][first] * (bits - value)
            r += 1
            if r == kernels.GEN_BS_STRIDE:
                r, slot = 0, slot + 1
        if w < plan["const_slots"]:
            cw = c0 if w == 0 else c1 if w == 1 else consts(w)
            for j in range(2):
                cst[j] += ak[j][w] * (v - cw)
    out = []
    for j in range(2):
        for name, s in (("arith", arith[j]), ("basesum2", bs[j]), ("const", cst[j])):
            if name in plan["sel"]:
                total[j] += int(inp["pre"][plan["sel"][name], x]) * s
        out.append((int(inp["accs"][j][x]) + total[j]) % P)
    return out


def _plan_for(gate_set: str, inp):
    port_gates, _ = GATE_SETS[gate_set]
    data = SimpleNamespace(gates=port_gates)
    t = gl.from_u64
    return kernels.generic_gate_plan(
        pr.split_gates(data)[0], t(inp["wires"]), t(inp["pre"]), inp["num_sel"], NUM_CONSTANTS,
        t(inp["lr"]), t(inp["pi"]), torch.from_numpy(inp["pi_cols"].astype(np.int64)),
        [t(a) for a in inp["apows"]], [t(a) for a in inp["accs"]], inp["pi0"], inp["k0"])


@pytest.mark.parametrize("gate_set", sorted(GATE_SETS))
def test_generic_kernel_walk_equals_the_plain_version(gate_set):
    """The kernel's per-column algorithm under the plan's parameters (which
    wire goes to which constraint slot, in eval()'s order) gives the plain
    version's words, on edge columns and seeded ones."""
    inp = _generic_inputs(gate_set, 1 << 7, 17)
    plan = _plan_for(gate_set, inp)
    got = _port_plain(gate_set, inp)
    for x in (0, 1, 2, 3, 4, 77, 127):
        want = [int(gl.to_u64(got[j])[x]) for j in range(2)]
        reads = []
        assert _emulate_generic_kernel(plan, inp, x, reads) == want, x
        # each wire column any generic gate reads is loaded once, in order
        port_gates = [g for _, g in pr.split_gates(SimpleNamespace(gates=GATE_SETS[gate_set][0]))[0]]
        read_by_gates = set()
        for g in port_gates:
            A = algebra.DeviceBaseAlgebra((1,), "cpu")
            g.eval(A, lambda col, offset=0, seen=read_by_gates: seen.add(col) or gl.zeros((1,), "cpu"),
                   lambda i: gl.zeros((1,), "cpu"))
        assert reads == list(range(plan["visit"])) and read_by_gates <= set(reads)


def test_generic_plan_at_the_main_paths_shapes():
    """Phase 6's and 7's generic gates: 80 wire columns visited (arith's 20
    ops), 66 constraint slots (basesum2's two slots of 33), 12 public inputs;
    the selectors are the gates' rows; shared memory for 2 x 78 powers and 12
    words."""
    for gate_set in ("phase 6", "phase 7"):
        inp = _generic_inputs(gate_set, 1 << 7, 3)
        plan = _plan_for(gate_set, inp)
        assert {k: plan[k] for k in ("arith_ops", "bs_bits", "bs_slots", "const_slots", "visit",
                                     "slots", "num_pi", "wires_stride", "consts_stride")} == {
            "arith_ops": 20, "bs_bits": 32, "bs_slots": 2, "const_slots": 6, "visit": 80,
            "slots": 66, "num_pi": 12, "wires_stride": 128, "consts_stride": 128}
        assert plan["sel"] == {"arith": 0, "basesum2": 1, "const": 2}
        assert plan["shared_bytes"] == (2 * (12 + 66) + 12) * 8


GENERIC_FAULTS = ["two arith gates", "unknown gate", "too many bits", "too many constraints",
                  "short alpha row", "one challenge", "strided accumulator", "lr rows",
                  "selector out of range", "too few constants"]


@pytest.mark.parametrize("fault", GENERIC_FAULTS)
def test_generic_plan_refuses(fault):
    inp = _generic_inputs("phase 6", 1 << 7, 4)
    t = gl.from_u64
    gates_list = pr.split_gates(SimpleNamespace(gates=GATE_SETS["phase 6"][0]))[0]
    args = dict(gates=gates_list, wires_lde=t(inp["wires"]), pre_lde=t(inp["pre"]), num_sel=4,
                num_constants=NUM_CONSTANTS, lr=t(inp["lr"]), pi_f=t(inp["pi"]),
                pi_cols=torch.from_numpy(inp["pi_cols"].astype(np.int64)),
                apows=[t(a) for a in inp["apows"]], accs=[t(a) for a in inp["accs"]],
                pi0=inp["pi0"], k0=inp["k0"])
    if fault == "two arith gates":
        args["gates"] = gates_list + [(3, gates.ArithmeticGate(2))]
    elif fault == "unknown gate":
        args["gates"] = gates_list + [(3, gp.PoseidonGate())]
    elif fault == "too many bits":
        args["gates"] = [(1, gates.BaseSum2Gate(num_bits=33, num_slots=1))]
    elif fault == "too many constraints":
        args["gates"] = [(1, gates.BaseSum2Gate(num_bits=32, num_slots=8))]
        args["wires_lde"] = t(_rand((300, 1 << 7), 1))
    elif fault == "short alpha row":
        args["apows"] = [a[: inp["k0"] + 10] for a in args["apows"]]
    elif fault == "one challenge":
        args["apows"], args["accs"] = args["apows"][:1], args["accs"][:1]
    elif fault == "strided accumulator":
        args["accs"] = [t(_rand((2 << 7,), 2))[::2], args["accs"][1]]
    elif fault == "lr rows":
        args["lr"] = args["lr"][:-1]
    elif fault == "selector out of range":
        args["num_sel"] = 2
    elif fault == "too few constants":
        args["num_constants"] = 1
    with pytest.raises(ValueError):
        kernels.generic_gate_plan(**args)


# ---------------------------------------------------------------------------
# FRI's G
# ---------------------------------------------------------------------------

COUNTS_7 = {"P": 92, "W": 184, "Z": 20, "Q": 16}  # phase 7's batches
SPECS = {5: ("P", "W", "Z", "Z", "Q"),
         12: ("P",) + ("W",) * 8 + ("Z", "Z", "Q")}


def _fake_pd(log_n: int, rate_bits: int = 3):
    """What make_g_kernel reads of a ProverData, for both packages."""
    cfg = SimpleNamespace(rate_bits=rate_bits)
    return SimpleNamespace(data=SimpleNamespace(n=1 << log_n, log_n=log_n, config=cfg),
                           device="cpu")


def _g_inputs(log_n: int, counts: dict, num_specs: int, seed: int, zero_norm_at=None):
    """Seeded LDE rows, weights, values and points (edge words among them);
    with ``zero_norm_at`` spec 1's point is the coset's point at that column,
    whose norm is then 0."""
    n_lde = 8 << log_n
    ldes = [_with_edges(_rand((counts[t], n_lde), seed + i)) for i, t in enumerate(fri.TAGS)]
    total = sum(counts.values())
    apow = [_with_edges(_rand((total + num_specs,), seed + 10 + k)) for k in range(2)]
    y = [_rand((num_specs,), seed + 20 + k) for k in range(2)]
    z = [_rand((num_specs,), seed + 30 + k) for k in range(2)]
    z[0][0], z[1][0] = P - 1, 1 << 63
    if zero_norm_at is not None:
        z[0][1] = fri._lde_x(log_n, 3)[zero_norm_at]
        z[1][1] = 0
    return ldes, apow, y, z


def _port_g(log_n, counts, tags, inp):
    ldes, apow, y, z = inp
    t = lambda pair: tuple(gl.from_u64(a) for a in pair)  # noqa: E731
    return fri.make_g_kernel(_fake_pd(log_n), counts, len(tags), tags)(
        tuple(gl.from_u64(a) for a in ldes), t(apow), t(y), t(z))


@pytest.mark.parametrize("zero_norm", [False, True])
@pytest.mark.parametrize("num_specs", sorted(SPECS))
def test_g_plain_equals_the_jax_packages(num_specs, zero_norm):
    log_n = 4
    tags = SPECS[num_specs]
    inp = _g_inputs(log_n, COUNTS_7, num_specs, num_specs, zero_norm_at=5 if zero_norm else None)
    got = _port_g(log_n, COUNTS_7, tags, inp)
    ldes, apow, y, z = inp
    j = lambda pair: tuple(jgl.from_u64(a) for a in pair)  # noqa: E731
    want = jfri.make_g_kernel(_fake_pd(log_n), COUNTS_7, num_specs, tags)(
        tuple(jgl.from_u64(a) for a in ldes), j(apow), j(y), j(z))
    assert got[0].shape == (8 << log_n,)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


def _ext_mul(a, b):
    return ((a[0] * b[0] + 7 * a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def _emulate_g_kernel(plan, inp, x_u64, x: int) -> tuple:
    """fri_g_kernel for column x, as csrc/field.cu computes it, on host
    integers: the four sums, then the specs' norms inverted together by
    Montgomery's trick (a zero norm skipped), and the weighted sum from the
    last spec to the first."""
    ldes, apow, y, z = inp
    total = plan["total"]
    b = []
    for t in range(kernels.G_TAGS):
        rows = range(plan["offsets"][t], plan["offsets"][t] + plan["rows"][t])
        col = ldes[t][:, x].astype(object)
        b.append((sum(int(apow[0][r]) * int(v) for r, v in zip(rows, col)) % P,
                  sum(int(apow[1][r]) * int(v) for r, v in zip(rows, col)) % P))
    xv = int(x_u64[x])
    specs = plan["specs"]
    norm = [((xv - int(z[0][j])) ** 2 - 7 * int(z[1][j]) ** 2) % P for j in range(specs)]
    prefix, run = [], 1
    for j in range(specs):
        prefix.append(run)
        if norm[j]:
            run = run * norm[j] % P
    inv = pow(run, P - 2, P)
    g = (0, 0)
    for j in reversed(range(specs)):
        ninv = 0
        if norm[j]:
            ninv, inv = inv * prefix[j] % P, inv * norm[j] % P
        den = ((xv - int(z[0][j])) * ninv % P, int(z[1][j]) * ninv % P)
        bt = b[plan["spec_tag"][j]]
        q = _ext_mul(((bt[0] - int(y[0][j])) % P, (bt[1] - int(y[1][j])) % P), den)
        q = _ext_mul(q, (int(apow[0][total + j]), int(apow[1][total + j])))
        g = ((g[0] + q[0]) % P, (g[1] + q[1]) % P)
    return g


@pytest.mark.parametrize("num_specs", sorted(SPECS))
def test_g_kernel_walk_equals_the_plain_version(num_specs):
    log_n = 3
    tags = SPECS[num_specs]
    inp = _g_inputs(log_n, COUNTS_7, num_specs, 40 + num_specs, zero_norm_at=6)
    got = _port_g(log_n, COUNTS_7, tags, inp)
    ldes, apow, y, z = inp
    x_u64 = fri._lde_x(log_n, 3)
    t = gl.from_u64
    plan = kernels.fri_g_plan([t(a) for a in ldes], (t(apow[0]), t(apow[1])), (t(y[0]), t(y[1])),
                              (t(z[0]), t(z[1])), t(x_u64),
                              tuple(fri.TAGS.index(tag) for tag in tags))
    assert plan["offsets"] == [0, 92, 276, 296] and plan["total"] == 312
    for x in (0, 5, 6, 63):
        want = (int(gl.to_u64(got[0])[x]), int(gl.to_u64(got[1])[x]))
        assert _emulate_g_kernel(plan, inp, x_u64, x) == want, x


def test_batch_inversion_order_skips_zero_norms():
    """Montgomery's trick in the kernel's order: each non-zero norm gets its
    inverse, each zero norm 0, whatever their places."""
    rng = np.random.default_rng(3)
    for zeros in ([], [0], [5], [11], [0, 3, 11], list(range(12))):
        norms = [int(v) for v in rng.integers(1, P, size=12, dtype=np.uint64)]
        for k in zeros:
            norms[k] = 0
        prefix, run = [], 1
        for v in norms:
            prefix.append(run)
            run = run * v % P if v else run
        inv, out = pow(run, P - 2, P), [0] * 12
        for j in reversed(range(12)):
            if norms[j]:
                out[j], inv = inv * prefix[j] % P, inv * norms[j] % P
        assert out == [pow(v, P - 2, P) if v else 0 for v in norms]


G_FAULTS = ["three batches", "too many specs", "too many rows", "strided rows", "short apow",
            "unknown batch", "int32 x"]


@pytest.mark.parametrize("fault", G_FAULTS)
def test_fri_g_plan_refuses(fault):
    t = gl.from_u64
    ldes = [t(_rand((c, 64), i)) for i, c in enumerate((3, 5, 2, 2))]
    total = 12
    tags = (0, 1, 2)
    apow = (t(_rand((total + 3,), 7)), t(_rand((total + 3,), 8)))
    y = z = (t(_rand((3,), 9)), t(_rand((3,), 10)))
    x = t(_rand((64,), 11))
    if fault == "three batches":
        ldes = ldes[:3]
    elif fault == "too many specs":
        tags = (0,) * (kernels.G_MAX_SPECS + 1)
    elif fault == "too many rows":
        ldes[1] = gl.zeros((kernels.G_MAX_ROWS, 64), "cpu")
    elif fault == "strided rows":
        ldes[2] = t(_rand((2, 128), 3))[:, ::2]
    elif fault == "short apow":
        apow = (apow[0][:-1], apow[1][:-1])
    elif fault == "unknown batch":
        tags = (0, 1, kernels.G_TAGS)
    elif fault == "int32 x":
        x = x.to(torch.int32)
    with pytest.raises(ValueError):
        kernels.fri_g_plan(ldes, apow, y, z, x, tags)


# ---------------------------------------------------------------------------
# FRI's fold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_size", [1, 2, 5, 9])
def test_fold_plain_equals_the_jax_packages(log_size):
    """The fold with its half inverse points (the table of w^-i times
    1 / (2 shift)) against the JAX package's _fold_core fed the same points."""
    size = 1 << log_size
    h = size // 2
    re, im = _with_edges(_rand((size,), 50)), _with_edges(_rand((size,), 51))
    shift = pow(7, 1 << 3, P)  # the coset of a later layer
    w = gl.primitive_root_of_unity(log_size)
    w_inv = np.array([pow(w, -i, P) for i in range(h)], dtype=np.uint64)
    scale = fri.INV2 * gl.h_inv(shift) % P
    beta = (P - 1, int(_rand((), 52)))
    got = fri.fold_plain(gl.from_u64(re), gl.from_u64(im), gl.from_u64(w_inv), scale,
                         (pr.scalar_f(beta[0], "cpu"), pr.scalar_f(beta[1], "cpu")))
    hx = np.array([int(v) * scale % P for v in w_inv], dtype=np.uint64)
    want = jfri._fold_core(jgl.from_u64(re), jgl.from_u64(im), jgl.from_u64(hx),
                           jgl.full((h,), fri.INV2),
                           (jgl.from_u64(np.uint64(beta[0])), jgl.from_u64(np.uint64(beta[1]))))
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    # fold_layer takes its plain version for CPU tensors, and launches nothing
    before = dict(kernels.launches)
    again = fri.fold_layer(gl.from_u64(re), gl.from_u64(im), gl.from_u64(w_inv), scale,
                           (pr.scalar_f(beta[0], "cpu"), pr.scalar_f(beta[1], "cpu")))
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    assert kernels.launches == before
    # the kernel's words for each output i, on host integers
    for i in range(h):
        e0, e1 = (int(re[i]), int(im[i])), (int(re[i + h]), int(im[i + h]))
        hxi = int(w_inv[i]) * scale % P
        d = ((e0[0] - e1[0]) * hxi % P, (e0[1] - e1[1]) * hxi % P)
        t = _ext_mul(d, beta)
        out = ((e0[0] + e1[0]) * fri.INV2 + t[0]) % P, ((e0[1] + e1[1]) * fri.INV2 + t[1]) % P
        assert out == (int(gl.to_u64(got[0])[i]), int(gl.to_u64(got[1])[i]))


FOLD_FAULTS = ["odd layer", "short table", "strided re", "beta row"]


@pytest.mark.parametrize("fault", FOLD_FAULTS)
def test_fri_fold_plan_refuses(fault):
    t = gl.from_u64
    re, im, w_inv = t(_rand((16,), 1)), t(_rand((16,), 2)), t(_rand((8,), 3))
    beta = (t(np.uint64(4)), t(np.uint64(5)))
    if fault == "odd layer":
        re, im = re[:15], im[:15]
    elif fault == "short table":
        w_inv = w_inv[:7]
    elif fault == "strided re":
        re = t(_rand((32,), 1))[::2]
    elif fault == "beta row":
        beta = (t(_rand((1,), 4)), beta[1])
    with pytest.raises(ValueError):
        kernels.fri_fold_plan(re, im, w_inv, beta)


def test_fused_wrappers_raise_on_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on the CPU."""
    before = dict(kernels.launches)
    t = gl.from_u64
    with pytest.raises(ValueError):
        kernels.fri_fold(t(_rand((16,), 1)), t(_rand((16,), 2)), t(_rand((8,), 3)), 5, 6,
                         (t(np.uint64(4)), t(np.uint64(5))))
    x = t(_rand((64,), 11))
    with pytest.raises(ValueError):
        kernels.fri_g([t(_rand((2, 64), i)) for i in range(4)], (x[:9], x[:9]), (x[:1], x[:1]),
                      (x[:1], x[:1]), x, (0,))
    inp = _generic_inputs("phase 6", 1 << 7, 4)
    with pytest.raises(ValueError):
        kernels.generic_gate_quotient(
            pr.split_gates(SimpleNamespace(gates=GATE_SETS["phase 6"][0]))[0], t(inp["wires"]),
            t(inp["pre"]), 4, NUM_CONSTANTS, t(inp["lr"]), t(inp["pi"]),
            torch.from_numpy(inp["pi_cols"].astype(np.int64)), [t(a) for a in inp["apows"]],
            [t(a) for a in inp["accs"]], inp["pi0"], inp["k0"])
    assert kernels.launches == before


def test_kernel_sources_hold_the_modules_constants():
    def constants(name):
        with open(os.path.join(REPO, "eth_lc_plonky2_tpu_torch", "csrc", name)) as f:
            return {m.group(1): int(m.group(2))
                    for m in re.finditer(r"constexpr int (\w+) = (\d+);", f.read())}

    field = constants("field.cu")
    assert (field["G_TAGS"], field["G_MAX_SPECS"], field["G_MAX_ROWS"]) == (
        kernels.G_TAGS, kernels.G_MAX_SPECS, kernels.G_MAX_ROWS)
    assert len(fri.TAGS) == kernels.G_TAGS
    gates_cu = constants("gates.cu")
    assert (gates_cu["GEN_MAX_CONSTRAINTS"], gates_cu["GEN_BS_MAX_BITS"],
            gates_cu["GEN_BS_STRIDE"]) == (kernels.GEN_MAX_CONSTRAINTS, kernels.GEN_BS_MAX_BITS,
                                          kernels.GEN_BS_STRIDE)
