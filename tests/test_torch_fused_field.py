"""The two fused passes of ``csrc/field.cu`` on the CPU: the openings
(``field_open_kernel``) and the quotient's permutation terms
(``perm_quotient_kernel``).

A CUDA kernel cannot run here, so this file holds their plain versions
against the JAX package (numpy backend) on the same seeded inputs, exactly,
and tests the launch plans that the wrappers compute in plain Python: which
warp and lane of which block reads which coefficient, the row strides into
the wires' and the preprocessed LDEs, the next-row roll and the alpha powers.
``tests/test_torch_cuda.py`` holds the kernels against these plain versions
on the card."""

import numpy as np
import pytest
import torch

from eth_lc_plonky2_tpu.circuit import builder as jbuilder
from eth_lc_plonky2_tpu.ops import goldilocks as jgl
from eth_lc_plonky2_tpu.prover import config as jconfig
from eth_lc_plonky2_tpu.prover import prove as jpr
from eth_lc_plonky2_tpu_torch.circuit import builder
from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.ops import goldilocks_ext as ge
from eth_lc_plonky2_tpu_torch.ops import kernels, ntt
from eth_lc_plonky2_tpu_torch.prover import config
from eth_lc_plonky2_tpu_torch.prover import prove as pr

torch.set_num_threads(1)

P = gl.P
EDGE = np.array([0, 1, P - 1, 1 << 32, 1 << 63], dtype=np.uint64)
OFFSETS = (0, -1, -2, -3, -4, -7, -15, -16)  # the SHA-256 gate's rows: phase 7's W points


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _same(torch_field, jax_field):
    return np.array_equal(gl.to_u64(torch_field), jgl.to_u64(jax_field))


# ---------------------------------------------------------------------------
# The openings
# ---------------------------------------------------------------------------

ZETAS = {"seeded": None, "p - 1, 2^63": (P - 1, 1 << 63), "phi": (0, 1), "2^32, 1": (1 << 32, 1)}


@pytest.mark.parametrize("zeta", sorted(ZETAS))
@pytest.mark.parametrize("batch,n,k", [(1, 1 << 4, 1), (20, 1 << 8, 2), (184, 1 << 8, 8)])
def test_open_core_plain_equals_the_jax_packages(batch, n, k, zeta):
    """The plain openings against the JAX package's ``_open_core`` at the
    points zeta * omega^o of phase 7's offsets, with the edge words in the
    coefficients (first columns, and scattered) and, but for "seeded", in
    zeta."""
    coeffs = _rand((batch, n), batch + n + k)
    coeffs[:, : len(EDGE)] = EDGE[: min(n, len(EDGE))]
    flat = coeffs.reshape(-1)
    flat[np.random.default_rng(k).choice(flat.size, size=min(flat.size, 40), replace=False)] = \
        np.resize(EDGE, min(flat.size, 40))
    z = ZETAS[zeta] or tuple(int(v) for v in _rand((2,), n))
    omega = gl.primitive_root_of_unity(n.bit_length() - 1)
    points = [ge.h_mul(z, (pow(omega, o % n, P), 0)) for o in OFFSETS[:k]]
    z_re = np.array([q[0] for q in points], dtype=np.uint64)
    z_im = np.array([q[1] for q in points], dtype=np.uint64)
    got = pr._open_core_plain(gl.from_u64(coeffs), gl.from_u64(z_re), gl.from_u64(z_im))
    want = jpr._open_core(jgl.from_u64(coeffs), jgl.from_u64(z_re), jgl.from_u64(z_im))
    assert got[0].shape == (k, batch)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    # _open_core takes its plain version for CPU tensors, and launches nothing
    before = dict(kernels.launches)
    again = pr._open_core(gl.from_u64(coeffs), gl.from_u64(z_re), gl.from_u64(z_im))
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    assert kernels.launches == before


def _open_tiling(rows: int, n: int, k: int):
    """What ``field_open_kernel`` reads and writes under ``field_open_plan``,
    by the kernel's own index arithmetic: (reads, writes), where reads[j, r, c]
    counts the lanes that multiply coefficient (r, c) by point j's power and
    writes[s, part, j, r] the stores of a partial sum."""
    plan = kernels.field_open_plan(rows, n, k)
    ppb, slices, cols = plan["points_per_block"], plan["slices"], plan["cols"]
    reads = np.zeros((k, rows, n), dtype=np.int64)
    writes = np.zeros((slices, 2, k, rows), dtype=np.int64)
    lanes_i = np.arange(32)[:, None] + 32 * np.arange(cols)[None, :]
    for bx in range(slices * plan["row_groups"]):
        for by in range(plan["point_groups"]):
            for warp in range(kernels.OPEN_WARPS):
                sub, j = warp // ppb, by * ppb + warp % ppb
                s = bx % slices
                r0 = ((bx // slices) * (kernels.OPEN_WARPS // ppb) + sub) * kernels.OPEN_ROWS
                if not (sub < kernels.OPEN_WARPS // ppb and j < k and r0 < rows):
                    continue
                c = (s * 32 * cols + lanes_i).reshape(-1)
                c = c[c < n]
                for q in range(kernels.OPEN_ROWS):
                    if r0 + q < rows:
                        np.add.at(reads[j, r0 + q], c, 1)
                        writes[s, :, j, r0 + q] += 1
    return plan, reads, writes


@pytest.mark.parametrize("rows,n,k", [(1, 1, 1), (1, 16, 1), (5, 100, 3), (20, 256, 2),
                                      (37, 1000, 8), (9, 4096, 10), (92, 1 << 12, 1),
                                      (16, 1 << 14, 1)])
def test_field_open_plan_reads_every_word_once_a_point(rows, n, k):
    """Every (point, row, column) is multiplied in by exactly one lane, and
    every partial sum the summing launch reads is written exactly once."""
    plan, reads, writes = _open_tiling(rows, n, k)
    assert (reads == 1).all()
    assert (writes == 1).all()
    assert plan["launches"] == (1 if plan["slices"] == 1 else 2)
    # a lane's column sums take at most 2^8 products (gl::Acc)
    assert 1 <= plan["cols"] <= kernels.OPEN_MAX_COLS <= 256


def test_field_open_plan_at_the_main_paths_shapes():
    """Phase 7's four batches at 2^18 coefficients: two launches each (8 a
    proof), at least two blocks an SM of the H100, one point a warp."""
    n = 1 << 18
    want = {(92, 1): (1, 32, 3, 64, 128), (184, 8): (8, 4, 46, 128, 64),
            (20, 2): (2, 16, 2, 32, 256), (16, 1): (1, 32, 1, 16, 512)}
    for (rows, k), (ppb, rpb, groups, cols, slices) in want.items():
        plan = kernels.field_open_plan(rows, n, k)
        assert (plan["points_per_block"], plan["rows_per_block"], plan["row_groups"], plan["cols"],
                plan["slices"], plan["launches"]) == (ppb, rpb, groups, cols, slices, 2)
        assert plan["row_groups"] * plan["slices"] * plan["point_groups"] >= kernels.OPEN_MIN_BLOCKS


@pytest.mark.parametrize("rows,n,k", [(0, 16, 1), (4, 0, 1), (4, 16, 0)])
def test_field_open_plan_refuses_empty_shapes(rows, n, k):
    with pytest.raises(ValueError):
        kernels.field_open_plan(rows, n, k)


# ---------------------------------------------------------------------------
# The permutation terms
# ---------------------------------------------------------------------------

NR, CS, RATE = 16, 4, 3  # 4 chunks


def _perm_args(n_lde=64, num_wires=24, num_pre=30, sigma_at=6, seed=0):
    """Arguments as the quotient passes them: routed rows of a wider wires
    LDE, sigma rows from row ``sigma_at`` of a preprocessed LDE."""
    m = NR // CS
    wires = gl.from_u64(_rand((num_wires, n_lde), seed))
    pre = gl.from_u64(_rand((num_pre, n_lde), seed + 1))
    zs = gl.from_u64(_rand((2 * m, n_lde), seed + 2))
    x, l0 = gl.from_u64(_rand((n_lde,), seed + 3)), gl.from_u64(_rand((n_lde,), seed + 4))
    ks, bg = gl.from_u64(_rand((NR,), seed + 5)), gl.from_u64(_rand((2, 2), seed + 6))
    apows = [gl.from_u64(_rand((m + 9,), seed + 7 + j)) for j in range(2)]
    return [wires[:NR], pre[sigma_at : sigma_at + NR], zs, x, l0, ks, bg[0], bg[1], apows, CS, RATE]


def test_perm_quotient_plan_gives_strides_roll_and_alpha_terms():
    args = _perm_args(n_lde=64, num_wires=24, num_pre=30, sigma_at=6)
    plan = kernels.perm_quotient_plan(*args)
    assert plan == {"n_lde": 64, "routed": NR, "chunks": NR // CS, "wires_stride": 64,
                    "sigma_stride": 64, "zs_stride": 64, "next": 1 << RATE, "alpha_terms": 5,
                    "mask": 63}
    # the window form (a shard's points): the next row is read unwrapped
    assert kernels.perm_quotient_plan(*args, window=True)["mask"] == -1
    # sigma is read in place: its first word is word 6 * 64 of the preprocessed LDE
    assert args[1].storage_offset() == 6 * 64
    # rows of wider arrays keep their own row strides
    wide = gl.from_u64(_rand((24, 128), 9))[:, :64]
    args[0], args[1] = wide[:NR], wide[4 : 4 + NR]
    plan = kernels.perm_quotient_plan(*args)
    assert (plan["wires_stride"], plan["sigma_stride"]) == (128, 128)
    # the next trace row: column (x + 2^rate) mod n_lde is roll_lde's word, the
    # last 2^rate columns wrapping to the first
    for n_lde in (8, 64, 1 << 10):
        z = gl.from_u64(_rand((n_lde,), n_lde))
        cols = (torch.arange(n_lde) + plan["next"]) & (n_lde - 1)
        assert torch.equal(z[cols], ntt.roll_lde(z, 1, RATE))
    # 2^rate above n_lde: the roll wraps more than once, as the mask does
    z = gl.from_u64(_rand((4,), 4))
    assert torch.equal(z[(torch.arange(4) + 8) & 3], ntt.roll_lde(z, 1, RATE))


def test_perm_terms_plain_reads_alpha_powers_0_to_m():
    """The terms take alpha^0 .. alpha^m of each challenge (the kernel reads
    ``alpha_terms`` of them): words after them do not count, alpha^m does."""
    args = _perm_args()
    m = NR // CS
    want = pr.perm_quotient_terms_plain(*args)
    args[8] = [torch.cat([a[: m + 1], gl.from_u64(_rand((20,), 99))]) for a in args[8]]
    got = pr.perm_quotient_terms_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    args[8] = [a.clone() for a in args[8]]
    args[8][1][m] = gl.add(args[8][1][m], gl.from_u64(np.uint64(1)))
    changed = pr.perm_quotient_terms_plain(*args)
    assert torch.equal(changed[0], want[0]) and not torch.equal(changed[1], want[1])


PLAN_FAULTS = ["chunks do not divide", "too many routed", "one challenge", "three challenges",
               "short alpha row", "strided columns", "overlapping rows", "zs rows",
               "n_lde not a power of two", "int32 x"]


@pytest.mark.parametrize("fault", PLAN_FAULTS)
def test_perm_quotient_plan_refuses(fault):
    args = _perm_args()
    if fault == "chunks do not divide":
        args[9] = 3
    elif fault == "too many routed":
        wide = gl.zeros((kernels.PERM_MAX_ROUTED + 4, 64), "cpu")
        args[0], args[1], args[5] = wide, wide, gl.zeros((kernels.PERM_MAX_ROUTED + 4,), "cpu")
        args[9] = 4
    elif fault == "one challenge":
        args[8] = args[8][:1]
    elif fault == "three challenges":
        args[8] = args[8] * 2
        args[8] = args[8][:3]
    elif fault == "short alpha row":
        args[8] = [a[: NR // CS] for a in args[8]]
    elif fault == "strided columns":
        args[1] = gl.zeros((NR, 128), "cpu")[:, ::2]
    elif fault == "overlapping rows":
        args[0] = gl.zeros((64 + NR,), "cpu").as_strided((NR, 64), (1, 1))
    elif fault == "zs rows":
        args[2] = args[2][:-1]
    elif fault == "n_lde not a power of two":
        args = _perm_args(n_lde=48)
    elif fault == "int32 x":
        args[3] = args[3].to(torch.int32)
    with pytest.raises(ValueError):
        kernels.perm_quotient_plan(*args)


def test_fused_wrappers_raise_on_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on the CPU."""
    before = dict(kernels.launches)
    c = gl.from_u64(_rand((3, 16), 1))
    with pytest.raises(ValueError):
        kernels.field_open(c, c[0, :2], c[1, :2])
    with pytest.raises(ValueError):
        kernels.perm_quotient(*_perm_args())
    assert kernels.launches == before


def _copy_circuit(mod, cfg_mod):
    """A chain of mul_add rows (every row's output copied into the next), on
    one package's builder: many copy constraints across rows."""
    cfg = cfg_mod.CircuitConfig(fri=cfg_mod.FriConfig(proof_of_work_bits=8, num_query_rounds=12))
    b = mod.CircuitBuilder(cfg)
    x = b.add_virtual_target()
    acc = x
    while len(b.rows) < 60:
        acc = b.mul_add(acc, x, x)
    b.register_public_input(acc)
    data = b.build()
    w = data.new_witness()
    w.set(x, 3)
    w.generate()
    return data, w


def _grand_product(pd, wires, beta, gamma) -> int:
    """prod over rows and routed columns of (w + beta id + gamma) / (w + beta
    sigma + gamma), on the host: 1 exactly when the copies hold."""
    data = pd.data
    omega = gl.primitive_root_of_unity(data.log_n)
    num = den = 1
    for i in range(data.n):
        for c in range(data.config.num_routed_wires):
            w = int(wires[c, i])
            num = num * (w + beta * int(data.k_shifts[c]) * pow(omega, i, P) + gamma) % P
            den = den * (w + beta * int(data.sigma[c, i]) + gamma) % P
    return num * pow(den, P - 2, P) % P


def test_quotient_with_a_broken_copy_constraint_equals_the_jax_packages():
    """A witness matrix with one copy constraint broken (one of two copied
    cells changed): the grand product no longer closes, and both packages'
    quotients (the port's on its plain permutation terms) are still equal,
    word for word."""
    jdata, _ = _copy_circuit(jbuilder, jconfig)
    data, w = _copy_circuit(builder, config)
    jpd, _ = jpr.preprocess(jdata)
    pd, _ = pr.preprocess(data, device="cpu")
    cfg = data.config
    nr, rate = cfg.num_routed_wires, cfg.rate_bits
    wires = w.full_matrix()
    beta, gamma = (int(v) for v in _rand((2,), 21))
    assert _grand_product(pd, wires, beta, gamma) == 1
    # a routed cell whose sigma is not the identity is one of a copied pair
    omega = gl.primitive_root_of_unity(data.log_n)
    col, row = next((c, i) for c in range(nr) for i in range(data.n)
                    if int(data.sigma[c, i]) != int(data.k_shifts[c]) * pow(omega, i, P) % P)
    wires[col, row] = (int(wires[col, row]) + 1) % P
    assert _grand_product(pd, wires, beta, gamma) != 1
    zs = [pr.compute_permutation_polys(pd, gl.from_u64(wires), b, g)
          for b, g in ((beta, gamma), (gamma, beta))]
    for (b, g), z in zip(((beta, gamma), (gamma, beta)), zs):
        assert _same(z, jpr.compute_permutation_polys(jpd, jgl.from_u64(wires), b, g))
    wires_lde = ntt.coset_lde(ntt.intt(gl.from_u64(wires)), rate, pr.SHIFT)
    zs_lde = ntt.coset_lde(ntt.intt(torch.cat(zs)), rate, pr.SHIFT)
    pis = _rand((len(data.public_input_targets),), 22)
    betas, gammas = np.array([beta, gamma], np.uint64), np.array([gamma, beta], np.uint64)
    alphas = _rand((2,), 23)
    got = pr.make_quotient_kernel(pd)(
        wires_lde, zs_lde, pd.pre_batch.lde, gl.from_u64(pis), gl.from_u64(betas),
        gl.from_u64(gammas), [int(a) for a in alphas])
    want = jpr.make_quotient_kernel(jpd)(
        jgl.from_u64(gl.to_u64(wires_lde)), jgl.from_u64(gl.to_u64(zs_lde)), jpd.pre_batch.lde,
        jgl.from_u64(pis), jgl.from_u64(betas), jgl.from_u64(gammas), jgl.from_u64(alphas))
    assert got.shape == (cfg.num_challenges << rate, data.n) and _same(got, want)
