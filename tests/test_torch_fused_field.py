"""The two fused passes of ``csrc/field.cu`` on the CPU: the openings
(``field_open_table_kernel``, ``field_open_kernel`` on the int8 tensor cores,
``field_open_sum_kernel``) and the quotient's permutation terms
(``perm_quotient_kernel``).

A CUDA kernel cannot run here, so this file holds their plain versions
against the JAX package (numpy backend) on the same seeded inputs, exactly,
and tests the launch plans that the wrappers compute in plain Python: the
openings' fragment layouts (which lane and byte holds which coefficient and
power word), which warp of which block reads which coefficient, a numpy
emulation of the byte-plane class sums; the row strides into the wires' and
the preprocessed LDEs, the next-row roll and the alpha powers.
``tests/test_torch_cuda.py`` holds the kernels against these plain versions
on the card."""

import numpy as np
import pytest
import torch

from eth_lc_plonky2_tpu.circuit import builder as jbuilder
from eth_lc_plonky2_tpu.ops import goldilocks as jgl
from eth_lc_plonky2_tpu.ops import ntt as jntt
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


def _open_column(pos: int) -> int:
    """csrc/field.cu ``open_column``: the column of a k-step whose power byte
    sits at position ``pos`` of a plane's 32."""
    t, hi, e = pos >> 3, (pos >> 2) & 1, pos & 3
    return 16 * hi + 2 * t + (e & 1) + 8 * (e >> 1)


def _fragment_columns():
    """The columns of one m16n8k32 product's operands within a k-step, by the
    kernel's own lane arithmetic: (a_col[m, k], b_col[k, n]), the column of the
    coefficient word that lane and byte hold as A's element (row m, logical k),
    and of the power word as B's element (k, column n), after PTX's fragment
    layouts for .u8 (A: register f of lane (g, t) holds row g + 8 (f & 1), k =
    16 (f >> 1) + 4t + e in byte e; B: register r of lane (g, t) holds column
    g, k = 16 r + 4t + e in byte e)."""
    a_col = np.full((16, 32), -1)
    b_col = np.full((32, 8), -1)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):  # the four 16-byte loads of a row, words 2t + 8i, + 1
            for r8 in range(2):
                f, e0 = 2 * (i >> 1) + r8, 2 * (i & 1)
                for h in range(2):
                    m, k = g + 8 * (f & 1), 16 * (f >> 1) + 4 * t + e0 + h
                    assert a_col[m, k] == -1
                    a_col[m, k] = 2 * t + 8 * i + h
        for r in range(2):  # the 8 bytes from 8t of a plane's 32: bv.x, bv.y
            for e in range(4):
                k = 16 * r + 4 * t + e
                assert b_col[k, g] == -1
                b_col[k, g] = _open_column(8 * t + 4 * r + e)
    return a_col, b_col


def test_open_fragments_pair_each_column_with_its_power():
    """Every product of A and B in a k-step meets the coefficient and the
    power of one column, and a k-step's 32 columns each once a row."""
    a_col, b_col = _fragment_columns()
    assert (a_col >= 0).all() and (b_col >= 0).all()
    for m in range(16):
        assert sorted(a_col[m]) == list(range(32))
        for n in range(8):
            assert (a_col[m] == b_col[:, n]).all()
    assert sorted(_open_column(p) for p in range(32)) == list(range(32))


def _open_tiling(shapes: list, n: int):
    """What ``field_open_kernel`` reads and writes under ``field_open_plan``,
    by the kernel's own index arithmetic: (plan, reads, writes), where
    reads[b][q, r, c] counts the products of coefficient (r, c) of batch b
    with power row q (2j + part of its point j) and writes[s, i] the stores
    of word i of slice s's values.  Also checks that a stage's products meet
    only copied coefficient words, or zero powers past n."""
    plan = kernels.field_open_plan(shapes, n)
    a_col, _ = _fragment_columns()
    reads = [np.zeros((2 * k, rows, n), dtype=np.int64) for rows, k in shapes]
    writes = np.zeros((plan["slices"], plan["total"]), dtype=np.int64)
    for b, (rows, k) in enumerate(shapes):
        npc = 2 * k
        assert plan["ntiles"][b] <= kernels.OPEN_NTILES
        for grp in range(plan["groups"][b]):
            r0 = grp * kernels.OPEN_ROWS
            rows_blk = min(kernels.OPEN_ROWS, rows - r0)
            for y in range(plan["slices"]):
                c_begin = y * kernels.OPEN_CHUNK
                c_end = min(n, c_begin + kernels.OPEN_CHUNK)
                for it in range(-(-(c_end - c_begin) // kernels.OPEN_KS)):
                    c0 = c_begin + it * kernels.OPEN_KS
                    copied = min(kernels.OPEN_KS, c_end - c0)  # A's columns of the stage
                    for warp in range(kernels.OPEN_MTILES * kernels.OPEN_NTILES):
                        mt, nt = warp % kernels.OPEN_MTILES, warp // kernels.OPEN_MTILES
                        if mt >= plan["mtiles"][b][grp] or nt >= plan["ntiles"][b]:
                            continue
                        for ks in range(kernels.OPEN_KS // 32):
                            m_rows = r0 + 16 * mt + np.arange(16)
                            cols = c0 + 32 * ks + a_col  # (16, 32)
                            assert ((cols < c0 + copied) | (cols >= n)).all()
                            for q in 8 * nt + np.arange(8):
                                for m, r in enumerate(m_rows):
                                    if r < r0 + rows_blk and q < npc:
                                        c = cols[m][cols[m] < n]
                                        np.add.at(reads[b][q, r], c, 1)
                # the writes of the block's warps, once a slice
                for warp in range(kernels.OPEN_MTILES * kernels.OPEN_NTILES):
                    mt, nt = warp % kernels.OPEN_MTILES, warp // kernels.OPEN_MTILES
                    if mt >= plan["mtiles"][b][grp] or nt >= plan["ntiles"][b]:
                        continue
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        for i in range(4):
                            r = r0 + 16 * mt + g + 8 * (i >> 1)
                            q = 8 * nt + 2 * t + (i & 1)
                            if r < rows and q < npc:
                                writes[y, plan["out"][b] + ((q & 1) * k + (q >> 1)) * rows + r] += 1
    return plan, reads, writes


OPEN_TABLES = [[(1, 1)], [(1, 1)], [(5, 3)], [(20, 2), (3, 1)], [(37, 8)], [(9, 7), (40, 5)],
               [(92, 1), (33, 2)], [(16, 1)]]
OPEN_COLUMNS = [2, 16, 100, 256, 1000, 4096, 1 << 12, 1 << 14]
# rows-n-k of a table's first batch, with the batches after it
OPEN_IDS = ["-".join([f"{t[0][0]}-{n}-{t[0][1]}"] + [f"{r}-{k}" for r, k in t[1:]])
            for t, n in zip(OPEN_TABLES, OPEN_COLUMNS)]


@pytest.mark.parametrize("shapes,n", list(zip(OPEN_TABLES, OPEN_COLUMNS)), ids=OPEN_IDS)
def test_field_open_plan_reads_every_word_once_a_point(shapes, n):
    """Every (power row, coefficient row, column) product is taken by exactly
    one lane of one block, and every value of a slice is written exactly
    once; one launch for the table, one for the product and one for the
    slices' sum where there is more than one slice."""
    plan, reads, writes = _open_tiling(shapes, n)
    for r in reads:
        assert (r == 1).all()
    assert (writes == 1).all()
    assert plan["launches"] == (2 if plan["slices"] == 1 else 3)
    assert plan["slice_cols"] <= kernels.OPEN_CHUNK and plan["n_pad"] % kernels.OPEN_KS == 0


def test_field_open_plan_at_the_main_paths_shapes():
    """Phase 7's four batches at 2^18 coefficients in one launch of the
    product: 3 + 6 + 1 + 1 row groups, 64 slices of 2^12 columns, W's 16
    power rows two n-tiles, three launches a proof."""
    n = 1 << 18
    plan = kernels.field_open_plan([(92, 1), (184, 8), (20, 2), (16, 1)], n)
    assert plan["groups"] == [3, 6, 1, 1] and plan["group0"] == [0, 3, 9, 10]
    assert plan["blocks"] == 11 and plan["slices"] == 64 and plan["slice_cols"] == 1 << 12
    assert plan["ntiles"] == [1, 2, 1, 1]
    assert plan["mtiles"] == [[2, 2, 2], [2] * 6, [2], [1]]
    assert plan["out"] == [0, 184, 184 + 2944, 184 + 2944 + 80] and plan["total"] == 3240
    assert plan["n_pad"] == n and plan["launches"] == 3
    assert plan["blocks"] * plan["slices"] >= 2 * 132  # two blocks for each of the H100's SMs


@pytest.mark.parametrize("rows,n,k", [(0, 16, 1), (4, 0, 1), (4, 16, 0)])
def test_field_open_plan_refuses_empty_shapes(rows, n, k):
    with pytest.raises(ValueError):
        kernels.field_open_plan([(rows, k)], n)


@pytest.mark.parametrize("shapes,n", [([(4, 1)], 15), ([(4, 9)], 16), ([(4, 1)] * 9, 16)],
                         ids=["odd columns", "9 points", "9 entries"])
def test_field_open_plan_refuses(shapes, n):
    """An odd column count (the bulk copies move 16 bytes at a time), more
    points than an entry's n-tiles hold, more entries than a launch takes."""
    with pytest.raises(ValueError):
        kernels.field_open_plan(shapes, n)


@pytest.mark.parametrize("counts", [[1], [8, 1, 2, 1], [9], [0, 17, 3]])
def test_open_entries_split_batches_into_n_tiles(counts):
    """A batch with more points than one entry's n-tiles hold takes several
    entries of the batch table, its points in order; one without points
    takes none."""
    point_rows = [tuple(range(10, 10 + c)) for c in counts]
    entries = kernels.open_entries(point_rows)
    assert all(1 <= kb <= kernels.OPEN_MAX_POINTS for _, _, kb in entries)
    for b, rows in enumerate(point_rows):
        got = [rows[j : j + kb] for bb, j, kb in entries if bb == b]
        assert sum(got, ()) == rows
    assert len(entries) == sum(-(-c // kernels.OPEN_MAX_POINTS) for c in counts)


@pytest.mark.parametrize("rows,counts", [([92, 184, 20, 16], [1, 8, 2, 1]),
                                         ([37, 20, 5] * 3, [12, 2, 1] * 3),
                                         ([4] * 9, [1] * 9), ([5, 0, 7], [17, 3, 0])])
def test_field_open_plans_group_entries_into_launches(rows, counts):
    """field_open's launches: every entry of a batch with rows in exactly one
    group, the groups in order and each of at most OPEN_MAX_BATCHES entries,
    so that no number of batches or points raises; one launch at the main
    path's shapes."""
    n = 1 << 12
    point_rows = [tuple(range(c)) for c in counts]
    plans = kernels.field_open_plans(rows, point_rows, n)
    got = [e for group, _ in plans for e in group]
    assert got == [e for e in kernels.open_entries(point_rows) if rows[e[0]]]
    for group, plan in plans:
        assert 1 <= len(group) <= kernels.OPEN_MAX_BATCHES
        assert plan == kernels.field_open_plan([(rows[b], kb) for b, _, kb in group], n)
    assert len(plans) == -(-len(got) // kernels.OPEN_MAX_BATCHES)
    if counts == [1, 8, 2, 1]:
        assert len(plans) == 1


def _planes(words: np.ndarray) -> np.ndarray:
    """(..., n) u64 -> (8, ..., n) byte planes, plane 0 the lowest byte."""
    return np.stack([((words >> np.uint64(8 * p)) & np.uint64(0xFF)).astype(np.float64)
                     for p in range(8)])


def _emulate_open(coeffs: np.ndarray, points: list) -> tuple:
    """The openings as field_open_kernel computes them, in numpy: byte planes
    of the coefficients and of the powers (the table, zero past n), for each
    slice of OPEN_CHUNK columns the 15 class sums sum_{a+b=s} A_a B_b^T
    (exact in float64: each is below 2^31), folded with 2^8s mod p, and the
    slices added mod p.  Returns ((k, rows) re, (k, rows) im) as u64 and the
    largest class sum."""
    rows, n = coeffs.shape
    n_pad = -(-n // kernels.OPEN_KS) * kernels.OPEN_KS
    power_rows = np.zeros((2 * len(points), n_pad), dtype=np.uint64)
    for j, z in enumerate(points):
        v = (1, 0)
        for c in range(n):
            power_rows[2 * j, c], power_rows[2 * j + 1, c] = v
            v = ge.h_mul(v, z)
    a_planes, b_planes = _planes(coeffs), _planes(power_rows[:, :n])
    weights = [pow(2, 8 * s, P) for s in range(kernels.OPEN_CLASSES)]
    total = np.zeros((rows, 2 * len(points)), dtype=object)
    largest = 0
    for c0 in range(0, n, kernels.OPEN_CHUNK):
        sl = slice(c0, min(n, c0 + kernels.OPEN_CHUNK))
        for s in range(kernels.OPEN_CLASSES):
            cls = np.zeros((rows, 2 * len(points)))
            for a in range(max(0, s - 7), min(7, s) + 1):
                cls += a_planes[a][:, sl] @ b_planes[s - a][:, sl].T
            largest = max(largest, int(cls.max()))
            assert cls.max() < 2 ** 31
            total = (total + cls.astype(np.int64).astype(object) * weights[s]) % P
    out = total.T.astype(np.uint64)  # (2k, rows)
    return (out[0::2], out[1::2]), largest


# the largest words whose bytes are all 0xFF but one (below p), p - 1 and 0
WORST = np.array([0xFFFFFFFEFFFFFFFF, P - 1, 0], dtype=np.uint64)


@pytest.mark.parametrize("rows,n,words", [(37, 4196, "worst"), (5, 100, "p - 1"),
                                          (16, 8192 + 64, "mixed"), (3, 2, "worst")])
def test_byte_plane_class_sums_equal_the_plain_openings(rows, n, words):
    """The byte-plane product with the K chunk, emulated in numpy at worst-case
    words and at ragged rows and columns, equals ``_open_core_plain`` word for
    word, and no class sum reaches 2^31."""
    rng = np.random.default_rng(rows + n)
    if words == "worst":
        coeffs = np.full((rows, n), WORST[0], dtype=np.uint64)
    elif words == "p - 1":
        coeffs = np.full((rows, n), WORST[1], dtype=np.uint64)
    else:
        coeffs = rng.choice(WORST, size=(rows, n))
        coeffs[::2] = _rand((len(coeffs[::2]), n), n)
    z = tuple(int(v) for v in _rand((2,), rows))
    omega = gl.primitive_root_of_unity(13)
    points = [z, ge.h_mul(z, (omega, 0)), (P - 1, P - 1)]
    (re, im), largest = _emulate_open(coeffs, points)
    want = pr._open_core_plain(gl.from_u64(coeffs), gl.from_u64([q[0] for q in points]),
                               gl.from_u64([q[1] for q in points]))
    assert np.array_equal(re, gl.to_u64(want[0])) and np.array_equal(im, gl.to_u64(want[1]))
    assert 0 < largest < 2 ** 31
    # the bound itself: 8 pairs of 0xFF bytes over a whole chunk
    assert 8 * 255 * 255 * kernels.OPEN_CHUNK < 2 ** 31


def test_open_batches_plain_reads_each_batchs_points():
    """One call for several batches gives each batch its own points, as
    ``_open_core_plain`` of that batch alone; the union of host points is
    made once (``eval_poly_ext_batches``)."""
    coeffs = [gl.from_u64(_rand((r, 64), r)) for r in (3, 5, 2)]
    z = [tuple(int(v) for v in _rand((2,), i)) for i in range(4)]
    items = [(coeffs[0], [z[0]]), (coeffs[1], [z[0], z[1], z[2]]), (coeffs[2], [z[3], z[2]])]
    got = pr.eval_poly_ext_batches(items)
    for (c, pts), (re, im) in zip(items, got):
        want = pr._open_core_plain(c, gl.from_u64([q[0] for q in pts]), gl.from_u64([q[1] for q in pts]))
        assert torch.equal(re, want[0]) and torch.equal(im, want[1])


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
    assert {k: v for k, v in plan.items() if k != "layout"} == {
        "n_lde": 64, "routed": NR, "chunks": NR // CS, "wires_stride": 64, "sigma_stride": 64,
        "zs_stride": 64, "next": 1 << RATE, "alpha_terms": 5, "mask": 63, "tile": 64, "tiles": 1,
        "blocks": 1, "shared_bytes": (kernels.PERM_STAGES * kernels.PERM_STAGE_ROWS * 64
                                      + 2 * NR + kernels.PERM_STAGES) * 8
                       + 4 * kernels.PERM_STAGES}
    assert plan["layout"] == kernels.perm_stage_layout(NR // CS, CS)
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
               "n_lde not a power of two", "int32 x", "wires at an odd word offset",
               "odd sigma row stride", "l0 at an odd word offset", "one column"]


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
    elif fault == "wires at an odd word offset":  # a bulk copy needs 16-byte aligned rows
        args[0] = gl.from_u64(_rand((NR, 65), 1))[:, 1:]
    elif fault == "odd sigma row stride":
        args[1] = gl.from_u64(_rand((NR, 65), 1))[:, :64]
    elif fault == "l0 at an odd word offset":
        args[4] = gl.from_u64(_rand((65,), 1))[1:]
    elif fault == "one column":
        args = _perm_args(n_lde=1)
    with pytest.raises(ValueError):
        kernels.perm_quotient_plan(*args)
    if fault in ("wires at an odd word offset", "odd sigma row stride"):
        # the same rows, aligned, are taken
        args[0], args[1] = (gl.from_u64(_rand((NR, 66), 1))[:, 2:], gl.from_u64(_rand((NR, 66), 1))[:, :64])
        kernels.perm_quotient_plan(*args)


def _jax_perm_terms(w_all, sigma_all, zs, x, l0, ks, betas, gammas, apows, cs: int, rate: int):
    """The JAX package's permutation terms (eth_lc_plonky2_tpu/prover/prove.py:457-481)
    on its own field ops, as one (2, n_lde) host array: the same chain, chunk
    products and alpha weights, on numpy words."""
    J = lambda a: jgl.from_u64(np.ascontiguousarray(a, dtype=np.uint64))  # noqa: E731
    nr, n_lde = w_all.shape
    m = nr // cs
    out = []
    for j in range(2):
        acc = jgl.zeros((n_lde,))

        def absorb(idx, t):
            return jgl.add(acc, jgl.mul(J(np.full(n_lde, apows[j][idx])), t))

        z = J(zs[j * m])
        chain = [z] + [J(zs[j * m + 1 + k]) for k in range(m - 1)] + [jntt.roll_lde(z, 1, rate)]
        acc = absorb(0, jgl.mul(J(l0), jgl.sub(z, jgl.ones((n_lde,)))))
        beta, gamma = J(np.full((cs, n_lde), betas[j])), J(np.full((cs, n_lde), gammas[j]))
        for k in range(m):
            sl = slice(k * cs, (k + 1) * cs)
            id_k = jgl.mul(J(np.broadcast_to(ks[sl, None], (cs, n_lde))),
                           J(np.broadcast_to(x[None, :], (cs, n_lde))))
            n_k = jgl.add(jgl.add(J(w_all[sl]), jgl.mul(beta, id_k)), gamma)
            d_k = jgl.add(jgl.add(J(w_all[sl]), jgl.mul(beta, J(sigma_all[sl]))), gamma)
            acc = absorb(1 + k, jgl.sub(jgl.mul(chain[k + 1], jntt.prod_field(d_k, axis=0)),
                                        jgl.mul(chain[k], jntt.prod_field(n_k, axis=0))))
        out.append(jgl.to_u64(acc))
    return np.stack(out)


def _perm_ring_walk(plan, src: dict, h: int, apows, ks, betas, gammas, chunk: int):
    """perm_quotient_kernel on host integers, as the plan lays it out: every
    block's producer fills the ring stage by stage (``plan["layout"]``, the
    tile's segment of each row, of the (rows, columns) host arrays ``src``
    whose computed columns start at ``h``: the window form's halo, 0 for the
    one-device form); every consumer thread (a column) takes its words from
    the stages in the order the kernel walks them, only Z at the next row
    from the array.  Returns the (2, n_lde) words and reads[(source, row)],
    how often each column of that row was taken from a stage."""
    n_lde, tile, m = plan["n_lde"], plan["tile"], plan["chunks"]
    per_chunk = -(-chunk // kernels.PERM_PAIRS)
    reads = {}
    out = np.zeros((2, n_lde), dtype=np.uint64)
    beta_k = [[int(b) * int(k) % P for k in ks] for b in betas]
    for b in range(plan["blocks"]):
        ring = []  # the producer: one dict slot -> segment a stage, in order
        for tl in range(b, plan["tiles"], plan["blocks"]):
            c0 = h + tl * tile
            for stage in plan["layout"]:
                ring.append({slot: src[name][row, c0 : c0 + tile] for slot, name, row in stage})
                for _, name, row in stage:
                    cnt = reads.setdefault((name, row), np.zeros(n_lde, dtype=np.int64))
                    cnt[tl * tile : (tl + 1) * tile] += 1
        it = 0
        for tl in range(b, plan["tiles"], plan["blocks"]):
            head = ring[it]
            for xt in range(tile):
                x = tl * tile + xt
                xn = x + plan["next"] if plan["mask"] == -1 else (x + plan["next"]) & plan["mask"]
                xv, l0 = int(head[0][xt]), int(head[1][xt])
                for j in range(2):
                    a = [int(v) for v in apows[j]]
                    prev = int(head[2 + j][xt])
                    acc = a[0] * (l0 * prev - l0)  # one column sum: alpha_0 l0 (Z - 1), then
                    for k in range(m):  # alpha_{k+1} (chain[k+1] den_k - chain[k] num_k)
                        num = den = 1
                        for q in range(per_chunk):
                            stage = ring[it + 1 + k * per_chunk + q]
                            for r in range(min(kernels.PERM_PAIRS, chunk - q * kernels.PERM_PAIRS)):
                                w, sg = int(stage[r][xt]), int(stage[kernels.PERM_PAIRS + r][xt])
                                col = k * chunk + q * kernels.PERM_PAIRS + r
                                num = num * (w + beta_k[j][col] * xv + int(gammas[j])) % P
                                den = den * (w + int(betas[j]) * sg + int(gammas[j])) % P
                        nxt = (int(stage[2 * kernels.PERM_PAIRS + j][xt]) if k + 1 < m
                               else int(src["zs"][j * m, h + xn]))
                        acc += a[1 + k] * (nxt * den - prev * num)
                        prev = nxt
                    out[j, x] = acc % P
            it += len(plan["layout"])
        assert it == len(ring)
    return out, reads


# (routed, chunk, n_lde, sms, window): the flagship's 80 routed wires in
# chunks of 8 at 2^7 (one tile, the next row of the last 2^3 columns
# wrapping); 16 in chunks of 4 on 2^10 (tiles of 256, the next row across a
# tile's edge, three blocks for four tiles); chunks of 16 (two stages a
# chunk); the window form on a shard's 2^8 of 2^9 points (halo 16)
PERM_WALKS = [(80, 8, 1 << 7, 132, False), (16, 4, 1 << 10, 3, False), (32, 16, 1 << 8, 1, False),
              (16, 4, 1 << 8, 2, True)]


@pytest.mark.parametrize("routed,chunk,n_lde,sms,window", PERM_WALKS)
def test_perm_ring_walk_equals_the_plain_version_and_the_jax_packages(routed, chunk, n_lde, sms,
                                                                       window):
    """The kernel's ring, walked on the host from the plan's stage layout:
    every wire, sigma and Z row, x and l0 is taken from a stage exactly once
    a column (Z at the next row from the array), and the words equal the
    plain version's and the JAX package's, exactly."""
    m = routed // chunk
    h = 16 if window else 0
    width = n_lde + 2 * h  # the window's columns: halos on both sides
    rng = np.random.default_rng(routed + n_lde)
    src = {"wires": rng.integers(0, P, size=(routed, width), dtype=np.uint64),
           "sigma": rng.integers(0, P, size=(routed, width), dtype=np.uint64),
           "zs": rng.integers(0, P, size=(2 * m, width), dtype=np.uint64),
           "x": rng.integers(0, P, size=(1, width), dtype=np.uint64),
           "l0": rng.integers(0, P, size=(1, width), dtype=np.uint64)}
    for a in src.values():
        a[:, : len(EDGE)] = EDGE
        a[:, -len(EDGE):] = EDGE[::-1]
    ks = rng.integers(0, P, size=routed, dtype=np.uint64)
    bg = rng.integers(0, P, size=(2, 2), dtype=np.uint64)
    bg[1, 1] = P - 1
    apows = rng.integers(0, P, size=(2, m + 1), dtype=np.uint64)
    t = {k: gl.from_u64(v) for k, v in src.items()}
    mid = slice(h, h + n_lde)
    plan = kernels.perm_quotient_plan(
        t["wires"][:, mid], t["sigma"][:, mid], t["zs"][:, mid], t["x"][0, mid], t["l0"][0, mid],
        gl.from_u64(ks), gl.from_u64(bg[0]), gl.from_u64(bg[1]), [gl.from_u64(a) for a in apows],
        chunk, RATE, window, sms)
    assert plan["tile"] == min(kernels.PERM_TILE, n_lde) and plan["tiles"] * plan["tile"] == n_lde
    assert plan["blocks"] == min(plan["tiles"], kernels.PERM_MIN_BLOCKS * sms)
    assert all(len(s) <= kernels.PERM_STAGE_ROWS and len({q for q, _, _ in s}) == len(s)
               for s in plan["layout"])
    got, reads = _perm_ring_walk(plan, src, h, apows, ks, bg[0], bg[1], chunk)
    want_rows = ([("wires", i) for i in range(routed)] + [("sigma", i) for i in range(routed)]
                 + [("zs", i) for i in range(2 * m)] + [("x", 0), ("l0", 0)])
    assert sorted(reads) == sorted(want_rows) and all((c == 1).all() for c in reads.values())
    # the plain version and the JAX package on the whole window, cut to the middle
    # (the one-device form: the window is the domain, and the next row wraps)
    args = (t["wires"], t["sigma"], t["zs"], t["x"][0], t["l0"][0], gl.from_u64(ks),
            gl.from_u64(bg[0]), gl.from_u64(bg[1]), [gl.from_u64(a) for a in apows], chunk, RATE)
    plain = np.stack([gl.to_u64(a) for a in pr.perm_quotient_terms_plain(*args)])[:, mid]
    assert np.array_equal(got, plain)
    jax = _jax_perm_terms(src["wires"], src["sigma"], src["zs"], src["x"][0], src["l0"][0], ks,
                          bg[0], bg[1], apows, chunk, RATE)
    assert np.array_equal(got, jax[:, mid])


def test_fused_wrappers_raise_on_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on the CPU."""
    before = dict(kernels.launches)
    c = gl.from_u64(_rand((3, 16), 1))
    with pytest.raises(ValueError):
        kernels.field_open([c], c[0, :2], c[1, :2], [(0, 1)])
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
