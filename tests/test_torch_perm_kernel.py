"""The permutation argument's Z and partials (csrc/field.cu ``perm_z_kernel``,
``perm_z_scan_kernel``, ``perm_z_fixup_kernel``) and the batched inverse
(``field_inv_kernel``) on the CPU.

No CUDA kernel runs here, so this file holds the plain ``_perm_core``
against the JAX package's (numpy backend) bit for bit, zero den chunks
included, and walks each kernel's algorithm in plain PyTorch under the
parameters its plan gives: the batched inversion of a column's den chunks
(Montgomery's trick, zeros skipped), the warp and block scan in the order of
the shuffles, the scan of the block products and the fix-up, at several
block counts; and the runs of ``field_inv_kernel``.  ``tests/test_torch_cuda.py``
holds the kernels against the plain versions on the card."""

import numpy as np
import pytest
import torch

from eth_lc_plonky2_tpu.ops import goldilocks as jgl
from eth_lc_plonky2_tpu.prover import prove as jpr
from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.ops import kernels
from eth_lc_plonky2_tpu_torch.prover import prove as pr

torch.set_num_threads(1)

P = gl.P
EDGE = np.array([0, 1, P - 1, 1 << 32, 1 << 63], dtype=np.uint64)
add, mul = gl.add_plain, gl.mul_plain


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _perm_inputs(nr: int, cs: int, n: int, challenges: int, seed: int, zeros: list):
    """Seeded wires, sigma, omega powers, k shifts and challenges (host
    uint64), the edge words in the first columns of the wires and sigma; for
    each (challenge j, chunk k, column x) of ``zeros`` one wire of chunk k is
    set to -(beta_j sigma + gamma_j), so that chunk k's den is 0 there."""
    wires, sigma = _rand((nr, n), seed), _rand((nr, n), seed + 1)
    wires[:, : min(n, len(EDGE))] = EDGE[: min(n, len(EDGE))]
    sigma[::2, : min(n, len(EDGE))] = EDGE[::-1][: min(n, len(EDGE))]
    omega = gl.primitive_root_of_unity(n.bit_length() - 1)
    omega_pows = np.array([pow(omega, i, P) for i in range(n)], dtype=np.uint64)
    k_shifts = np.array([pow(gl.MULTIPLICATIVE_GENERATOR, i, P) for i in range(nr)], dtype=np.uint64)
    betas, gammas = _rand((challenges,), seed + 2), _rand((challenges,), seed + 3)
    for j, k, x in zeros:
        i = k * cs + (x % cs)
        den = (int(betas[j]) * int(sigma[i, x]) + int(gammas[j])) % P
        wires[i, x] = (P - den) % P
    return wires, sigma, omega_pows, k_shifts, betas, gammas


def _jax_rows(wires, sigma, omega_pows, k_shifts, betas, gammas, cs):
    return np.concatenate([
        jgl.to_u64(jpr._perm_core(jgl.from_u64(wires), jgl.from_u64(sigma), jgl.from_u64(omega_pows),
                                  jgl.from_u64(k_shifts), jgl.from_u64(np.uint64(b)),
                                  jgl.from_u64(np.uint64(g)), chunk_size=cs))
        for b, g in zip(betas, gammas)])


def _plain_rows(wires, sigma, omega_pows, k_shifts, betas, gammas, cs):
    f = gl.from_u64
    return torch.cat([pr._perm_core(f(wires), f(sigma), f(omega_pows), f(k_shifts), f(np.uint64(b)),
                                    f(np.uint64(g)), cs) for b, g in zip(betas, gammas)])


# ---------------------------------------------------------------------------
# The plain version against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log_n", [4, 7, 10])
@pytest.mark.parametrize("nr,cs", [(8, 8), (16, 8), (80, 8), (16, 4)])
def test_perm_core_plain_equals_the_jax_packages(nr, cs, log_n):
    """``_perm_core`` (plain) against the JAX package's, with edge words and
    den chunks forced to zero: for the first challenge in chunk 0 at column
    1 and in the last chunk at column n/2, for the second in the last chunk
    at the last column.  From a zero den chunk on, a row's ratio is 0 and so
    is Z at every later column."""
    n, m = 1 << log_n, nr // cs
    zeros = [(0, 0, 1), (0, m - 1, n // 2), (1, m - 1, n - 1)]
    inputs = _perm_inputs(nr, cs, n, 2, nr + log_n, zeros)
    got = _plain_rows(*inputs, cs)
    assert got.shape == (2 * m, n)
    assert np.array_equal(gl.to_u64(got), _jax_rows(*inputs, cs))
    z = gl.to_u64(got)
    assert z[0, 0] == 1 and not z[0, n // 2 + 1 :].any() and z[m, n - 1] != 0


def test_permutation_polys_on_the_cpu_runs_the_plain_version():
    """``permutation_polys`` of a CPU tensor: the plain rows of both
    challenges, and no launch."""
    import types

    inputs = _perm_inputs(16, 8, 64, 2, 5, [(1, 1, 9)])
    wires, sigma, omega_pows, k_shifts, betas, gammas = inputs
    cfg = types.SimpleNamespace(num_routed_wires=16, permutation_chunk_size=8)
    pd = types.SimpleNamespace(data=types.SimpleNamespace(config=cfg), dev={
        "sigma": gl.from_u64(sigma), "omega_pows": gl.from_u64(omega_pows),
        "k_shifts": gl.from_u64(k_shifts)})
    all_wires = gl.from_u64(np.concatenate([wires, _rand((4, 64), 6)]))  # 4 unrouted rows
    before = dict(kernels.launches)
    got = pr.permutation_polys(pd, all_wires, [int(b) for b in betas], [int(g) for g in gammas])
    assert kernels.launches == before
    assert np.array_equal(gl.to_u64(got), _jax_rows(*inputs, 8))
    one = pr.compute_permutation_polys(pd, all_wires, int(betas[1]), int(gammas[1]))
    assert torch.equal(one, got[2:])


# ---------------------------------------------------------------------------
# The kernels' algorithms, walked in plain PyTorch
# ---------------------------------------------------------------------------


def _batch_div(q, d):
    """gl::batch_div over rows: q[r] <- q[r] / d[r] (q None: 1 / d[r]), 0
    where d[r] = 0, with one inversion for all rows; rows are tensors over
    the threads that run it side by side.  The forward pass keeps q[r] times
    the product of the non-zero d before r, the backward pass multiplies by
    the running inverse, which then takes d[r]."""
    rows = len(d)
    out = [None] * rows
    run = torch.ones_like(d[0])
    for r in range(rows):
        out[r] = run if q is None else mul(q[r], run)
        run = torch.where(d[r] != 0, mul(run, d[r]), run)
    inv = gl.inv_plain(run)
    for r in reversed(range(rows)):
        nz = d[r] != 0
        out[r] = torch.where(nz, mul(inv, out[r]), torch.zeros_like(inv))
        inv = torch.where(nz, mul(inv, d[r]), inv)
    return out


def _shfl_scan(x):
    """The shuffles' inclusive scan along the last axis (32 lanes): at off =
    1, 2, 4, 8, 16 lane l multiplies by the value lane l - off holds."""
    lane = torch.arange(32)
    for off in (1, 2, 4, 8, 16):
        y = torch.cat([x[..., :off], x[..., :-off]], dim=-1)  # shfl_up: lanes < off read themselves
        x = torch.where(lane >= off, mul(x, y), x)
    return x


def _shfl_left(x):
    """Each lane's left neighbour (lane 0 takes 1): inclusive -> exclusive."""
    return torch.cat([torch.ones_like(x[..., :1]), x[..., :-1]], dim=-1)


def _block_scan(v):
    """block_scan of csrc/field.cu over (..., threads): the exclusive product
    of the threads before each one, and the block's product."""
    *lead, threads = v.shape
    warps = threads // 32
    inc = _shfl_scan(v.reshape(*lead, warps, 32))
    sums = torch.cat([inc[..., 31], torch.ones((*lead, 32 - warps), dtype=torch.int64)], dim=-1)
    s = _shfl_scan(sums)  # the first warp, one lane a warp; lanes past the warps hold 1
    offsets = _shfl_left(s)[..., :warps]
    return mul(offsets[..., None], _shfl_left(inc)).reshape(*lead, threads), s[..., 31]


def _perm_z_walk(wires, sigma, omega, k_shifts, betas, gammas, chunk, plan):
    """The three launches of kernels.perm_z under ``plan``, column by column
    (all columns of the grid side by side): (challenges * m, n) rows."""
    routed, n = wires.shape
    nc, m, T, B = betas.shape[0], plan["m"], plan["threads"], plan["blocks"]
    assert (B - 1) * T < n <= B * T
    cols = B * T
    live = torch.arange(cols) < n

    def pad(t):
        return torch.cat([t, torch.zeros((*t.shape[:-1], cols - n), dtype=torch.int64)], dim=-1)

    w, s, om = pad(wires), pad(sigma), pad(omega)
    # pass 1: num_k and den_k of each chunk, q / d rows j * m + k
    q, d = [None] * (nc * m), [None] * (nc * m)
    num, den = [None] * nc, [None] * nc
    for col in range(routed):
        k, i = divmod(col, chunk)
        for j in range(nc):
            wg = add(w[col], gammas[j])
            nt = add(mul(mul(betas[j], k_shifts[col]), om), wg)
            dt = add(mul(betas[j], s[col]), wg)
            num[j] = nt if i == 0 else mul(num[j], nt)
            den[j] = dt if i == 0 else mul(den[j], dt)
            if i == chunk - 1:
                q[j * m + k], d[j * m + k] = num[j], den[j]
    ratio = _batch_div(q, d)
    out = torch.zeros((nc * m, n), dtype=torch.int64)
    row_ratio = []
    for j in range(nc):
        pref = ratio[j * m]
        for kk in range(1, m):
            out[j * m + kk] = pref[:n]  # parked: rat_pref[kk - 1], unscaled
            pref = mul(pref, ratio[j * m + kk])
        row_ratio.append(torch.where(live, pref, torch.ones_like(pref)))
    excl, totals = _block_scan(torch.stack(row_ratio).reshape(nc, B, T))
    for j in range(nc):
        out[j * m] = excl[j].reshape(-1)[:n]
    assert sorted(plan["z_rows"] + plan["parked_rows"]) == list(range(nc * m))
    # pass 2: one block a challenge, `run` block products a thread
    S, R = plan["scan_threads"], plan["run"]
    assert S * R >= B
    tot = torch.cat([totals, torch.ones((nc, S * R - B), dtype=torch.int64)], dim=1).reshape(nc, S, R)
    prod = tot[..., 0]
    for r in range(1, R):
        prod = mul(prod, tot[..., r])
    e, _ = _block_scan(prod)
    offsets = []
    for r in range(R):
        offsets.append(e)
        e = mul(e, tot[..., r])
    offsets = torch.stack(offsets, dim=-1).reshape(nc, S * R)[:, :B]
    # pass 3: Z = its block's offset times the block-local Z; p_k = Z rat_pref[k]
    block_of = torch.arange(n) // T
    for j in range(nc):
        z = mul(offsets[j][block_of], out[j * m])
        out[j * m] = z
        for kk in range(1, m):
            out[j * m + kk] = mul(z, out[j * m + kk])
    return out


@pytest.mark.parametrize("log_n", [4, 6, 8, 10, 11])
@pytest.mark.parametrize("nr,cs,challenges,threads", [
    (80, 8, 2, 256), (80, 8, 1, 256), (16, 2, 2, 256), (8, 8, 2, 256),
    (128, 8, 2, 128), (256, 8, 2, 64), (256, 4, 1, 64), (256, 4, 2, 32),
])
def test_perm_z_walk_equals_the_plain_version(nr, cs, challenges, log_n, threads):
    """perm_z_kernel's per-column algorithm, its block scan, the scan of the
    block products and the fix-up, walked under ``perm_z_plan``, whose block
    of 256, 128, 64 or 32 columns the chunk count m sets (n = 16 is less than
    a block; 2048 is 8 to 64 blocks), against the plain ``_perm_core`` of
    each challenge; a den chunk of every challenge is zero in a later block
    than the first."""
    n = 1 << log_n
    m = nr // cs
    zeros = [(j, (j * 3) % m, (n * (2 + j)) // 5) for j in range(challenges)]
    inputs = _perm_inputs(nr, cs, n, challenges, 7 * log_n + nr, zeros)
    plan = kernels.perm_z_plan(nr, n, cs, challenges)
    assert plan["threads"] == threads and plan["launches"] == 3
    f = [gl.from_u64(a) for a in inputs]
    got = _perm_z_walk(*f, cs, plan)
    want = _plain_rows(*inputs, cs)
    assert torch.equal(got, want)
    z = gl.to_u64(want)
    assert z[0, 0] == 1 and z[0, -1] == 0  # the zero den chunk ends the grand product


def test_perm_z_walk_without_zeros_closes_on_a_satisfied_permutation():
    """With sigma the identity's encoding (k_i omega^x) every ratio is 1: Z
    and every partial are 1, through every block boundary (m = 32: blocks of
    64 columns)."""
    n, nr, cs = 512, 128, 4
    omega = gl.primitive_root_of_unity(9)
    k_shifts = np.array([pow(7, i, P) for i in range(nr)], dtype=np.uint64)
    omega_pows = np.array([pow(omega, x, P) for x in range(n)], dtype=np.uint64)
    sigma = np.array([[int(k) * int(o) % P for o in omega_pows] for k in k_shifts], dtype=np.uint64)
    f = gl.from_u64
    plan = kernels.perm_z_plan(nr, n, cs, 2)
    assert (plan["threads"], plan["blocks"]) == (64, 8)
    got = _perm_z_walk(f(_rand((nr, n), 3)), f(sigma), f(omega_pows), f(k_shifts), f(_rand((2,), 4)),
                       f(_rand((2,), 5)), cs, plan)
    assert torch.equal(got, torch.ones_like(got))


def test_block_scan_walk_is_an_exclusive_product_in_thread_order():
    x = _rand((3, 256), 11)
    x[1, 40] = 0
    v = gl.from_u64(x)
    excl, total = _block_scan(v)
    for row in range(3):
        acc = 1
        for t in range(256):
            assert int(gl.to_u64(excl[row, t])) == acc
            acc = acc * int(x[row, t]) % P
        assert int(gl.to_u64(total[row])) == acc


def _field_inv_walk(x, plan):
    """field_inv_kernel under ``plan``: the padded words as (tiles, run,
    threads), element [b, i, t] = word b * tile + i * threads + t, each
    thread's run inverted together by the batch trick; absent words are 0."""
    n = x.numel()
    words = torch.cat([x.reshape(-1), torch.zeros(plan["blocks"] * plan["tile"] - n,
                                                  dtype=torch.int64)])
    runs = words.reshape(plan["blocks"], plan["run"], plan["threads"])
    inv = _batch_div(None, list(runs.unbind(1)))
    return torch.stack(inv, dim=1).reshape(-1)[:n].reshape(x.shape)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 15, 16, 17, 255, 256, 4095, 4096, 4097, 9000])
def test_field_inv_walk_equals_inv_plain(n):
    """``field_inv_kernel``'s runs (16 words a thread at a stride of the
    block, a tile of 4,096 words a block) with zeros anywhere in a run: the
    first and the last word of runs, whole runs, and every seventh word;
    tails shorter than a run and odd lengths; edge words."""
    x = _rand((n,), n)
    x[: min(n, len(EDGE))] = EDGE[: min(n, len(EDGE))]
    x[3::7] = 0
    plan = kernels.field_inv_plan(n)
    threads = plan["threads"]
    x[threads * 15 : threads * 16] = 0  # the last word of every run of the first tile
    x[threads * 2 + 5 :: plan["tile"]] = 0  # word 2 of one thread's run in each tile
    x[plan["tile"] + 9 :: threads][: plan["run"]] = 0  # a whole run of the second tile
    t = gl.from_u64(x)
    got = _field_inv_walk(t, plan)
    assert torch.equal(got, gl.inv_plain(t))
    assert torch.equal(mul(got, t), (t != 0).to(torch.int64))


def test_batch_div_walk_with_numerators_and_zeros():
    """The batch trick with numerators (perm_z_kernel's form), rows all zero,
    a zero first and last, against num * inv_plain(den)."""
    num = gl.from_u64(_rand((6, 40), 1))
    den_np = _rand((6, 40), 2)
    den_np[0, :] = 0
    den_np[:, 0] = 0
    den_np[5, 7] = 0
    den = gl.from_u64(den_np)
    got = torch.stack(_batch_div(list(num), list(den)))
    assert torch.equal(got, mul(num, gl.inv_plain(den)))


# ---------------------------------------------------------------------------
# Plans and wrappers
# ---------------------------------------------------------------------------


def test_perm_z_plan_sizes():
    plan = kernels.perm_z_plan(80, 1 << 18, 8, 2)
    assert (plan["m"], plan["threads"], plan["blocks"]) == (10, 256, 1024)
    assert plan["shared_bytes"] == 2 * 2 * 10 * 256 * 8 <= kernels.PERM_Z_SHARED_TARGET
    assert (plan["scan_threads"], plan["run"]) == (256, 4)
    assert plan["z_rows"] == [0, 10] and len(plan["parked_rows"]) == 18
    # the block shrinks until two blocks' shared memory fits an SM
    wide = kernels.perm_z_plan(256, 1 << 12, 4, 2)
    assert wide["m"] == 64 and wide["threads"] == 32 and wide["shared_bytes"] == 65536
    assert kernels.perm_z_plan(8, 1, 8, 1)["blocks"] == 1
    assert kernels.field_inv_plan(5 << 21) == {"threads": 256, "run": 16, "tile": 4096,
                                               "blocks": 2560}


@pytest.mark.parametrize("args", [
    (81, 1 << 10, 8, 2),   # routed not a multiple of the chunk
    (264, 1 << 10, 8, 2),  # more routed wires than PERM_MAX_ROUTED
    (256, 1 << 10, 2, 2),  # 128 chunks
    (80, 1 << 10, 0, 2),   # chunk 0
    (4, 1 << 10, 8, 2),    # fewer wires than a chunk
    (80, 0, 8, 2),         # no columns
    (80, 1 << 10, 8, 0),   # no challenge
    (80, 1 << 10, 8, 3),   # more challenges than the kernel takes
    (80, 1 << 10, -8, 2),  # a negative chunk
    (80, (256 << 31) + 1, 8, 2),  # a grid of more than 2^31 - 1 blocks
])
def test_perm_z_plan_refuses(args):
    with pytest.raises(ValueError):
        kernels.perm_z_plan(*args)


def test_field_inv_plan_refuses_no_words():
    with pytest.raises(ValueError):
        kernels.field_inv_plan(0)


def test_wrappers_raise_on_cpu_tensors():
    """A CPU tensor never reaches a kernel's wrapper on the main path; given
    to one, the wrapper raises rather than running the plain version."""
    f = [gl.from_u64(a) for a in _perm_inputs(16, 8, 32, 2, 1, [])]
    with pytest.raises(ValueError):
        kernels.perm_z(*f, 8)
    with pytest.raises(ValueError):
        kernels.field_inv(f[0])
