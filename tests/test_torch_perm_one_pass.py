"""The permutation rows in one launch (``tools/variants/perm_z_one_pass.cu``,
off the main path: it ran slower on an H100 than ``csrc/field.cu``'s three
launches) walked on the CPU under its plan.

The one pass: a block draws a ticket for its tile, computes the tile's
running products and block scan as ``perm_z_kernel`` does, and finds the
product of the tiles before it by a decoupled look-back over a state kept
between launches (warp w looks back for the challenges j = w mod the
tile's warps).  The walk runs tiles in seeded orders on a state that
earlier launches left, at several tile counts, and compares every word with
the plain ``_perm_core`` and the JAX package's; ``main`` of
``tools/variants/perm_z_one_pass.py`` holds the kernel against
``kernels.perm_z`` on the card."""

import os
import sys

import numpy as np
import pytest
import torch

from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.ops import kernels
from test_torch_perm_kernel import (_batch_div, _block_scan, _jax_rows, _perm_inputs, _plain_rows,
                                    _rand)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools", "variants"))
import perm_z_one_pass as one_pass  # noqa: E402

torch.set_num_threads(1)

P = gl.P
add, mul = gl.add_plain, gl.mul_plain


def _tile_work(wires, sigma, omega, k_shifts, betas, gammas, chunk, plan):
    """perm_z_kernel's work inside its tiles, all tiles side by side (the
    columns past n are padding): for each challenge j the running products
    rat_pref[k], k < m - 1, as kept in shared memory (tensors over the
    grid's columns), the exclusive in-block products of the row ratios (grid,
    tile) and each tile's own product (grid,)."""
    routed, n = wires.shape
    nc, m, T, B = betas.shape[0], plan["m"], plan["tile"], plan["grid"]
    assert (B - 1) * T < n <= B * T
    cols = B * T
    live = torch.arange(cols) < n

    def pad(t):
        return torch.cat([t, torch.zeros((*t.shape[:-1], cols - n), dtype=torch.int64)], dim=-1)

    w, s, om = pad(wires), pad(sigma), pad(omega)
    # num_k and den_k of each chunk, q / d rows j * m + k
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
    kept, row_ratio = [], []
    for j in range(nc):
        pref, rows = ratio[j * m], []
        for kk in range(1, m):
            rows.append(pref)  # rat_pref[kk - 1], in place of ratio kk - 1
            pref = mul(pref, ratio[j * m + kk])
        kept.append(rows)
        row_ratio.append(torch.where(live, pref, torch.ones_like(pref)))
    excl, own = _block_scan(torch.stack(row_ratio).reshape(nc, B, T))
    return kept, excl, own


AGGREGATE, INCLUSIVE = 1, 2  # PERM_Z_AGGREGATE, PERM_Z_INCLUSIVE
WINDOW = 32  # a look-back step: one status a lane


class _State:
    """The look-back state as ``elp_perm_z_one_pass`` lays it out in its words
    (numpy uint64): the ticket counter, then the statuses, the tiles' own
    products and their inclusive products, (PERM_CHALLENGES, cap) each."""

    def __init__(self, words: np.ndarray):
        cap = (len(words) - 1) // (3 * kernels.PERM_CHALLENGES)
        assert one_pass.state_words(cap) == len(words)
        self.words, self.cap = words, cap
        rows = kernels.PERM_CHALLENGES * cap
        self.status, self.aggregate, self.inclusive = (
            words[1 + r * rows : 1 + (r + 1) * rows].reshape(kernels.PERM_CHALLENGES, cap)
            for r in range(3))
        self.whole_windows = 0  # look-back steps that took a whole window of aggregates

    def draw(self) -> int:
        ticket = int(self.words[0])
        self.words[0] = np.uint64(ticket + 1)
        return ticket


def _look_back_steps(state: _State, j: int, tile: int, own: int, epoch: int):
    """look_back of perm_z_one_pass.cu as a generator: each ``next()`` is one step
    of the warp (the aggregate's publish, one window of WINDOW statuses read
    as the state stands, lane l the tile l back, the inclusive publish); it
    returns the exclusive prefix."""
    valid = epoch << 2
    prefix = 1
    if tile > 0:
        state.aggregate[j, tile] = own
        state.status[j, tile] = valid | AGGREGATE
        yield
        nxt = tile - 1
        while True:
            seen = []
            for place in range(WINDOW):  # lane l reads the tile l back
                i = nxt - place
                s = int(state.status[j, i]) if i >= 0 else valid | INCLUSIVE
                ready = s & ~3 == valid
                seen.append((i, ready, ready and s & 3 == INCLUSIVE))
            waiting = [p for p, (_, ready, _) in enumerate(seen) if not ready]
            found = [p for p, (_, _, incl) in enumerate(seen) if incl]
            first_waiting = waiting[0] if waiting else WINDOW
            first_found = found[0] if found else WINDOW
            take = first_found + 1 if first_found < first_waiting else first_waiting
            for i, _, incl in seen[:take]:
                if i >= 0:
                    prefix = prefix * int((state.inclusive if incl else state.aggregate)[j, i]) % P
            if first_found < first_waiting:
                break
            state.whole_windows += take == WINDOW
            nxt -= take
            yield  # the warp reads the window again (or the next one) later
        yield
    state.inclusive[j, tile] = prefix * own % P
    state.status[j, tile] = valid | INCLUSIVE
    return prefix


def _warp_steps(state, challenges, tile, own, epoch):
    """A warp's look-backs, one after another: ``challenges`` (those j with j
    mod warps its own) as perm_z_kernel assigns them; returns {j: prefix}."""
    prefixes = {}
    for j in challenges:
        prefixes[j] = yield from _look_back_steps(state, j, tile, int(own[j, tile]), epoch)
    return prefixes


def _perm_z_walk(work, n, plan, words, epoch, rng, resident, seen=None):
    """One launch of the variant under ``plan`` (``one_pass.plan``), its tiles' ``work``
    (``_tile_work``, the same in every launch of the same inputs), on the look-back state
    ``words`` (left as the launch leaves it), with ``epoch``: blocks draw
    tickets in order while fewer than ``resident`` run, and at every step a
    seeded choice among drawing the next tile and a step of a running
    tile's warp that looks back (``_warp_steps``: warp w takes the
    challenges j = w mod the tile's warps, so a tile of 32 columns walks
    both in its one warp), so tiles finish in a shuffled order and each
    reads the state as it stands then.  With ``rng`` None every tile is
    drawn first and then the running tiles' warps step in sweeps from the
    last tile down (each publishes its aggregate in the first sweep, so the
    last tiles walk back over whole windows of aggregates).  A finished
    tile writes Z = prefix x its exclusive in-block product and p_k = Z
    rat_pref[k]: (challenges * m, n) rows.  ``seen["whole_windows"]`` (a dict
    if given) counts the look-back steps that took a whole window."""
    kept, excl, own = work
    nc, m, B = own.shape[0], plan["m"], plan["grid"]
    warps = plan["tile"] // 32
    own = gl.to_u64(own)
    state = _State(words)
    assert state.cap >= B
    base = int(words[0])
    running, prefix, finished = {}, np.zeros((nc, B), dtype=object), []
    sweep = []
    while len(finished) < B:
        can_draw = len(running) < resident and base + B > int(words[0])
        if rng is None:
            sweep = sweep or [(t, w) for t in sorted(running, reverse=True) for w in running[t]]
            pick = len(running) if can_draw else None
        else:
            pick = int(rng.integers(0, len(running) + can_draw))
        if pick == len(running):
            tile = state.draw() - base
            assert 0 <= tile < B  # the kernel traps otherwise
            running[tile] = {w: _warp_steps(state, range(w, nc, warps), tile, own, epoch)
                             for w in range(min(nc, warps))}
            continue
        if rng is None:
            tile, w = sweep.pop(0)
            if w not in running.get(tile, ()):
                continue
        else:
            tile = sorted(running)[pick]
            w = int(rng.choice(sorted(running[tile])))
        try:
            next(running[tile][w])
        except StopIteration as done:
            for j, p in done.value.items():
                prefix[j, tile] = p
            del running[tile][w]
            if not running[tile]:
                del running[tile]
                finished.append(tile)
    out = torch.zeros((nc * m, n), dtype=torch.int64)
    pre = gl.from_u64(np.array(prefix.tolist(), dtype=np.uint64))
    for j in range(nc):
        z = mul(pre[j][:, None], excl[j]).reshape(-1)
        out[j * m] = z[:n]
        for kk in range(m - 1):
            out[j * m + 1 + kk] = mul(z, kept[j][kk])[:n]
    assert int(words[0]) == base + B and sorted(finished) == list(range(B))
    assert (state.status[:nc, :B] == np.uint64(epoch << 2 | INCLUSIVE)).all()
    if seen is not None:
        seen["whole_windows"] = state.whole_windows
    return out, finished


# three launches in turn on one state, each a seeded order: every block
# resident at once, four, two
ORDERS = ((1, 1 << 30), (2, 4), (3, 2))


@pytest.mark.parametrize("log_n", [4, 6, 8, 10, 11])
@pytest.mark.parametrize("nr,cs,challenges,tile", [
    (80, 8, 2, 256), (80, 8, 1, 256), (16, 2, 2, 256), (8, 8, 2, 256),
    (128, 8, 2, 128), (256, 8, 2, 64), (256, 4, 1, 64), (256, 4, 2, 32),
])
def test_perm_z_walk_equals_the_plain_version(nr, cs, challenges, log_n, tile):
    """The one pass, walked under ``one_pass.plan``, whose tile of
    256, 128, 64 or 32 columns the chunk count m sets (n = 16 is less than a
    tile; 2048 is 8 to 64 tiles, past a window of 32): three launches in turn
    on one look-back state (``ORDERS``: tiles finishing in three seeded
    orders, the state left by the launch before), each against the plain
    ``_perm_core`` of each challenge and the JAX package's; a den chunk of
    every challenge is zero in a later tile than the first, and one of the
    last challenge at the last column but one."""
    n = 1 << log_n
    m = nr // cs
    zeros = [(j, (j * 3) % m, (n * (2 + j)) // 5) for j in range(challenges)] + [
        (challenges - 1, m - 1, n - 2)]
    inputs = _perm_inputs(nr, cs, n, challenges, 7 * log_n + nr, zeros)
    plan = one_pass.plan(nr, n, cs, challenges)
    assert plan["tile"] == tile
    f = [gl.from_u64(a) for a in inputs]
    want = _plain_rows(*inputs, cs)
    assert np.array_equal(gl.to_u64(want), _jax_rows(*inputs, cs))
    work = _tile_work(*f, cs, plan)
    words = np.zeros(plan["state_words"], dtype=np.uint64)
    for epoch, resident in ORDERS:
        got, _ = _perm_z_walk(work, n, plan, words, epoch,
                              np.random.default_rng(epoch * 100 + log_n), resident)
        assert torch.equal(got, want)
    z = gl.to_u64(want)
    assert z[0, 0] == 1 and z[0, -1] == 0  # the zero den chunk ends the grand product


@pytest.mark.parametrize("nr,cs,challenges,log_n", [
    (80, 8, 2, 11), (256, 4, 2, 11), (16, 2, 1, 8), (128, 8, 2, 4)])
def test_perm_z_walk_with_zeros_in_the_first_tile(nr, cs, challenges, log_n):
    """As above with challenge 0's first den chunk zero at column 5, in the
    first tile (its Z is 0 from column 6 on, through every tile), and the
    second challenge's last chunk zero at the last column but one."""
    n = 1 << log_n
    m = nr // cs
    zeros = [(0, 0, 5)] + ([(1, m - 1, n - 2)] if challenges == 2 else [])
    inputs = _perm_inputs(nr, cs, n, challenges, log_n + nr, zeros)
    plan = one_pass.plan(nr, n, cs, challenges)
    f = [gl.from_u64(a) for a in inputs]
    want = _plain_rows(*inputs, cs)
    assert np.array_equal(gl.to_u64(want), _jax_rows(*inputs, cs))
    work = _tile_work(*f, cs, plan)
    words = np.zeros(plan["state_words"], dtype=np.uint64)
    for epoch, resident in ORDERS:
        got, _ = _perm_z_walk(work, n, plan, words, epoch, np.random.default_rng(epoch), resident)
        assert torch.equal(got, want)
    z = gl.to_u64(want)
    assert z[0, 5] != 0 and not z[0, 6:].any()
    if challenges == 2:
        assert z[m, n - 2] != 0 and z[m, n - 1] == 0


def test_perm_z_walk_past_a_window():
    """63 tiles of 32 columns (64 routed wires in chunks of 1, m = 64; 2,000
    columns, the last tile ragged), all resident at once: in sweeps from the last tile down (three launches on one
    state, the second in a seeded order), tiles walk back over whole windows
    of aggregates (WINDOW tiles) and take the next window, one warp looking
    back for both challenges; against the plain version, zeros in both."""
    n, nr, cs = 2000, 64, 1
    inputs = _perm_inputs(nr, cs, n, 2, 21, [(0, 17, 1100), (1, 63, 1990)])
    plan = one_pass.plan(nr, n, cs, 2)
    assert (plan["tile"], plan["grid"]) == (32, 63) and plan["grid"] > WINDOW + 1
    work = _tile_work(*[gl.from_u64(a) for a in inputs], cs, plan)
    words = np.zeros(plan["state_words"], dtype=np.uint64)
    want = _plain_rows(*inputs, cs)
    for epoch, rng in ((1, None), (2, np.random.default_rng(2)), (3, None)):
        seen = {}
        got, _ = _perm_z_walk(work, n, plan, words, epoch, rng, 1 << 30, seen)
        assert torch.equal(got, want)
        if rng is None:
            assert seen["whole_windows"] > 0


def test_perm_z_walk_orders_differ():
    """The seeded orders of ``ORDERS`` finish the tiles out of order, and not
    all alike (64 tiles of 32 columns)."""
    inputs = [gl.from_u64(a) for a in _perm_inputs(256, 4, 1 << 11, 2, 3, [])]
    plan = one_pass.plan(256, 1 << 11, 4, 2)
    work = _tile_work(*inputs, 4, plan)
    words = np.zeros(plan["state_words"], dtype=np.uint64)
    orders = [_perm_z_walk(work, 1 << 11, plan, words, epoch, np.random.default_rng(epoch),
                           resident)[1] for epoch, resident in ORDERS]
    assert all(order != sorted(order) for order in orders)
    assert len({tuple(order) for order in orders}) == len(orders)


@pytest.mark.parametrize("nr,cs,log_n", [(80, 8, 11), (256, 4, 11), (16, 2, 6), (256, 8, 10)])
def test_perm_z_walk_ignores_a_stale_state(nr, cs, log_n):
    """A state left by earlier launches (other inputs over more tiles, so
    every status of this launch's tiles reads inclusive with another value;
    words of older epochs; the ticket counter anywhere) reads as not yet
    published: the launch after it equals the plain version and the JAX
    package's."""
    n = 1 << log_n
    m = nr // cs
    inputs = _perm_inputs(nr, cs, n, 2, nr + log_n, [(1, m - 1, n // 3)])
    plan = one_pass.plan(nr, n, cs, 2)
    wide = one_pass.plan(nr, 2 * n, cs, 2)
    words = np.zeros(wide["state_words"], dtype=np.uint64)
    state = _State(words)
    rng = np.random.default_rng(log_n)
    state.status[:] = rng.integers(0, 5, size=state.status.shape, dtype=np.uint64) << np.uint64(2)
    state.status[:] |= rng.integers(1, 3, size=state.status.shape, dtype=np.uint64)
    state.aggregate[:] = _rand(state.aggregate.shape, 1)
    state.inclusive[:] = _rand(state.inclusive.shape, 2)
    words[0] = np.uint64(123_456_789)
    other = [gl.from_u64(a) for a in _perm_inputs(nr, cs, 2 * n, 2, 99, [])]
    _perm_z_walk(_tile_work(*other, cs, wide), 2 * n, wide, words, 5, rng, 8)  # epoch 5
    assert (state.status[:, : plan["grid"]] == np.uint64(5 << 2 | INCLUSIVE)).all()
    f = [gl.from_u64(a) for a in inputs]
    got, _ = _perm_z_walk(_tile_work(*f, cs, plan), n, plan, words, 6, rng, 3)
    want = _plain_rows(*inputs, cs)
    assert torch.equal(got, want)
    assert np.array_equal(gl.to_u64(got), _jax_rows(*inputs, cs))


def test_perm_z_state_is_kept_and_grows():
    """``one_pass.state``: one state a device and stream, kept between
    launches; a launch of more tiles than it holds makes a larger one (zeroed
    once) and the epochs go on; the wrapper draws ``grid`` tickets a launch."""
    one_pass._states.clear()
    dev = torch.device("cpu")
    first = one_pass.state(dev, 7, 16)
    assert first["words"].shape == (one_pass.state_words(16),) and not first["words"].any()
    assert (first["cap"], first["tickets"], first["epoch"]) == (16, 0, 0)
    first["tickets"], first["epoch"] = 32, 2  # two launches of 16 tiles
    assert one_pass.state(dev, 7, 12) is first
    assert one_pass.state(dev, 8, 12) is not first  # another stream
    grown = one_pass.state(dev, 7, 40)
    assert (grown["cap"], grown["tickets"], grown["epoch"]) == (40, 0, 2)
    assert one_pass.state(dev, 7, 40) is grown
    one_pass._states.clear()


def test_perm_z_walk_without_zeros_closes_on_a_satisfied_permutation():
    """With sigma the identity's encoding (k_i omega^x) every ratio is 1: Z
    and every partial are 1, through every tile boundary (m = 32: tiles of
    64 columns)."""
    n, nr, cs = 512, 128, 4
    omega = gl.primitive_root_of_unity(9)
    k_shifts = np.array([pow(7, i, P) for i in range(nr)], dtype=np.uint64)
    omega_pows = np.array([pow(omega, x, P) for x in range(n)], dtype=np.uint64)
    sigma = np.array([[int(k) * int(o) % P for o in omega_pows] for k in k_shifts], dtype=np.uint64)
    f = gl.from_u64
    plan = one_pass.plan(nr, n, cs, 2)
    assert (plan["tile"], plan["grid"]) == (64, 8)
    words = np.zeros(plan["state_words"], dtype=np.uint64)
    work = _tile_work(f(_rand((nr, n), 3)), f(sigma), f(omega_pows), f(k_shifts),
                      f(_rand((2,), 4)), f(_rand((2,), 5)), cs, plan)
    got, _ = _perm_z_walk(work, n, plan, words, 1, np.random.default_rng(0), 1 << 30)
    assert torch.equal(got, torch.ones_like(got))


def test_variant_holds_the_limits_of_the_main_path():
    """perm_z_one_pass.cu takes the same limits as csrc/field.cu (its copy
    of the constants) and its plan refuses what ``kernels.perm_z_plan``
    refuses."""
    import re

    with open(one_pass.SOURCE) as f:
        consts = {m.group(1): int(m.group(2))
                  for m in re.finditer(r"constexpr int (\w+) = (\d+);", f.read())}
    assert (consts["PERM_CHALLENGES"], consts["PERM_MAX_ROUTED"], consts["PERM_MAX_CHUNKS"],
            consts["PERM_Z_MAX_THREADS"]) == (kernels.PERM_CHALLENGES, kernels.PERM_MAX_ROUTED,
                                              kernels.PERM_MAX_CHUNKS, one_pass.THREADS)
    for args in [(81, 1 << 10, 8, 2), (264, 1 << 10, 8, 2), (256, 1 << 10, 2, 2),
                 (80, 1 << 10, 0, 2), (80, 0, 8, 2), (80, 1 << 10, 8, 3)]:
        with pytest.raises(ValueError):
            one_pass.plan(*args)


def test_one_pass_plan_sizes():
    plan = one_pass.plan(80, 1 << 18, 8, 2)
    assert (plan["m"], plan["tile"], plan["grid"]) == (10, 256, 1024)
    assert plan["shared_bytes"] == 2 * 2 * 10 * 256 * 8 <= one_pass.SHARED_TARGET
    assert plan["state_words"] == 1 + 3 * 2 * 1024 == one_pass.state_words(1024)
    wide = one_pass.plan(256, 1 << 12, 4, 2)  # m = 64: one warp a tile
    assert (wide["m"], wide["tile"], wide["grid"], wide["shared_bytes"]) == (64, 32, 128, 65536)
    assert one_pass.plan(80, 1000, 8, 1)["grid"] == 4  # a ragged last tile


@pytest.mark.cuda
@pytest.mark.parametrize("routed,chunk,log_n", [(80, 8, 12), (256, 4, 14)])
def test_one_pass_kernel_matches_the_main_path(routed, chunk, log_n):
    """On the card: the variant's words equal ``kernels.perm_z``'s, twice on
    one look-back state (256 routed wires in chunks of 4: tiles of 32
    columns, one warp looking back for both challenges)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import chip_smoke

    n = 1 << log_n
    m = routed // chunk
    inputs = chip_smoke.perm_z_inputs(np.random.default_rng(log_n), log_n,
                                      ((0, 1, n // 3), (1, m - 1, n - 2)), routed, chunk)
    want = kernels.perm_z(*inputs)
    assert torch.equal(one_pass.perm_z_one_pass(*inputs), want)
    assert torch.equal(one_pass.perm_z_one_pass(*inputs), want)
