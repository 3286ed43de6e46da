"""Poseidon permutation (width 12, Goldilocks) and sponge, on int64 tensors.

Port of ``eth_lc_plonky2_tpu/ops/poseidon.py``: the same parameters
(t = 12, 4 + 22 + 4 rounds, S-box x^7, MDS circulant(MDS_CIRC) +
diag(MDS_DIAG)) and the same Grain-LFSR round constants, so digests are
bit-identical to the JAX package's.  The constant generator is a copy,
because the original module imports jax.

Layouts at the public functions match the JAX package: a state batch is
(..., 12); ``hash_no_pad`` maps (..., L) inputs to (..., 4) digests;
``compress`` maps two (..., 4) digests to one.

A CUDA input runs the hand-written sponge ``csrc/poseidon.cu`` (through
``kernels.poseidon_sponge``), reading the (N, L) view through its strides,
so a transposed channel-first LDE is hashed without a copy.  A CPU input
runs the plain PyTorch version below, channel-first (12, N).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import goldilocks as gl
from . import host_field as hf
from . import kernels

P = gl.P

WIDTH = 12
N_FULL_ROUNDS = 8  # 4 + 4
N_PARTIAL_ROUNDS = 22
N_ROUNDS = N_FULL_ROUNDS + N_PARTIAL_ROUNDS
SPONGE_RATE = 8
SPONGE_CAPACITY = 4
DIGEST_LEN = 4

MDS_CIRC = [17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20]
MDS_DIAG = [8] + [0] * 11


# ---------------------------------------------------------------------------
# Round-constant generation (Grain LFSR, Poseidon reference construction)
# ---------------------------------------------------------------------------


def _grain_bits(field_bits: int, sbox_bits: int, n: int, t: int, r_f: int, r_p: int):
    """Yield the Grain LFSR keystream (after the shrinking step)."""
    state = []

    def push(value, width):
        for i in range(width - 1, -1, -1):
            state.append((value >> i) & 1)

    push(field_bits, 2)
    push(sbox_bits, 4)
    push(n, 12)
    push(t, 12)
    push(r_f, 10)
    push(r_p, 10)
    push((1 << 30) - 1, 30)

    def clock():
        new = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):
        clock()
    while True:
        b1 = clock()
        b2 = clock()
        if b1 == 1:
            yield b2


@functools.lru_cache(maxsize=None)
def round_constants() -> np.ndarray:
    """All N_ROUNDS * WIDTH round constants as uint64 (canonical)."""
    gen = _grain_bits(0b01, 0b0000, 64, WIDTH, N_FULL_ROUNDS, N_PARTIAL_ROUNDS)
    out = []
    while len(out) < N_ROUNDS * WIDTH:
        v = 0
        for _ in range(64):
            v = (v << 1) | next(gen)
        if v < P:
            out.append(v)
    return np.array(out, dtype=np.uint64)


def mds_matrix() -> list:
    """The dense MDS matrix as Python integers: out[r] = sum_i M[r][i] * state[i]."""
    m = [[0] * WIDTH for _ in range(WIDTH)]
    for r in range(WIDTH):
        for i in range(WIDTH):
            m[r][(r + i) % WIDTH] += MDS_CIRC[i]
        m[r][r] += MDS_DIAG[r]
    return m


# ---------------------------------------------------------------------------
# Sparse form of the partial rounds (Python integers mod p)
# ---------------------------------------------------------------------------


def _mat_mul(a, b):
    return [[sum(x * y for x, y in zip(row, col)) % P for col in zip(*b)] for row in a]


def _mat_vec(a, v):
    return [sum(x * y for x, y in zip(row, v)) % P for row in a]


def _mat_inv(a):
    """Inverse of a square matrix mod p by Gauss-Jordan elimination."""
    n = len(a)
    aug = [[x % P for x in row] + [int(i == j) for j in range(n)] for i, row in enumerate(a)]
    for col in range(n):
        piv = next(r for r in range(col, n) if aug[r][col])
        aug[col], aug[piv] = aug[piv], aug[col]
        scale = pow(aug[col][col], P - 2, P)
        aug[col] = [x * scale % P for x in aug[col]]
        for r in range(n):
            if r != col and aug[r][col]:
                f = aug[r][col]
                aug[r] = [(x - f * y) % P for x, y in zip(aug[r], aug[col])]
    return [row[n:] for row in aug]


@dataclasses.dataclass(frozen=True)
class SparsePartialRounds:
    """The 22 partial rounds in the sparse form of the Poseidon paper's
    appendix B, as plonky2's prover runs them.  With s the state after the
    first four full rounds:

        s += first_constants;  s[1:] = init_matrix @ s[1:]
        for r in range(22):
            s[0] = sbox(s[0]) + scalars[r]
            s[0], s[1:] = (m00 * s[0] + w_hat[r] . s[1:]), s[1:] + v[r] * s[0]

    (both right-hand sides of the last line read the s[0] of the line
    above).  It is the same permutation as 22 rounds of add-constants,
    S-box on s[0], dense MDS.
    """

    first_constants: tuple  # 12
    init_matrix: tuple  # 11 x 11
    scalars: tuple  # 22, the last is 0
    m00: int
    w_hat: tuple  # 22 x 11
    v: tuple  # 22 x 11


@functools.lru_cache(maxsize=None)
def sparse_partial_rounds() -> SparsePartialRounds:
    """Derive the sparse tables from MDS_CIRC, MDS_DIAG and round_constants().

    Constants: a vector added before round r+1's S-box equals M^-1 of it
    added before round r's MDS; its word 0 stays there as a scalar, the
    other eleven commute with the S-box (which only touches word 0) and
    join round r's constants.  Folding from the last partial round back
    leaves one vector before the first round and one scalar after each
    S-box.
    Matrices: M = [[m00, w], [v, Mh]] factors as [[m00, w Mh^-1], [v, I]]
    times diag(1, Mh); diag(1, Mh) commutes with the scalar add and the
    S-box before it, so it joins the previous round's matrix.  Folding
    back leaves one diag(1, init_matrix) before the first partial round.
    """
    half = N_FULL_ROUNDS // 2
    rc = [[int(c) for c in row] for row in round_constants().reshape(N_ROUNDS, WIDTH)]
    rc = rc[half : half + N_PARTIAL_ROUNDS]
    m = mds_matrix()
    m_inv = _mat_inv(m)
    scalars = [0] * N_PARTIAL_ROUNDS
    vec = rc[-1]
    for r in range(N_PARTIAL_ROUNDS - 2, -1, -1):
        u = _mat_vec(m_inv, vec)
        scalars[r] = u[0]
        vec = [rc[r][0]] + [(c + x) % P for c, x in zip(rc[r][1:], u[1:])]
    first = vec
    w_hat, v = [None] * N_PARTIAL_ROUNDS, [None] * N_PARTIAL_ROUNDS
    cur = m
    for r in range(N_PARTIAL_ROUNDS - 1, -1, -1):
        m_hat = [row[1:] for row in cur[1:]]
        w_hat[r] = _mat_mul([cur[0][1:]], _mat_inv(m_hat))[0]
        v[r] = [row[0] for row in cur[1:]]
        lift = [[int(i == j) for j in range(WIDTH)] for i in range(WIDTH)]
        for i in range(WIDTH - 1):
            lift[i + 1][1:] = m_hat[i]
        cur = _mat_mul(lift, m)
    freeze = lambda rows: tuple(tuple(row) for row in rows)  # noqa: E731
    return SparsePartialRounds(first_constants=tuple(first), init_matrix=freeze(m_hat),
                               scalars=tuple(scalars), m00=m[0][0], w_hat=freeze(w_hat),
                               v=freeze(v))


@functools.lru_cache(maxsize=None)
def kernel_constants() -> bytes:
    """The sponge kernel's constant image, in ``csrc/poseidon.cu``'s struct
    order: u64 round constants of the 8 full rounds, then the sparse
    partial-round tables (first constants, 11 x 11 initial matrix, 22
    scalars, 22 x 12 rows [m00, w_hat], 22 x 11 columns v), then as 32-bit
    words the sums MDS_CIRC[i] + MDS_CIRC[i + 6] and differences MDS_CIRC[i] -
    MDS_CIRC[i + 6] (the kernel's split of the circulant layer), MDS_DIAG[0]
    and a zero (the kernel takes the rest of the diagonal to be zero)."""
    if any(MDS_DIAG[1:]):
        raise ValueError("csrc/poseidon.cu takes MDS_DIAG[1:] to be zero")
    half = N_FULL_ROUNDS // 2
    rc = round_constants().reshape(N_ROUNDS, WIDTH)
    sp = sparse_partial_rounds()
    words = [int(c) for c in np.concatenate([rc[:half], rc[half + N_PARTIAL_ROUNDS:]]).ravel()]
    words += sp.first_constants
    words += [x for row in sp.init_matrix for x in row]
    words += sp.scalars
    words += [x for row in sp.w_hat for x in (sp.m00, *row)]
    words += [x for row in sp.v for x in row]
    half_row = WIDTH // 2
    return (np.asarray(words, dtype=np.uint64).tobytes()
            + np.asarray([MDS_CIRC[i] + MDS_CIRC[i + half_row] for i in range(half_row)]
                         + [MDS_CIRC[i] - MDS_CIRC[i + half_row] for i in range(half_row)],
                         dtype=np.int32).tobytes()
            + np.asarray([MDS_DIAG[0], 0], dtype=np.uint32).tobytes())


@functools.lru_cache(maxsize=None)
def _rc_on(device: str) -> torch.Tensor:
    return gl.from_u64(round_constants().reshape(N_ROUNDS, WIDTH), device)


@functools.lru_cache(maxsize=None)
def _mds_on(device: str) -> torch.Tensor:
    """(12, 12, 1) int64 MDS matrix: out[r] = sum_i M[r, i] * state[i]."""
    return torch.tensor(mds_matrix(), dtype=torch.int64)[:, :, None].to(device)


# ---------------------------------------------------------------------------
# Plain permutation (channel-first (12, N))
# ---------------------------------------------------------------------------


def _sbox(x):
    x2 = gl.square_plain(x)
    x3 = gl.mul_plain(x2, x)
    return gl.mul_plain(gl.square_plain(x3), x)


def _mds_cf(st):
    """MDS on 32-bit halves: each row of M sums to 264, so each sum is < 2^41."""
    m = _mds_on(str(st.device))
    acc_lo = (m * (st & 0xFFFF_FFFF)[None]).sum(1)
    acc_hi = (m * gl._hi32(st)[None]).sum(1)
    lo128 = acc_lo + (acc_hi << 32)
    hi128 = (acc_hi >> 32) + gl._ult(lo128, acc_lo).long()
    return gl._reduce128(lo128, hi128)


def _permute_cf(st: torch.Tensor) -> torch.Tensor:
    rc = _rc_on(str(st.device))
    half = N_FULL_ROUNDS // 2
    for r in range(N_ROUNDS):
        st = gl.add_plain(st, rc[r][:, None])
        if half <= r < half + N_PARTIAL_ROUNDS:
            st = torch.cat([_sbox(st[:1]), st[1:]], 0)
        else:
            st = _sbox(st)
        st = _mds_cf(st)
    return st


@functools.lru_cache(maxsize=None)
def _sparse_on(device: str):
    """The sparse tables as field tensors: first (12, 1), init (11, 11, 1),
    scalars (22,), rows (22, 12, 1) = [m00, w_hat], cols (22, 11, 1) = v."""
    sp = sparse_partial_rounds()
    col = lambda x: gl.from_u64(np.asarray(x, dtype=np.uint64), device)  # noqa: E731
    rows = [(sp.m00, *row) for row in sp.w_hat]
    return (col(sp.first_constants)[:, None], col(sp.init_matrix)[:, :, None], col(sp.scalars),
            col(rows)[:, :, None], col(sp.v)[:, :, None])


def _dot(rows, st):
    """sum_i rows[..., i, 1] * st[i, N] over the field, term by term."""
    acc = gl.mul_plain(rows[..., 0, :], st[0])
    for i in range(1, st.shape[0]):
        acc = gl.add_plain(acc, gl.mul_plain(rows[..., i, :], st[i]))
    return acc


def _permute_sparse_cf(st: torch.Tensor) -> torch.Tensor:
    """The permutation with the partial rounds in sparse form: the arithmetic
    of ``csrc/poseidon.cu``, on plain tensor ops.  Equal to ``_permute_cf``."""
    rc = _rc_on(str(st.device))
    first, init, scalars, rows, cols = _sparse_on(str(st.device))
    half = N_FULL_ROUNDS // 2
    for r in range(half):
        st = _mds_cf(_sbox(gl.add_plain(st, rc[r][:, None])))
    st = gl.add_plain(st, first)
    st = torch.cat([st[:1], _dot(init, st[1:])], 0)
    for r in range(N_PARTIAL_ROUNDS):
        s0 = gl.add_plain(_sbox(st[0]), scalars[r])
        st = torch.cat([_dot(rows[r], torch.cat([s0[None], st[1:]], 0))[None],
                        gl.add_plain(st[1:], gl.mul_plain(cols[r], s0[None]))], 0)
    for r in range(half + N_PARTIAL_ROUNDS, N_ROUNDS):
        st = _mds_cf(_sbox(gl.add_plain(st, rc[r][:, None])))
    return st


def permute(state: torch.Tensor, sparse: bool = False) -> torch.Tensor:
    """Poseidon permutation of a (..., 12) state batch (plain version).

    ``sparse`` runs the partial rounds on the sparse tables the CUDA kernel
    uses; the result is the same.
    """
    batch = state.shape[:-1]
    st = state.reshape(-1, WIDTH).T
    return (_permute_sparse_cf if sparse else _permute_cf)(st).T.reshape(*batch, WIDTH)


def _hash_plain(x: torch.Tensor, permute_cf=_permute_cf) -> torch.Tensor:
    """(N, L) -> (N, 4): overwrite-mode sponge, rate 8, no padding."""
    n, length = x.shape
    st = torch.zeros((WIDTH, n), dtype=torch.int64, device=x.device)
    for start in range(0, length, SPONGE_RATE):
        chunk = x[:, start : start + SPONGE_RATE].T
        st = permute_cf(torch.cat([chunk, st[chunk.shape[0]:]], 0))
    return st[:DIGEST_LEN].T.contiguous()


# ---------------------------------------------------------------------------
# Public hashing
# ---------------------------------------------------------------------------


def hash_no_pad(inputs: torch.Tensor) -> torch.Tensor:
    """Hash (..., L) field elements to (..., 4) digests.

    Each rate-8 chunk overwrites state[0:len(chunk)] and the state is
    permuted (plonky2 hash_n_to_m_no_pad); the last chunk may be short.
    """
    batch, length = inputs.shape[:-1], inputs.shape[-1]
    x = inputs if inputs.dim() == 2 else inputs.reshape(-1, length)
    if kernels.on_card(x):
        out = kernels.poseidon_sponge(x, kernel_constants())
    else:
        out = _hash_plain(x)
    return out.reshape(*batch, DIGEST_LEN)


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Two-to-one compression: permute [left || right || 0^4], keep 4 words.

    This equals the 8-input sponge from the zero state.
    """
    return hash_no_pad(torch.cat([left, right], dim=-1))


def compress_level(level: torch.Tensor) -> torch.Tensor:
    """One Merkle level (2M, 4) -> (M, 4), pairs (2i, 2i+1).

    [left || right] of pair i is row i of the contiguous (M, 8) view, so
    the sponge reads the level directly.
    """
    return hash_no_pad(level.reshape(-1, 2 * DIGEST_LEN))


# A level of at most this many pairs, and every level above it, is left to
# ``compress_tail``: one block of the card runs them in one launch.
TAIL_MAX_PAIRS = 256


def compress_tail(level: torch.Tensor, num_levels: int) -> list:
    """The next ``num_levels`` Merkle levels above ``level`` (2M, 4), as a list
    [(M, 4), (M/2, 4), ...].  On the card they come from one launch."""
    if kernels.on_card(level):
        return kernels.merkle_tail(level, num_levels, kernel_constants())
    out = []
    for _ in range(num_levels):
        level = compress_level(level)
        out.append(level)
    return out


# ---------------------------------------------------------------------------
# Host mirrors on Python integers (the transcript and the PoW check)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _host_tables() -> tuple:
    """(round constants, MDS rows) as tuples of Python integers."""
    return (tuple(int(c) for c in round_constants()), tuple(tuple(row) for row in mds_matrix()))


def permute_host(state64: list) -> list:
    """The permutation of one width-12 state, on Python integers."""
    rc, m = _host_tables()
    s = [x % P for x in state64]
    half = N_FULL_ROUNDS // 2
    for r in range(N_ROUNDS):
        s = [(x + rc[r * WIDTH + i]) % P for i, x in enumerate(s)]
        if half <= r < half + N_PARTIAL_ROUNDS:
            s[0] = pow(s[0], 7, P)
        else:
            s = [pow(x, 7, P) for x in s]
        s = [sum(c * x for c, x in zip(row, s)) % P for row in m]
    return s


def hash_no_pad_host(inputs: list) -> list:
    """Host mirror of hash_no_pad (one input vector) -> 4-element digest."""
    state = [0] * WIDTH
    for start in range(0, len(inputs), SPONGE_RATE):
        chunk = inputs[start : start + SPONGE_RATE]
        state[: len(chunk)] = [x % P for x in chunk]
        state = permute_host(state)
    return state[:DIGEST_LEN]


def compress_host(left: list, right: list) -> list:
    """Host mirror of compress (two 4-element digests)."""
    return permute_host(list(left) + list(right) + [0] * (WIDTH - 2 * DIGEST_LEN))[:DIGEST_LEN]


# ---------------------------------------------------------------------------
# Batched witness trace (for the in-circuit PoseidonGate)
# ---------------------------------------------------------------------------


def permute_trace_np(states: np.ndarray):
    """Vectorized permutation trace for witness generation.

    states: (N, 12) u64.  Returns (advice, out): advice (N, 118) holds
    every s-box output in round order (full 4x12, partial 22x1, full
    4x12); out (N, 12) is the final state.  Mirrors the PoseidonGate
    wire layout in circuit/gates_poseidon.py.

    Small batches route to the Python-int path: numpy u64 scalar
    wide-muls are ~100x slower than int arithmetic at N ~ 1 (the
    recursion layer generates one row per sponge permutation).
    """
    if states.shape[0] < 64:
        return _permute_trace_host(states)

    rc = round_constants()
    n = states.shape[0]
    st = [states[:, i].astype(np.uint64) for i in range(WIDTH)]
    advice = []
    half = N_FULL_ROUNDS // 2
    ridx = 0

    def x7(x):
        x2 = hf.mul(x, x)
        x3 = hf.mul(x2, x)
        return hf.mul(hf.mul(x3, x3), x)

    def mds(v):
        out = []
        for r in range(WIDTH):
            acc = None
            for i in range(WIDTH):
                term = hf.mul(np.uint64(MDS_CIRC[i]), v[(r + i) % WIDTH])
                acc = term if acc is None else hf.add(acc, term)
            if MDS_DIAG[r]:
                acc = hf.add(acc, hf.mul(np.uint64(MDS_DIAG[r]), v[r]))
            out.append(acc)
        return out

    def add_rc(v):
        return [hf.add(x, np.uint64(rc[ridx * WIDTH + i])) for i, x in enumerate(v)]

    for _ in range(half):
        st = add_rc(st)
        for i in range(WIDTH):
            st[i] = x7(st[i])
            advice.append(st[i])
        st = mds(st)
        ridx += 1
    for _ in range(N_PARTIAL_ROUNDS):
        st = add_rc(st)
        st[0] = x7(st[0])
        advice.append(st[0])
        st = mds(st)
        ridx += 1
    for _ in range(half):
        st = add_rc(st)
        for i in range(WIDTH):
            st[i] = x7(st[i])
            advice.append(st[i])
        st = mds(st)
        ridx += 1
    adv = np.stack([np.broadcast_to(a, (n,)) for a in advice], axis=1)
    out = np.stack([np.broadcast_to(s, (n,)) for s in st], axis=1)
    return adv.astype(np.uint64), out.astype(np.uint64)


def _permute_trace_host(states: np.ndarray):
    """Python-int permutation trace (fast for small N)."""
    rc = [int(c) for c in round_constants()]
    circ = [int(c) for c in MDS_CIRC]
    diag0 = int(MDS_DIAG[0])
    half = N_FULL_ROUNDS // 2
    n = states.shape[0]
    adv = np.empty((n, N_FULL_ROUNDS * WIDTH + N_PARTIAL_ROUNDS), dtype=np.uint64)
    out = np.empty((n, WIDTH), dtype=np.uint64)
    for k in range(n):
        st = [int(v) for v in states[k]]
        a = 0
        ridx = 0

        def mds(v):
            res = []
            for r in range(WIDTH):
                acc = 0
                for i in range(WIDTH):
                    acc += circ[i] * v[(r + i) % WIDTH]
                if r == 0:
                    acc += diag0 * v[0]
                res.append(acc % P)
            return res

        for _ in range(half):
            base = ridx * WIDTH
            for i in range(WIDTH):
                x = (st[i] + rc[base + i]) % P
                x3 = x * x % P * x % P
                st[i] = x3 * x3 % P * x % P
                adv[k, a] = st[i]
                a += 1
            st = mds(st)
            ridx += 1
        for _ in range(N_PARTIAL_ROUNDS):
            base = ridx * WIDTH
            x = (st[0] + rc[base]) % P
            for i in range(1, WIDTH):
                st[i] = (st[i] + rc[base + i]) % P
            x3 = x * x % P * x % P
            st[0] = x3 * x3 % P * x % P
            adv[k, a] = st[0]
            a += 1
            st = mds(st)
            ridx += 1
        for _ in range(half):
            base = ridx * WIDTH
            for i in range(WIDTH):
                x = (st[i] + rc[base + i]) % P
                x3 = x * x % P * x % P
                st[i] = x3 * x3 % P * x % P
                adv[k, a] = st[i]
                a += 1
            st = mds(st)
            ridx += 1
        out[k] = st
    return adv, out
