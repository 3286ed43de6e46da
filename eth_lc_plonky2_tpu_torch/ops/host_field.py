"""Host-side (numpy uint64) Goldilocks field ops.

Copy of ``eth_lc_plonky2_tpu/ops/host_field.py`` (the port keeps its own).
Used off the hot path: the circuit builder's tables, the prover's domain
tables, witness generation, and as an independent reference for the int64
tensor field in ``ops/goldilocks.py``.

numpy's uint64 arithmetic wraps mod 2^64, which is exactly what the
limb algorithms need.  32x32 partial products fit a u64 exactly, so
multiplication needs no 16-bit split here.
"""

from __future__ import annotations

import functools

import numpy as np


def _wrapping(fn):
    """u64 wraparound is intended here; silence numpy's overflow warning
    (it fires on 0-d/scalar operands and pollutes every CLI/bench tail)."""

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with np.errstate(over="ignore"):
            return fn(*args, **kwargs)

    return inner

P = 0xFFFF_FFFF_0000_0001
EPSILON = np.uint64(0xFFFF_FFFF)  # 2^64 mod p
_P64 = np.uint64(P)
_MASK32 = np.uint64(0xFFFF_FFFF)
_32 = np.uint64(32)
_0 = np.uint64(0)
_1 = np.uint64(1)


def asfield(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64) % _P64


@_wrapping
def add(a, b):
    """(a + b) mod p for canonical uint64 arrays."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    s = a + b
    carry = s < a
    # carry: +2^64 ≡ +EPSILON; else subtract p if >= p.  a+b < 2p so once is enough.
    over = carry | (s >= _P64)
    return np.where(over, s - _P64, s)  # s - p wraps to s + EPSILON on carry


@_wrapping
def sub(a, b):
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    d = a - b
    borrow = a < b
    return np.where(borrow, d + _P64, d)  # wraps to d - EPSILON


@_wrapping
def neg(a):
    a = np.asarray(a, dtype=np.uint64)
    return np.where(a == _0, _0, _P64 - a)


@_wrapping
def _mul64_wide(a, b):
    """Full 64x64 -> 128 product as (lo64, hi64) uint64 arrays."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    a0 = a & _MASK32
    a1 = a >> _32
    b0 = b & _MASK32
    b1 = b >> _32
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = p01 + (p00 >> _32)  # < 2^64, no wrap
    mid2 = mid + (p10 & _MASK32)
    lo = (p00 & _MASK32) | (mid2 << _32)
    hi = p11 + (mid2 >> _32) + (p10 >> _32)
    return lo, hi


@_wrapping
def _reduce128(lo, hi):
    """Reduce (hi:lo) mod p, canonical, vectorized."""
    hi_hi = hi >> _32  # r3
    hi_lo = hi & _MASK32  # r2
    t = lo - hi_hi
    t = np.where(lo < hi_hi, t - EPSILON, t)  # cannot double-borrow
    u = hi_lo * EPSILON  # fits u64
    s = t + u
    carry = s < t
    s = np.where(carry, s + EPSILON, s)
    return np.where(s >= _P64, s - _P64, s)


def mul(a, b):
    lo, hi = _mul64_wide(a, b)
    return _reduce128(lo, hi)


def square(a):
    return mul(a, a)


def pow_const(a, e: int):
    """a ** e (fixed python-int exponent), vectorized."""
    a = np.asarray(a, dtype=np.uint64)
    result = np.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            result = mul(result, base)
        base = mul(base, base)
        e >>= 1
    return result


def inv(a):
    return pow_const(a, P - 2)


def batch_inv(a):
    """Montgomery batch inversion: one inversion for N elements."""
    a = np.asarray(a, dtype=np.uint64).ravel()
    n = a.size
    if n == 0:
        return a
    with np.errstate(over="ignore"):
        prefix = np.empty(n, dtype=np.uint64)
        acc = np.uint64(1)
        for i in range(n):
            prefix[i] = acc
            acc = mul(acc, a[i])
        acc_inv = inv(acc)
        out = np.empty(n, dtype=np.uint64)
        for i in range(n - 1, -1, -1):
            out[i] = mul(acc_inv, prefix[i])
            acc_inv = mul(acc_inv, a[i])
    return out


@_wrapping
def powers(base: int, n: int) -> np.ndarray:
    """[1, base, base^2, ..., base^(n-1)] as uint64, via log-doubling."""
    out = np.ones(n, dtype=np.uint64)
    if n <= 1:
        return out
    out[1] = np.uint64(base % P)
    filled = 2
    while filled < n:
        take = min(filled, n - filled)
        out[filled : filled + take] = mul(out[filled - 1], mul(out[1], out[:take]))
        filled += take
    return out
