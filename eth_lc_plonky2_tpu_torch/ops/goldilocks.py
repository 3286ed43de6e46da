"""Goldilocks field GF(p), p = 2^64 - 2^32 + 1, as plain PyTorch tensor ops.

Representation: a field tensor is ONE ``torch.int64`` tensor whose bits
are the canonical u64 value (< p).  Values >= 2^63 therefore read as
negative int64; every op below treats the bits as unsigned.  The JAX
package's (lo, hi) u32 pair exists only because the TPU lacks 64-bit
integers; the card has them, so the port does not carry it.

PyTorch's int64 add, sub, mul and left shift wrap mod 2^64, which is
what the algorithms need.  Three things differ from u64 arithmetic and
are handled explicitly:

* ``>>`` is arithmetic (sign-extending), so every right shift is masked;
* ``<`` is signed, so unsigned compares flip the sign bit first (``_ult``);
* ``torch.uint64`` has no add/sub/shift/compare on the CPU, so it is not used.

``add``, ``sub``, ``mul``, ``square``, ``neg``, ``mul_small`` and ``inv``
launch the hand-written ``csrc/field.cu`` for a CUDA tensor (XLA fuses these
ops for the JAX package; eager PyTorch would run some 35 launches a
multiplication) and run the ``*_plain`` tensor ops for a CPU tensor.  The
CPU tests use the plain versions, and ``chip_smoke.py`` holds the CUDA
kernels against them on the card.  The kernels' own field arithmetic is
``csrc/goldilocks.cuh``.
"""

from __future__ import annotations

import numpy as np
import torch

P = 0xFFFF_FFFF_0000_0001
EPSILON = 0xFFFF_FFFF  # 2^64 mod p
MULTIPLICATIVE_GENERATOR = 7
TWO_ADICITY = 32

_P_I64 = P - (1 << 64)  # p's bit pattern as int64 (= -EPSILON)
_SIGN = -(1 << 63)
_MASK32 = 0xFFFF_FFFF


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------


def from_u64(a, device=None) -> torch.Tensor:
    """numpy uint64 array (or ints) -> int64 field tensor (values reduced mod p).

    A conversion, not an entry point: the tensor is made on the host and
    moved to ``device`` when one is named.  The entry points that take host
    data (``commit_values``, ``build_merkle``) name the card by default.
    """
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint64) % np.uint64(P))
    if arr.shape != np.shape(a):  # numpy returns a 0-d input as shape (1,)
        arr = arr.reshape(np.shape(a))
    return torch.from_numpy(arr.view(np.int64)).to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 field tensor -> host numpy uint64 array."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


# ---------------------------------------------------------------------------
# Unsigned helpers on int64 bit patterns
# ---------------------------------------------------------------------------


def _ult(a, b):
    """a < b as unsigned 64-bit."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _hi32(a):
    """a >> 32 as unsigned (logical shift)."""
    return (a >> 32) & _MASK32


def _mul64_wide(a, b):
    """Full 64x64 -> 128 product as (lo64, hi64) int64 bit patterns.

    32x32 partial products fit a u64 and wrap correctly in int64; the
    sums below never exceed 2^64 - 1 as unsigned values.
    """
    a0, a1 = a & _MASK32, _hi32(a)
    b0, b1 = b & _MASK32, _hi32(b)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = p01 + _hi32(p00)
    mid2 = mid + (p10 & _MASK32)
    lo = (p00 & _MASK32) | (mid2 << 32)
    hi = p11 + _hi32(mid2) + _hi32(p10)
    return lo, hi


def _reduce128(lo, hi):
    """(hi:lo) mod p, canonical, using 2^64 = 2^32 - 1 and 2^96 = -1 (mod p)."""
    hi_hi = _hi32(hi)
    hi_lo = hi & _MASK32
    t = lo - hi_hi
    t = torch.where(_ult(lo, hi_hi), t - EPSILON, t)  # borrow: +p = -EPSILON mod 2^64
    u = hi_lo * EPSILON  # < 2^64, no wrap as unsigned
    s = t + u
    s = torch.where(_ult(s, t), s + EPSILON, s)  # carry: +2^64 = +EPSILON
    return torch.where(~_ult(s, _P_I64), s - _P_I64, s)


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int64, device=device)


def ones(shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.int64, device=device)


def full(shape, value: int, device) -> torch.Tensor:
    value %= P
    return torch.full(shape, value - (1 << 64) if value >> 63 else value,
                      dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# Plain field ops (inputs and outputs canonical): what a CPU tensor runs, and
# what ``csrc/field.cu`` is held against on the card
# ---------------------------------------------------------------------------


def add_plain(a, b):
    s = a + b
    over = _ult(s, a) | ~_ult(s, _P_I64)
    return torch.where(over, s - _P_I64, s)  # s - p wraps to s + EPSILON on carry


def sub_plain(a, b):
    d = a - b
    return torch.where(_ult(a, b), d + _P_I64, d)


def mul_plain(a, b):
    lo, hi = _mul64_wide(a, b)
    return _reduce128(lo, hi)


def square_plain(a):
    return mul_plain(a, a)


def pow_const_plain(a, e: int):
    """a ** e for a fixed Python-int exponent (square and multiply)."""
    result = torch.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            result = mul_plain(result, base)
        e >>= 1
        if e:
            base = mul_plain(base, base)
    return result


def inv_plain(a):
    return pow_const_plain(a, P - 2)


# ---------------------------------------------------------------------------
# Field ops.  A CUDA tensor launches ``csrc/field.cu`` (operands broadcast
# through their strides, one load and one store an element); a CPU tensor
# runs the plain version above.  Three cases launch nothing on either
# device, so a plan of ``field`` launches leaves them out: an empty result,
# ``mul_small(a, 0)`` (a zero tensor) and ``mul_small(a, 1)`` (``a`` itself).
# ---------------------------------------------------------------------------


def _binary(op: str, plain, a, b):
    from . import kernels

    if kernels.on_card(a) or kernels.on_card(b):
        return kernels.field_binary(op, a, b)
    return plain(a, b)


def add(a, b):
    return _binary("add", add_plain, a, b)


def sub(a, b):
    return _binary("sub", sub_plain, a, b)


def mul(a, b):
    return _binary("mul", mul_plain, a, b)


def square(a):
    return mul(a, a)


def neg(a):
    return sub(torch.zeros((), dtype=torch.int64, device=a.device), a)


def mul_small(a, k: int):
    """a * k for a small constant 0 <= k < 2^16."""
    if not 0 <= k < (1 << 16):
        raise ValueError(f"mul_small: {k} is not below 2^16")
    if k == 0:
        return torch.zeros_like(a)
    if k == 1:
        return a
    return mul(a, torch.full((), k, dtype=torch.int64, device=a.device))


def pow_const(a, e: int):
    """a ** e for a fixed Python-int exponent (square and multiply)."""
    result = torch.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def inv(a):
    """Multiplicative inverse via Fermat, a^(p-2); inv(0) = 0."""
    from . import kernels

    if kernels.on_card(a):
        return kernels.field_inv(a)
    return inv_plain(a)


def eq(a, b):
    """Elementwise equality (boolean tensor): valid because canonical."""
    return a == b


def select(cond, a, b):
    """Elementwise where(cond, a, b) for field tensors."""
    return torch.where(cond, a, b)


# ---------------------------------------------------------------------------
# Host-side scalars and tables
# ---------------------------------------------------------------------------


def h_mul(a: int, b: int) -> int:
    return (a * b) % P


def h_add(a: int, b: int) -> int:
    return (a + b) % P


def h_pow(a: int, e: int) -> int:
    return pow(a, e, P)


def h_inv(a: int) -> int:
    return pow(a, P - 2, P)


def primitive_root_of_unity(n_log: int) -> int:
    """Generator of the order-2^n_log subgroup of GF(p)^*."""
    if not 0 <= n_log <= TWO_ADICITY:
        raise ValueError(f"no 2^{n_log}-th root of unity in GF(p)")
    base = pow(MULTIPLICATIVE_GENERATOR, (P - 1) >> TWO_ADICITY, P)
    for _ in range(TWO_ADICITY - n_log):
        base = (base * base) % P
    return base


def powers(base: int, n: int, device) -> torch.Tensor:
    """[1, base, ..., base^(n-1)] as a field tensor made on ``device``, by
    log-doubling (about log2 n multiplications of growing blocks)."""
    out = torch.ones(n, dtype=torch.int64, device=device)
    if n <= 1:
        return out
    out[1] = from_u64(base % P, device)
    filled = 2
    while filled < n:
        take = min(filled, n - filled)
        step = from_u64(pow(base, filled, P), device)  # base^filled
        out[filled : filled + take] = mul(out[:take], step)
        filled += take
    return out
