"""BigUint gadgets: multi-limb u32 arithmetic with range checks.

Copy of ``eth_lc_plonky2_tpu/circuit/gadgets_biguint.py`` (the port keeps
its own; host-only builder code).  The counterpart of plonky2_crypto's
BigUint family (`add_virtual_biguint_target`, `add_biguint`,
`div_rem_biguint`, `cmp_biguint`, `connect_biguint`, `constant_biguint`,
witness setters) and of upstream's first-party gadgets in utils.rs:
  - IsEqualBigUint (8-limb pairwise equality AND-reduced)  [utils.rs:76-90]
  - BigUintHash256Connect (LE-limb value <-> SSZ hash leaf
    byte-order bridge)                                     [utils.rs:93-113]

A BigUintTarget is a list of u32-limb targets, little-endian.
"""

from __future__ import annotations

from .builder import CircuitBuilder, Generator, Target
from .gadgets_u32 import TWO32

BigUintTarget = list  # little-endian u32 limb targets


def add_virtual_biguint_target(b: CircuitBuilder, n_limbs: int, range_check: bool = True) -> BigUintTarget:
    limbs = b.add_virtual_targets(n_limbs)
    if range_check:
        for t in limbs:
            b.range_check_u32(t)
    return limbs


def connect_biguint(b: CircuitBuilder, x: BigUintTarget, y: BigUintTarget):
    n = min(len(x), len(y))
    for i in range(n):
        b.connect(x[i], y[i])
    zero = b.zero()
    for t in x[n:]:
        b.connect(t, zero)
    for t in y[n:]:
        b.connect(t, zero)


def constant_biguint(b: CircuitBuilder, value: int, n_limbs: int) -> BigUintTarget:
    assert value < (1 << (32 * n_limbs))
    return [b.constant((value >> (32 * i)) & 0xFFFFFFFF) for i in range(n_limbs)]


def set_biguint_target(w, t: BigUintTarget, value: int):
    for i, limb in enumerate(t):
        w.set(limb, (value >> (32 * i)) & 0xFFFFFFFF)


def biguint_value(w, t: BigUintTarget) -> int:
    return sum(w.get(limb) << (32 * i) for i, limb in enumerate(t))


def _split_acc(b: CircuitBuilder, total: Target, carry_bits: int) -> tuple[Target, Target]:
    """total = lo + carry*2^32, lo < 2^32 range-checked, carry < 2^carry_bits."""
    lo = b.add_virtual_target()
    carry = b.add_virtual_target()
    b.generators.append(Generator(lambda t: (t % TWO32, t // TWO32), [total], [lo, carry]))
    b.range_check_u32(lo)
    if carry_bits == 1:
        b.assert_bool(carry)
    else:
        b.split_le(carry, carry_bits)
    recomb = b.arithmetic(TWO32, 1, carry, b.one(), lo)
    b.assert_equal(recomb, total)
    return lo, carry


def add_biguint(b: CircuitBuilder, x: BigUintTarget, y: BigUintTarget) -> BigUintTarget:
    """x + y, output has max(len)+1 limbs."""
    n = max(len(x), len(y))
    zero = b.zero()
    xs = list(x) + [zero] * (n - len(x))
    ys = list(y) + [zero] * (n - len(y))
    out = []
    carry = zero
    for i in range(n):
        total = b.add(b.add(xs[i], ys[i]), carry)
        lo, carry = _split_acc(b, total, 1)
        out.append(lo)
    out.append(carry)
    return out


def mul_biguint(b: CircuitBuilder, x: BigUintTarget, y: BigUintTarget) -> BigUintTarget:
    """Schoolbook product, len(x)+len(y) limbs.

    Every 32x32 partial product (< p, so exact in-field) is split into
    its 32-bit halves BEFORE column accumulation, keeping all sums far
    below the field modulus.
    """
    nx, ny = len(x), len(y)
    prod_lo: dict[int, list] = {}
    prod_hi: dict[int, list] = {}
    for i, xi in enumerate(x):
        for j, yj in enumerate(y):
            p = b.mul(xi, yj)  # < (2^32-1)^2 < field modulus: exact
            lo, hi = _split_acc(b, p, 32)
            prod_lo.setdefault(i + j, []).append(lo)
            prod_hi.setdefault(i + j + 1, []).append(hi)
    out = []
    carry = b.zero()
    for k in range(nx + ny):
        terms = prod_lo.get(k, []) + prod_hi.get(k, []) + [carry]
        col = b.add_many(terms)
        cb = max(1, len(terms).bit_length())  # carry < n_terms
        lo, carry = _split_acc(b, col, cb)
        out.append(lo)
    b.assert_zero(carry)
    return out


def split_le_wide(b: CircuitBuilder, t: Target, num_bits: int):
    """Range check for num_bits possibly > 32 (two BaseSum2 slots)."""
    if num_bits <= 32:
        b.split_le(t, num_bits)
        return
    assert num_bits <= 64
    lo = b.add_virtual_target()
    hi = b.add_virtual_target()
    b.generators.append(Generator(lambda v: (v % TWO32, v // TWO32), [t], [lo, hi]))
    b.split_le(lo, 32)
    b.split_le(hi, num_bits - 32)
    recomb = b.arithmetic(TWO32, 1, hi, b.one(), lo)
    b.assert_equal(recomb, t)


def cmp_biguint(b: CircuitBuilder, x: BigUintTarget, y: BigUintTarget) -> Target:
    """Boolean target: x <= y (limb-wise borrow chain)."""
    n = max(len(x), len(y))
    zero = b.zero()
    xs = list(x) + [zero] * (n - len(x))
    ys = list(y) + [zero] * (n - len(y))
    borrow = zero
    for i in range(n):
        # y_i + 2^32 - x_i - borrow = lo + no_borrow*2^32
        t1 = b.add_const(ys[i], TWO32)
        t2 = b.sub(t1, xs[i])
        total = b.sub(t2, borrow)
        lo, no_borrow = _split_acc(b, total, 1)
        borrow = b.not_(no_borrow)
    return b.not_(borrow)


def div_rem_biguint(b: CircuitBuilder, x: BigUintTarget, d: BigUintTarget) -> tuple[BigUintTarget, BigUintTarget]:
    """x = q*d + r with r < d; q, r prover-supplied, constrained."""
    nq = len(x)
    nr = len(d)
    q = add_virtual_biguint_target(b, nq)
    r = add_virtual_biguint_target(b, nr)

    def gen(*vals):
        xv = 0
        for i in range(len(x)):
            xv |= vals[i] << (32 * i)
        dv = 0
        for i in range(len(d)):
            dv |= vals[len(x) + i] << (32 * i)
        qv, rv = divmod(xv, dv)
        outs = [(qv >> (32 * i)) & 0xFFFFFFFF for i in range(nq)]
        outs += [(rv >> (32 * i)) & 0xFFFFFFFF for i in range(nr)]
        return tuple(outs)

    b.generators.append(Generator(gen, list(x) + list(d), q + r))
    qd = mul_biguint(b, q, d)
    qd_r = add_biguint(b, qd, r)
    connect_biguint(b, qd_r, list(x) + [b.zero()] * (len(qd_r) - len(x)))
    # r < d  <=>  NOT (d <= r)
    d_le_r = cmp_biguint(b, d, r)
    b.assert_zero(d_le_r)
    return q, r


def is_equal_biguint(b: CircuitBuilder, x: BigUintTarget, y: BigUintTarget) -> Target:
    """Boolean: x == y (pairwise limb equality AND-reduced; utils.rs:76-90)."""
    assert len(x) == len(y)
    acc = None
    for xi, yi in zip(x, y):
        e = b.is_equal(xi, yi)
        acc = e if acc is None else b.and_(acc, e)
    return acc


def byte_swap_u32(b: CircuitBuilder, t: Target) -> Target:
    """Byte-reversed u32 (bswap32) via bit decomposition + reweighting."""
    bits = b.split_le(t, 32)
    acc = b.zero()
    for j in range(32):
        byte, bit_in_byte = divmod(j, 8)
        w = 1 << (8 * (3 - byte) + bit_in_byte)
        acc = b.arithmetic(w, 1, bits[j], b.one(), acc)
    return acc


def biguint_hash256_connect(b: CircuitBuilder, value: BigUintTarget, h: list):
    """Connect an 8-limb LE BigUint to the same number viewed as an SSZ
    hash leaf (32 LE bytes read as 8 BE u32 words): h[i] = bswap32(v[i]).

    Parity with utils.rs:93-113 (BigUintHash256ConnectTarget).
    """
    assert len(value) == 8 and len(h) == 8
    for i in range(8):
        swapped = byte_swap_u32(b, value[i])
        b.assert_equal(swapped, h[i])
