"""In-circuit GF(p^2) arithmetic + selection/decomposition gadgets.

Copy of ``eth_lc_plonky2_tpu/circuit/gadgets_ext.py`` (the port keeps its
own; host-only builder code).  Building blocks of the recursion layer (L4): the in-circuit verifier
re-does verify.py's extension-field arithmetic on target pairs
(re, im) representing re + im*phi, phi^2 = 7.

Also: random_access (mux a public-length list by challenge bits) and
split_64 (64-bit decomposition of a field element) — both needed to
walk Merkle paths / FRI layers at transcript-derived query indices,
mirroring what plonky2's recursive verifier does (invoked upstream at
targets.rs:468-470).
"""

from __future__ import annotations

from typing import NamedTuple

from ..ops import goldilocks as gl
from ..ops import goldilocks_ext as ge
from .builder import CircuitBuilder, Generator, Target

P = gl.P
W = ge.W  # 7


class ExtTarget(NamedTuple):
    re: Target
    im: Target


def ext_from_base(b: CircuitBuilder, t: Target) -> ExtTarget:
    return ExtTarget(t, b.zero())


def ext_constant(b: CircuitBuilder, c: tuple[int, int]) -> ExtTarget:
    return ExtTarget(b.constant(c[0]), b.constant(c[1]))


def ext_zero(b: CircuitBuilder) -> ExtTarget:
    return ExtTarget(b.zero(), b.zero())


def ext_one(b: CircuitBuilder) -> ExtTarget:
    return ExtTarget(b.one(), b.zero())


def add_virtual_ext(b: CircuitBuilder) -> ExtTarget:
    return ExtTarget(b.add_virtual_target(), b.add_virtual_target())


def set_ext(w, t: ExtTarget, v: tuple[int, int]):
    w.set(t.re, v[0])
    w.set(t.im, v[1])


def ext_add(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    return ExtTarget(b.add(x.re, y.re), b.add(x.im, y.im))


def ext_sub(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    return ExtTarget(b.sub(x.re, y.re), b.sub(x.im, y.im))


def ext_mul(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    """(a+b phi)(c+d phi) = (ac + 7bd) + (ad + bc) phi — 4 arith ops."""
    ac = b.mul(x.re, y.re)
    bc = b.mul(x.im, y.re)
    re = b.arithmetic(W, 1, x.im, y.im, ac)  # 7*b*d + ac
    im = b.arithmetic(1, 1, x.re, y.im, bc)  # a*d + bc
    return ExtTarget(re, im)


def ext_mul_base(b: CircuitBuilder, x: ExtTarget, s: Target) -> ExtTarget:
    return ExtTarget(b.mul(x.re, s), b.mul(x.im, s))


def ext_mul_const(b: CircuitBuilder, x: ExtTarget, c: tuple[int, int]) -> ExtTarget:
    """x * constant (c_re + c_im phi)."""
    # re = c_re*a + 7*c_im*b ; im = c_im*a + c_re*b
    t1 = b.mul_const(c[0], x.re)
    re = b.arithmetic((W * c[1]) % P, 1, x.im, b.one(), t1)
    t2 = b.mul_const(c[1], x.re)
    im = b.arithmetic(c[0], 1, x.im, b.one(), t2)
    return ExtTarget(re, im)


def ext_select(b: CircuitBuilder, flag: Target, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    return ExtTarget(b.select(flag, x.re, y.re), b.select(flag, x.im, y.im))


def ext_assert_equal(b: CircuitBuilder, x: ExtTarget, y: ExtTarget):
    b.assert_equal(x.re, y.re)
    b.assert_equal(x.im, y.im)


def ext_inverse(b: CircuitBuilder, x: ExtTarget) -> ExtTarget:
    """Witness-supplied inverse, constrained by x * inv == 1.

    x must be nonzero (guaranteed for FRI denominators: zeta and the
    query points are outside H with overwhelming probability, and the
    constraint is unsatisfiable otherwise)."""
    inv = add_virtual_ext(b)

    def gen(xr, xi):
        r = ge.h_inv((xr, xi))
        return r[0], r[1]

    b.generators.append(Generator(gen, [x.re, x.im], [inv.re, inv.im]))
    prod = ext_mul(b, x, inv)
    b.assert_equal(prod.re, b.one())
    b.assert_zero(prod.im)
    return inv


def ext_div(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    return ext_mul(b, x, ext_inverse(b, y))


def ext_pow2_chain(b: CircuitBuilder, x: ExtTarget, n_squares: int) -> list[ExtTarget]:
    """[x, x^2, x^4, ..., x^(2^n_squares)]."""
    out = [x]
    for _ in range(n_squares):
        out.append(ext_mul(b, out[-1], out[-1]))
    return out


def ext_exp_bits(b: CircuitBuilder, base_pows: list[ExtTarget], bits: list[Target]) -> ExtTarget:
    """prod_i (bits[i] ? base_pows[i] : 1) — exponentiation by a
    bit-decomposed exponent, base_pows[i] = base^(2^i)."""
    one = ext_one(b)
    acc = None
    for bit, bp in zip(bits, base_pows):
        term = ext_select(b, bit, bp, one)
        acc = term if acc is None else ext_mul(b, acc, term)
    return acc if acc is not None else one


# ---------------------------------------------------------------------------
# Selection / decomposition
# ---------------------------------------------------------------------------


def random_access(b: CircuitBuilder, bits: list[Target], items: list[Target]) -> Target:
    """items[sum bits_i 2^i] via a select tree; len(items) = 2^len(bits)."""
    assert len(items) == 1 << len(bits)
    layer = list(items)
    for bit in bits:
        layer = [
            b.select(bit, layer[2 * i + 1], layer[2 * i])
            for i in range(len(layer) // 2)
        ]
    return layer[0]


def random_access_digest(b: CircuitBuilder, bits: list[Target], digests: list[list]) -> list:
    """Select a 4-element digest from 2^len(bits) candidates."""
    return [random_access(b, bits, [d[i] for d in digests]) for i in range(4)]


def split_64(b: CircuitBuilder, x: Target) -> list[Target]:
    """Decompose a field element into 64 little-endian bits.

    The prover supplies (lo32, hi32) with x == lo + 2^32*hi (mod p) and
    both range-checked to 32 bits.  Elements < 2^64 - p (~2^-32 of the
    field) admit a second, non-canonical decomposition (x + p); as in
    plonky2's recursive verifier this only gives the prover one bit of
    grinding freedom on query indices, never a forged low-bit pattern
    for values that are actually large.
    """
    lo = b.add_virtual_target()
    hi = b.add_virtual_target()
    b.generators.append(
        Generator(lambda v: (v & 0xFFFFFFFF, v >> 32), [x], [lo, hi])
    )
    # x == lo + 2^32 * hi
    recomposed = b.arithmetic(1 << 32, 1, hi, b.one(), lo)
    b.assert_equal(recomposed, x)
    lo_bits = b.split_le(lo, 32)
    hi_bits = b.split_le(hi, 32)
    return lo_bits + hi_bits
