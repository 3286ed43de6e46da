"""BLS12-381 base-field + G1 curve gadgets.

Copy of ``eth_lc_plonky2_tpu/circuit/gadgets_bls12_381.py`` (the port keeps
its own; host-only builder code).  Upstream's BLS sub-prover
(`starky_bls12_381::aggregate_proof`, main.rs:172) aggregates committee
pubkeys (G1 point additions) and verifies the pairing.  This module is
the in-circuit piece of that capability rebuilt here: Fq arithmetic over
384-bit (12 x u32 limb) BigUints and affine G1 point add / double, with
host references.  Hash-to-curve and the pairing stay pluggable through
models/bls.py artifacts.

Design: division-free constraints.  Nondeterministic witnesses (the
chord/tangent slope lambda, subtraction results, modular quotients)
are prover-supplied and CONSTRAINED:

  add (P1 != P2):  lambda*(x2-x1) == y2-y1
                   x3 == lambda^2 - x1 - x2,  y3 == lambda*(x1-x3) - y1
  double:          lambda*(2 y1)  == 3 x1^2
                   x3 == lambda^2 - 2 x1,     y3 == lambda*(x1-x3) - y1

All equalities are mod q via canonical reduction (div_rem by the
constant modulus, remainder range-enforced < q).
"""

from __future__ import annotations

import dataclasses

from .builder import CircuitBuilder, Generator
from . import gadgets_biguint as bu

# BLS12-381 base field modulus (381 bits)
Q = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab",
    16,
)
FQ_LIMBS = 12  # 384 bits of u32 limbs

# The standard G1 generator (affine), for tests/callers.
G1_GEN = (
    int(
        "17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
        "6c55e83ff97a1aeffb3af00adb22c6bb",
        16,
    ),
    int(
        "08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3ed"
        "d03cc744a2888ae40caa232946c5e7e1",
        16,
    ),
)


def _q_const(b: CircuitBuilder):
    return bu.constant_biguint(b, Q, FQ_LIMBS)


def add_virtual_fq(b: CircuitBuilder):
    """A free Fq element: 12 range-checked u32 limbs, value < q enforced."""
    x = bu.add_virtual_biguint_target(b, FQ_LIMBS)
    # x < q  <=>  NOT (q <= x)
    q_le_x = bu.cmp_biguint(b, _q_const(b), x)
    b.assert_zero(q_le_x)
    return x


def set_fq(w, t, value: int):
    bu.set_biguint_target(w, t, value % Q)


def fq_value(w, t) -> int:
    return bu.biguint_value(w, t)


def fq_reduce(b: CircuitBuilder, x):
    """Canonical reduction mod q of an arbitrary-width BigUint."""
    _, r = bu.div_rem_biguint(b, x, _q_const(b))
    return r


def _limbs_value(ls) -> int:
    return sum(v << (32 * i) for i, v in enumerate(ls))


def _to_limbs(v: int, n: int = FQ_LIMBS) -> tuple:
    return tuple((v >> (32 * k)) & 0xFFFFFFFF for k in range(n))


def _cond_q(b: CircuitBuilder, c):
    """[c * q_limb_i] targets for boolean c (a conditional +q)."""
    return [b.mul_const((Q >> (32 * i)) & 0xFFFFFFFF, c) for i in range(FQ_LIMBS)]


def fq_add(b: CircuitBuilder, x, y):
    """x + y mod q for canonical x, y — single conditional-subtract.

    r (prover-supplied, < q enforced) and boolean c are constrained by
    r + c*q == x + y; with x, y < q the true sum is < 2q, so c in
    {0,1} always suffices — far cheaper than the general div_rem
    reduction (the aggregate-pubkey circuit pays this per limb op).
    """
    r = add_virtual_fq(b)
    c = b.add_virtual_bool_target()

    def gen(*ls):
        s = _limbs_value(ls[:FQ_LIMBS]) + _limbs_value(ls[FQ_LIMBS:])
        return _to_limbs(s % Q) + (1 if s >= Q else 0,)

    b.generators.append(Generator(gen, list(x) + list(y), list(r) + [c]))
    lhs = bu.add_biguint(b, r, _cond_q(b, c))
    rhs = bu.add_biguint(b, x, y)
    bu.connect_biguint(b, lhs, rhs)
    return r


def fq_mul(b: CircuitBuilder, x, y):
    """x * y mod q for canonical x, y: x*y == k*q + r with k a
    prover-supplied 12-limb quotient (k <= (q-1)^2/q < q fits 12
    limbs), r canonical."""
    r = add_virtual_fq(b)
    k = bu.add_virtual_biguint_target(b, FQ_LIMBS)

    def gen(*ls):
        p = _limbs_value(ls[:FQ_LIMBS]) * _limbs_value(ls[FQ_LIMBS:])
        kv, rv = divmod(p, Q)
        return _to_limbs(rv) + _to_limbs(kv)

    b.generators.append(Generator(gen, list(x) + list(y), list(r) + list(k)))
    p = bu.mul_biguint(b, x, y)
    kq = bu.mul_biguint(b, k, _q_const(b))
    lhs = bu.add_biguint(b, kq, r)
    bu.connect_biguint(b, lhs, p)
    return r


def fq_sub(b: CircuitBuilder, x, y):
    """x - y mod q: prover-supplied z < q with z + y == x + c*q."""
    z = add_virtual_fq(b)
    c = b.add_virtual_bool_target()

    def gen(*ls):
        xv = _limbs_value(ls[:FQ_LIMBS])
        yv = _limbs_value(ls[FQ_LIMBS:])
        return _to_limbs((xv - yv) % Q) + (1 if xv < yv else 0,)

    b.generators.append(Generator(gen, list(x) + list(y), list(z) + [c]))
    lhs = bu.add_biguint(b, z, y)
    rhs = bu.add_biguint(b, x, _cond_q(b, c))
    bu.connect_biguint(b, lhs, rhs)
    return z


def fq_mul_const(b: CircuitBuilder, x, c: int):
    return fq_mul(b, x, bu.constant_biguint(b, c % Q, FQ_LIMBS))


def fq_assert_equal(b: CircuitBuilder, x, y):
    bu.connect_biguint(b, x, y)


@dataclasses.dataclass
class G1AffineTarget:
    x: list  # Fq limbs
    y: list


def add_virtual_g1(b: CircuitBuilder) -> G1AffineTarget:
    return G1AffineTarget(x=add_virtual_fq(b), y=add_virtual_fq(b))


def set_g1(w, t: G1AffineTarget, point: tuple[int, int]):
    set_fq(w, t.x, point[0])
    set_fq(w, t.y, point[1])


def assert_on_curve_g1(b: CircuitBuilder, p: G1AffineTarget):
    """y^2 == x^3 + 4 (mod q)."""
    y2 = fq_mul(b, p.y, p.y)
    x2 = fq_mul(b, p.x, p.x)
    x3 = fq_mul(b, x2, p.x)
    rhs = fq_add(b, x3, bu.constant_biguint(b, 4, FQ_LIMBS))
    fq_assert_equal(b, y2, rhs)


def _lambda_witness(b: CircuitBuilder, lam, num, den):
    """Constrain lam * den == num (mod q); lam is prover-supplied."""
    lhs = fq_mul(b, lam, den)
    fq_assert_equal(b, lhs, num)


def g1_add_unequal(b: CircuitBuilder, p1: G1AffineTarget, p2: G1AffineTarget) -> G1AffineTarget:
    """P1 + P2 for P1 != +-P2, neither at infinity (chord rule).

    The x1 != x2 precondition is ENFORCED (the chord constraint
    lam*(x2-x1) == y2-y1 alone would be satisfiable for any lam when
    x1 == x2 and y1 == y2 compute to 0): den = x2-x1 must have an
    inverse witness.
    """
    den = fq_sub(b, p2.x, p1.x)
    num = fq_sub(b, p2.y, p1.y)
    # den != 0: prover supplies inv with den*inv == 1 (mod q)
    inv = add_virtual_fq(b)
    b.generators.append(
        Generator(
            lambda *ls: tuple(
                (pow(
                    sum(v << (32 * i) for i, v in enumerate(ls)) % Q,
                    Q - 2, Q,
                ) >> (32 * k)) & 0xFFFFFFFF
                for k in range(FQ_LIMBS)
            ),
            list(den),
            list(inv),
        )
    )
    one = bu.constant_biguint(b, 1, FQ_LIMBS)
    fq_assert_equal(b, fq_mul(b, den, inv), one)

    lam = add_virtual_fq(b)

    def lam_gen(*ls):
        n = sum(v << (32 * i) for i, v in enumerate(ls[:FQ_LIMBS])) % Q
        d = sum(v << (32 * i) for i, v in enumerate(ls[FQ_LIMBS:])) % Q
        l = (n * pow(d, Q - 2, Q)) % Q
        return tuple((l >> (32 * k)) & 0xFFFFFFFF for k in range(FQ_LIMBS))

    b.generators.append(Generator(lam_gen, list(num) + list(den), list(lam)))
    _lambda_witness(b, lam, num, den)

    lam2 = fq_mul(b, lam, lam)
    x3 = fq_sub(b, fq_sub(b, lam2, p1.x), p2.x)
    y3 = fq_sub(b, fq_mul(b, lam, fq_sub(b, p1.x, x3)), p1.y)
    return G1AffineTarget(x=x3, y=y3)


def g1_double(b: CircuitBuilder, p: G1AffineTarget) -> G1AffineTarget:
    """2P for P not at infinity, y != 0 (tangent rule)."""
    two_y = fq_add(b, p.y, p.y)
    x2 = fq_mul(b, p.x, p.x)
    three_x2 = fq_add(b, fq_add(b, x2, x2), x2)
    lam = add_virtual_fq(b)

    def lam_gen(*ls):
        n = sum(v << (32 * i) for i, v in enumerate(ls[:FQ_LIMBS])) % Q
        d = sum(v << (32 * i) for i, v in enumerate(ls[FQ_LIMBS:])) % Q
        l = (n * pow(d, Q - 2, Q)) % Q
        return tuple((l >> (32 * k)) & 0xFFFFFFFF for k in range(FQ_LIMBS))

    b.generators.append(Generator(lam_gen, list(three_x2) + list(two_y), list(lam)))
    _lambda_witness(b, lam, three_x2, two_y)

    lam2 = fq_mul(b, lam, lam)
    x3 = fq_sub(b, fq_sub(b, lam2, p.x), p.x)
    y3 = fq_sub(b, fq_mul(b, lam, fq_sub(b, p.x, x3)), p.y)
    return G1AffineTarget(x=x3, y=y3)


# ---------------------------------------------------------------------------
# Host reference implementation (for witness cross-checks in tests)
# ---------------------------------------------------------------------------


def host_g1_add(p1, p2):
    (x1, y1), (x2, y2) = p1, p2
    assert (x1 - x2) % Q != 0, "use host_g1_double / handle inverse"
    lam = ((y2 - y1) * pow(x2 - x1, Q - 2, Q)) % Q
    x3 = (lam * lam - x1 - x2) % Q
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)


def host_g1_double(p):
    x1, y1 = p
    lam = (3 * x1 * x1 * pow(2 * y1, Q - 2, Q)) % Q
    x3 = (lam * lam - 2 * x1) % Q
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)
