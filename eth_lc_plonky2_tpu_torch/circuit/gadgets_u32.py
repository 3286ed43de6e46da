"""u32 arithmetic gadgets: range-checked 32-bit wires.

Copy of ``eth_lc_plonky2_tpu/circuit/gadgets_u32.py`` (the port keeps its
own; host-only builder code).  The counterpart of plonky2_crypto's
`U32Target` family (`connect_u32`, `constant_u32`, u32 adds).

A "u32 target" here is an ordinary field target whose value is
constrained < 2^32 (by a BaseSum2 decomposition where needed).
"""

from __future__ import annotations

from .builder import CircuitBuilder, Generator, Target

TWO32 = 1 << 32


def add_u32(b: CircuitBuilder, x: Target, y: Target) -> tuple[Target, Target]:
    """(x + y) mod 2^32 with carry bit; inputs must already be u32.

    Returns (sum_u32, carry_bool).
    """
    total = b.add(x, y)
    s = b.add_virtual_target()
    c = b.add_virtual_target()
    b.generators.append(
        Generator(lambda t: (t % TWO32, t // TWO32), [total], [s, c])
    )
    b.assert_bool(c)
    b.range_check_u32(s)
    # total == s + c * 2^32
    recomb = b.arithmetic(TWO32, 1, c, b.one(), s)
    b.assert_equal(recomb, total)
    return s, c


def add_u32_mod(b: CircuitBuilder, x: Target, y: Target) -> Target:
    """(x + y) mod 2^32, discarding the carry (SHA feed-forward add)."""
    s, _ = add_u32(b, x, y)
    return s


def add_many_u32(b: CircuitBuilder, xs: list[Target]) -> tuple[Target, Target]:
    """Sum of u32 values: returns (sum_u32, carry) with carry < len(xs)."""
    assert xs
    total = b.add_many(xs)
    s = b.add_virtual_target()
    c = b.add_virtual_target()
    b.generators.append(
        Generator(lambda t: (t % TWO32, t // TWO32), [total], [s, c])
    )
    b.range_check_u32(s)
    # carry is small: constrain via bits
    carry_bits = max(1, (len(xs) - 1).bit_length())
    b.split_le(c, carry_bits)
    recomb = b.arithmetic(TWO32, 1, c, b.one(), s)
    b.assert_equal(recomb, total)
    return s, c


def constant_u32(b: CircuitBuilder, value: int) -> Target:
    assert 0 <= value < TWO32
    return b.constant(value)
