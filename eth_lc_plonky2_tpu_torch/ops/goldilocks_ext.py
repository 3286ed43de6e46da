"""Quadratic extension GF(p^2) = GF(p)[X]/(X^2 - 7) over Goldilocks.

Port of ``eth_lc_plonky2_tpu/ops/goldilocks_ext.py``.  The opening point
zeta and the FRI folding challenges live in the degree-2 extension; the
prover's hot loops stay in the base field, and extension ops only run on
openings and FRI layers.

An extension array is a pair ``(a, b)`` of int64 field tensors of one
shape, representing a + b*phi with phi^2 = W = 7.
"""

from __future__ import annotations

import torch

from . import goldilocks as gl

W = 7
P = gl.P


def from_base(a):
    """Embed a base-field tensor into the extension."""
    return (a, torch.zeros_like(a))


def zeros(shape, device):
    return (gl.zeros(shape, device), gl.zeros(shape, device))


def ones(shape, device):
    return (gl.ones(shape, device), gl.zeros(shape, device))


def from_u64_pair(a0, a1, device=None):
    return (gl.from_u64(a0, device), gl.from_u64(a1, device))


def to_u64_pair(x):
    return gl.to_u64(x[0]), gl.to_u64(x[1])


def add(x, y):
    return (gl.add(x[0], y[0]), gl.add(x[1], y[1]))


def sub(x, y):
    return (gl.sub(x[0], y[0]), gl.sub(x[1], y[1]))


def neg(x):
    return (gl.neg(x[0]), gl.neg(x[1]))


def mul(x, y):
    """(a + b phi)(c + d phi) = (ac + W bd) + (ad + bc) phi."""
    a, b = x
    c, d = y
    ac = gl.mul(a, c)
    bd = gl.mul(b, d)
    ad = gl.mul(a, d)
    bc = gl.mul(b, c)
    return (gl.add(ac, gl.mul_small(bd, W)), gl.add(ad, bc))


def mul_base(x, s):
    """Extension times base-field tensor."""
    return (gl.mul(x[0], s), gl.mul(x[1], s))


def square(x):
    return mul(x, x)


def inv(x):
    """1/(a + b phi) = (a - b phi) / (a^2 - W b^2)."""
    a, b = x
    norm = gl.sub(gl.square(a), gl.mul_small(gl.square(b), W))
    ninv = gl.inv(norm)
    return (gl.mul(a, ninv), gl.mul(gl.neg(b), ninv))


def pow_const(x, e: int):
    result = ones(x[0].shape, x[0].device)
    base = x
    while e > 0:
        if e & 1:
            result = mul(result, base)
        base = square(base)
        e >>= 1
    return result


def eq(x, y):
    return gl.eq(x[0], y[0]) & gl.eq(x[1], y[1])


def powers_device(z, n: int):
    """[1, z, ..., z^(n-1)] for an ext scalar z (a pair of shape-() tensors),
    by log-doubling on z's device: O(log n) tensor ops."""
    dev = z[0].device
    out = (torch.stack([gl.ones((), dev), z[0]]), torch.stack([gl.zeros((), dev), z[1]]))
    if n == 1:
        return (out[0][:1], out[1][:1])
    while (k := out[0].shape[0]) < n:
        take = min(k, n - k)
        factor = mul((out[0][k - 1], out[1][k - 1]), (out[0][1], out[1][1]))  # z^k
        nxt = mul((out[0][:take], out[1][:take]), factor)
        out = (torch.cat([out[0], nxt[0]]), torch.cat([out[1], nxt[1]]))
    return (out[0][:n], out[1][:n])


def select(cond, x, y):
    return (gl.select(cond, x[0], y[0]), gl.select(cond, x[1], y[1]))


# ---------------------------------------------------------------------------
# Host-side scalar helpers (pairs of Python ints)
# ---------------------------------------------------------------------------


def h_mul(x, y):
    a, b = x
    c, d = y
    return ((a * c + W * b * d) % P, (a * d + b * c) % P)


def h_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def h_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def h_inv(x):
    a, b = x
    norm = (a * a - W * b * b) % P
    ninv = pow(norm, P - 2, P)
    return ((a * ninv) % P, (-b * ninv) % P)


def h_pow(x, e: int):
    result = (1, 0)
    base = x
    while e > 0:
        if e & 1:
            result = h_mul(result, base)
        base = h_mul(base, base)
        e >>= 1
    return result
