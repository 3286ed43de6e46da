"""Dual-evaluation algebra: gate constraints are written ONCE and run in
two worlds:

  * DeviceBaseAlgebra: base-field int64 tensors over the whole LDE
    evaluation domain (the prover's quotient hot loop);
  * HostExtAlgebra: scalar GF(p^2) Python-int pairs at the opening point
    zeta (a verifier's constraint check).

Port of ``eth_lc_plonky2_tpu/circuit/algebra.py`` (without the symbolic
algebra of the proof-bundle exporter, which is not ported).
"""

from __future__ import annotations

from ..ops import goldilocks as gl
from ..ops import goldilocks_ext as ge

P = gl.P


class HostExtAlgebra:
    """Elements are (a, b) Python-int pairs: a + b*phi in GF(p^2)."""

    def constant(self, c: int):
        return (c % P, 0)

    def add(self, x, y):
        return ge.h_add(x, y)

    def sub(self, x, y):
        return ge.h_sub(x, y)

    def mul(self, x, y):
        return ge.h_mul(x, y)

    def zero(self):
        return (0, 0)

    def one(self):
        return (1, 0)

    def add_many(self, xs):
        acc = self.zero()
        for x in xs:
            acc = self.add(acc, x)
        return acc

    def mul_small(self, c: int, x):
        """c * x for a small non-negative int constant c < 2^16."""
        return ((c * x[0]) % P, (c * x[1]) % P)


class DeviceBaseAlgebra:
    """Elements are int64 field tensors of one fixed shape on one device."""

    def __init__(self, shape, device):
        self.shape = shape
        self.device = device

    def constant(self, c: int):
        return gl.full(self.shape, c, self.device)

    def add(self, x, y):
        return gl.add(x, y)

    def sub(self, x, y):
        return gl.sub(x, y)

    def mul(self, x, y):
        return gl.mul(x, y)

    def zero(self):
        return gl.zeros(self.shape, self.device)

    def one(self):
        return gl.ones(self.shape, self.device)

    def add_many(self, xs):
        acc = None
        for x in xs:
            acc = x if acc is None else gl.add(acc, x)
        return acc if acc is not None else self.zero()

    def mul_small(self, c: int, x):
        return gl.mul_small(x, c)
