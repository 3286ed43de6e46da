"""Dual-evaluation algebra: gate constraints are written ONCE and run in
two worlds:

  * DeviceBaseAlgebra: base-field int64 tensors over the whole LDE
    evaluation domain (the prover's quotient hot loop);
  * HostExtAlgebra: scalar GF(p^2) Python-int pairs at the opening point
    zeta (a verifier's constraint check).

A third, ``SymbolicAlgebra``, records a gate's constraints as an expression
DAG for the proof-bundle exporter (``prover/serialize.py``).

Port of ``eth_lc_plonky2_tpu/circuit/algebra.py``.
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


class SymbolicAlgebra:
    """Records a gate's constraint polynomials as an expression DAG.

    Used by the proof-format exporter (prover/serialize.py
    export_proof_bundle): gate semantics ship WITH the proof bundle as
    data, so the standalone second-implementation verifier
    (tools/verify_standalone.py) interprets them instead of importing
    this package.  Node kinds:

      ["const", c]          field constant
      ["wire", col, off]    wire opening at row offset `off`
      ["ccol", i]           constant-column opening i
      ["add"|"sub"|"mul", a, b]   refs to earlier node ids

    Nodes are deduplicated; ids are topologically ordered by
    construction.
    """

    def __init__(self):
        self.nodes: list = []
        self._cache: dict = {}

    def _node(self, key):
        idx = self._cache.get(key)
        if idx is None:
            idx = len(self.nodes)
            self.nodes.append(list(key))
            self._cache[key] = idx
        return idx

    def wire(self, col: int, offset: int = 0):
        return self._node(("wire", int(col), int(offset)))

    def const_col(self, i: int):
        return self._node(("ccol", int(i)))

    def constant(self, c: int):
        return self._node(("const", int(c) % P))

    def add(self, x, y):
        return self._node(("add", x, y))

    def sub(self, x, y):
        return self._node(("sub", x, y))

    def mul(self, x, y):
        return self._node(("mul", x, y))

    def zero(self):
        return self.constant(0)

    def one(self):
        return self.constant(1)

    def add_many(self, xs):
        acc = self.zero()
        for x in xs:
            acc = self.add(acc, x)
        return acc

    def mul_small(self, c: int, x):
        return self.mul(self.constant(c), x)


def gate_expression(gate) -> dict:
    """Serialize one gate's constraints as an expression DAG."""
    A = SymbolicAlgebra()
    outputs = gate.eval(A, lambda col, offset=0: A.wire(col, offset), A.const_col)
    assert len(outputs) == gate.num_constraints
    return {"name": gate.name, "nodes": A.nodes, "outputs": list(outputs)}


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
