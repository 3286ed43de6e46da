"""Constraint debugger: check every constraint directly on the row
domain H from a witness matrix — pinpoints (term, row) of any
violation before/without proving.

Copy of ``eth_lc_plonky2_tpu/prover/debug.py`` (host numpy only; the port
keeps its own).  Upstream's counterpart is plonky2's debug assertions
inside prove.
"""

from __future__ import annotations

import numpy as np

from ..ops import host_field as hf
from ..ops import goldilocks as gl
from ..circuit.builder import CircuitData

P = gl.P


class _HostRowAlgebra:
    """Vectorized host algebra over all n rows (u64 numpy, exact)."""

    def __init__(self, n):
        self.n = n

    def constant(self, c: int):
        return np.full(self.n, c % P, dtype=np.uint64)

    def add(self, x, y):
        return hf.add(x, y)

    def sub(self, x, y):
        return hf.sub(x, y)

    def mul(self, x, y):
        return hf.mul(x, y)

    def zero(self):
        return np.zeros(self.n, dtype=np.uint64)

    def one(self):
        return np.ones(self.n, dtype=np.uint64)

    def add_many(self, xs):
        acc = self.zero()
        for x in xs:
            acc = hf.add(acc, x)
        return acc

    def mul_small(self, c: int, x):
        return hf.mul(np.uint64(c % P), x)


def check_constraints(data: CircuitData, wires_u64: np.ndarray, pi_values=None) -> list:
    """Returns a list of violation records: (kind, detail, rows)."""
    n = data.n
    A = _HostRowAlgebra(n)
    violations = []

    def wires(col, offset=0):
        return np.roll(wires_u64[col], -offset)

    def consts(i):
        return data.constants[i].astype(np.uint64)

    for gi, g in enumerate(data.gates):
        if g.num_constraints == 0:
            continue
        sel = data.selectors[gi].astype(np.uint64)
        cons = g.eval(A, wires, consts)
        for k, cval in enumerate(cons):
            bad = (hf.mul(sel, cval) != 0)
            if bad.any():
                rows = np.nonzero(bad)[0][:8]
                violations.append((f"gate:{g.name}", f"constraint {k}", rows.tolist()))

    # copy constraints: all slots in a class share the matrix value by
    # construction of full_matrix, so only check PI match
    if pi_values is not None:
        for (r, c), piv in zip(data.public_input_targets, pi_values):
            if int(wires_u64[c, r]) != int(piv) % P:
                violations.append(("public_input", f"({r},{c})", [r]))
    return violations
