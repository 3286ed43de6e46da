"""Gate library for the plonkish constraint system.

Each gate TYPE gets one preprocessed 0/1 selector column; a row's
constraints are the selector-weighted union over gate types, so the
prover evaluates every gate type's constraints vectorized over the
whole domain (uniform work, no per-row branching).

Gate evaluation is written against the dual algebra
(circuit.algebra): `wires(col, offset)` returns the wire value of
column `col` at row r+offset — array-valued for the prover, opened
scalar for the verifier.  Offsets let AIR-style segments (SHA-256)
reference neighbor rows; generic gates use offset 0 only.

Copy of ``eth_lc_plonky2_tpu/circuit/gates.py`` (the port keeps its own):
the generic gates of plonky2's set (ArithmeticGate / BaseSumGate /
ConstantGate / NoopGate).  The Poseidon and SHA-256 gates live in
``gates_poseidon.py`` and ``gates_sha256.py``.
"""

from __future__ import annotations


class Gate:
    """Base gate type. Subclasses define a fixed per-row wire layout."""

    name: str = "gate"
    num_constraints: int = 0
    degree: int = 0  # max degree in wire values
    wire_offsets: tuple[int, ...] = (0,)

    def eval(self, A, wires, consts):
        """Return list of constraint values (must vanish on rows of this type).

        A: algebra; wires(col, offset=0) -> elem; consts(i) -> elem.
        """
        raise NotImplementedError


class NoopGate(Gate):
    """No constraints; its routed wires are free slots for virtual targets."""

    name = "noop"
    num_constraints = 0
    degree = 0

    def eval(self, A, wires, consts):
        return []


class ArithmeticGate(Gate):
    """num_ops fused ops per row: out = C0 * a * b + C1 * c.

    Wire layout: op i uses wires [4i, 4i+1, 4i+2, 4i+3] = (a, b, c, out).
    Row constants: consts(0)=C0, consts(1)=C1 shared by all ops in the row.
    """

    name = "arith"
    degree = 3  # C0(x)*a*b has degree 2 in wires + 1 for the constant column

    def __init__(self, num_ops: int = 20):
        self.num_ops = num_ops
        self.num_constraints = num_ops

    def eval(self, A, wires, consts):
        c0 = consts(0)
        c1 = consts(1)
        out = []
        for i in range(self.num_ops):
            a = wires(4 * i)
            b = wires(4 * i + 1)
            c = wires(4 * i + 2)
            o = wires(4 * i + 3)
            val = A.add(A.mul(c0, A.mul(a, b)), A.mul(c1, c))
            out.append(A.sub(val, o))
        return out


class BaseSum2Gate(Gate):
    """Binary decomposition: num_slots independent (value, 32 bits) groups.

    Wire layout: slot s occupies wires [33s .. 33s+32]:
      wire 33s       = value
      wire 33s+1+i   = bit i (little-endian)
    Constraints per slot: value = sum bits*2^i, plus 32 booleanity.
    """

    name = "basesum2"
    degree = 2

    def __init__(self, num_bits: int = 32, num_slots: int = 2):
        self.num_bits = num_bits
        self.num_slots = num_slots
        self.num_constraints = num_slots * (1 + num_bits)

    def eval(self, A, wires, consts):
        out = []
        for s in range(self.num_slots):
            base = 33 * s
            value = wires(base)
            acc = A.zero()
            for i in range(self.num_bits - 1, -1, -1):
                bit = wires(base + 1 + i)
                acc = A.add(A.add(acc, acc), bit)  # acc = 2*acc + bit
            out.append(A.sub(acc, value))
            for i in range(self.num_bits):
                bit = wires(base + 1 + i)
                out.append(A.sub(A.mul(bit, bit), bit))
        return out


class ConstantGate(Gate):
    """wire[i] == constant column i, for i < num_slots."""

    name = "const"
    degree = 1

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self.num_constraints = num_slots

    def eval(self, A, wires, consts):
        return [A.sub(wires(i), consts(i)) for i in range(self.num_slots)]


def absorb_quotient_generic(g: Gate, A, wires, consts, sel, apow_rows, accs) -> list:
    """accs[j] + sum_k (sel * C_k) * apow_rows[j][k] over ``g.eval``'s
    constraints C_k, one algebra operation at a time: the quotient's generic
    gate loop, and the plain version of the gates' own kernels
    (``absorb_quotient_device``).  Field addition is associative and every
    word canonical, so any other order of the same sum gives the same words."""
    out = list(accs)
    for k, cval in enumerate(g.eval(A, wires, consts)):
        sc = A.mul(sel, cval)
        for j in range(len(out)):
            out[j] = A.add(out[j], A.mul(sc, apow_rows[j][k]))
    return out


GATE_REGISTRY = {}


def register_gate(gate: Gate) -> Gate:
    GATE_REGISTRY[gate.name] = gate
    return gate


# ---------------------------------------------------------------------------
# Non-executable gate specs (for circuit serialization without pickle)
# ---------------------------------------------------------------------------
#
# A gate is fully described by its type name + constructor params; the
# registry below reconstructs it.  This is what lets CircuitData's
# common-data half (the part the recursive verifier needs) round-trip
# through plain JSON — no code objects in operator-supplied artifacts.


def gate_to_spec(g: Gate) -> dict:
    spec: dict = {"type": g.name}
    if isinstance(g, ArithmeticGate):
        spec["num_ops"] = g.num_ops
    elif isinstance(g, BaseSum2Gate):
        spec["num_bits"] = g.num_bits
        spec["num_slots"] = g.num_slots
    elif isinstance(g, ConstantGate):
        spec["num_slots"] = g.num_slots
    return spec


def gate_from_spec(spec: dict) -> Gate:
    t = spec["type"]
    if t == "noop":
        return NoopGate()
    if t == "arith":
        return ArithmeticGate(num_ops=spec["num_ops"])
    if t == "basesum2":
        return BaseSum2Gate(num_bits=spec["num_bits"], num_slots=spec["num_slots"])
    if t == "const":
        return ConstantGate(num_slots=spec["num_slots"])
    if t == "poseidon":
        from .gates_poseidon import PoseidonGate

        return PoseidonGate()
    if t == "sha256":
        from .gates_sha256 import Sha256RoundGate

        return Sha256RoundGate()
    raise ValueError(f"unknown gate type in spec: {t!r}")
