"""Circuit builder: targets, copy constraints, gadget API, build tables.

Copy of ``eth_lc_plonky2_tpu/circuit/builder.py`` (the port keeps its own;
host-only numpy, and the card's circuit source).  It allocates wire
slots, wires subcircuits together with copy constraints, and compiles
to dense numpy tables (selectors, constant columns, permutation sigma
encoding) that the prover consumes: the role `plonky2::CircuitBuilder`
and `builder.build()` play upstream.

Everything `build()` emits is a dense array; witness generation runs as
vectorized numpy passes over a (rows x wires) matrix (no per-wire
generator graph fixpoint).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np

from ..ops import goldilocks as gl
from ..ops import host_field as hf
from ..prover.config import CircuitConfig
from . import gates as G

P = gl.P


class Target(NamedTuple):
    row: int
    col: int


class _UnionFind:
    def __init__(self):
        self.parent: dict[int, int] = {}

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p.get(root, root) != root:
            root = p[root]
        while p.get(x, x) != x:
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


@dataclasses.dataclass
class Generator:
    """Host witness generator: outputs = fn(*input values)."""

    fn: Callable
    inputs: list[Target]
    outputs: list[Target]

    def run(self, w: "Witness"):
        vals = [w.get(t) for t in self.inputs]
        outs = self.fn(*vals)
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        assert len(outs) == len(self.outputs)
        for t, v in zip(self.outputs, outs):
            w.set(t, int(v) % P)


_BIT_SHIFTS = np.arange(32, dtype=np.uint64)


@dataclasses.dataclass
class BitsGenerator:
    """The 32 little-endian bits of ``inputs[0]`` into the 32 consecutive
    wires of one row from column ``col``: ``split_le``'s generator, in one
    numpy pass."""

    inputs: list[Target]
    row: int
    col: int

    def run(self, w: "Witness"):
        bits = (np.uint64(w.get(self.inputs[0])) >> _BIT_SHIFTS) & np.uint64(1)
        w.set_row_run(self.row, self.col, bits)


@dataclasses.dataclass
class BatchGenerator:
    """Custom vectorized generator (e.g. the SHA-256 trace kernel)."""

    run_fn: Callable  # (witness) -> None
    inputs: list = dataclasses.field(default_factory=list)

    def run(self, w: "Witness"):
        self.run_fn(w)


class CircuitBuilder:
    def __init__(self, config: CircuitConfig | None = None):
        self.config = config or CircuitConfig()
        cfg = self.config
        self.rows: list[str] = []  # gate name per row
        self.row_constants: list[tuple[int, ...]] = []
        self.uf = _UnionFind()
        self.generators: list = []
        self.public_input_targets: list[Target] = []
        self._constant_cache: dict[int, Target] = {}
        # slot cursors
        self._noop_cursor: tuple[int, int] | None = None  # (row, next col)
        self._const_cursor: tuple[int, int] | None = None
        self._arith_cursor: dict[tuple[int, int], tuple[int, int]] = {}  # (c0,c1) -> (row, next op)
        self._basesum_cursor: tuple[int, int] | None = None
        self.gate_types: dict[str, G.Gate] = {}
        self._register(G.NoopGate())

    # ------------------------------------------------------------------
    # Rows / slots
    # ------------------------------------------------------------------

    def _register(self, gate: G.Gate) -> G.Gate:
        if gate.name not in self.gate_types:
            self.gate_types[gate.name] = gate
        return self.gate_types[gate.name]

    def add_row(self, gate: G.Gate, constants: tuple[int, ...] = ()) -> int:
        self._register(gate)
        assert len(constants) <= self.config.num_constants
        self.rows.append(gate.name)
        self.row_constants.append(tuple(int(c) % P for c in constants))
        return len(self.rows) - 1

    def _slot_id(self, t: Target) -> int:
        return t.row * self.config.num_wires + t.col

    def add_virtual_target(self) -> Target:
        """A free routed wire slot (on a NoopGate row)."""
        if self._noop_cursor is None or self._noop_cursor[1] >= self.config.num_routed_wires:
            row = self.add_row(self.gate_types["noop"])
            self._noop_cursor = (row, 0)
        row, col = self._noop_cursor
        self._noop_cursor = (row, col + 1)
        return Target(row, col)

    def add_virtual_targets(self, n: int) -> list[Target]:
        return [self.add_virtual_target() for _ in range(n)]

    # ------------------------------------------------------------------
    # Copy constraints / constants / public inputs
    # ------------------------------------------------------------------

    def connect(self, a: Target, b: Target):
        assert a.col < self.config.num_routed_wires, f"cannot route wire {a}"
        assert b.col < self.config.num_routed_wires, f"cannot route wire {b}"
        self.uf.union(self._slot_id(a), self._slot_id(b))

    def constant(self, value: int) -> Target:
        value = int(value) % P
        if value in self._constant_cache:
            return self._constant_cache[value]
        nc = self.config.num_constants
        if self._const_cursor is None or self._const_cursor[1] >= nc:
            gate = self._register(G.ConstantGate(nc))
            row = self.add_row(gate, tuple([0] * nc))
            self._const_cursor = (row, 0)
        row, col = self._const_cursor
        self._const_cursor = (row, col + 1)
        consts = list(self.row_constants[row])
        consts[col] = value
        self.row_constants[row] = tuple(consts)
        t = Target(row, col)
        self._constant_cache[value] = t
        # witness: constant rows are filled directly
        self.generators.append(Generator(lambda v=value: v, [], [t]))
        return t

    def zero(self) -> Target:
        return self.constant(0)

    def one(self) -> Target:
        return self.constant(1)

    def register_public_input(self, t: Target):
        assert t.col < self.config.num_routed_wires
        self.public_input_targets.append(t)

    def register_public_inputs(self, ts):
        for t in ts:
            self.register_public_input(t)

    # ------------------------------------------------------------------
    # Arithmetic gadgets
    # ------------------------------------------------------------------

    def _arith_slot(self, c0: int, c1: int) -> tuple[int, int]:
        key = (int(c0) % P, int(c1) % P)
        cur = self._arith_cursor.get(key)
        # 4 routed wires per op; narrow configs (e.g. the multichip
        # dryrun's 16-wire circuit) get proportionally fewer ops/row
        gate = self._register(
            G.ArithmeticGate(num_ops=min(20, self.config.num_routed_wires // 4))
        )
        if cur is None or cur[1] >= gate.num_ops:
            row = self.add_row(gate, key)
            cur = (row, 0)
        self._arith_cursor[key] = (cur[0], cur[1] + 1)
        return cur

    def arithmetic(self, c0: int, c1: int, a: Target, b: Target, c: Target) -> Target:
        """out = c0*a*b + c1*c (new target)."""
        row, op = self._arith_slot(c0, c1)
        wa, wb, wc, wo = (Target(row, 4 * op + i) for i in range(4))
        self.connect(a, wa)
        self.connect(b, wb)
        self.connect(c, wc)
        c0m, c1m = int(c0) % P, int(c1) % P
        self.generators.append(
            Generator(lambda x, y, z: (c0m * x * y + c1m * z) % P, [a, b, c], [wo])
        )
        return wo

    def mul(self, a: Target, b: Target) -> Target:
        return self.arithmetic(1, 0, a, b, self.zero())

    def mul_add(self, a: Target, b: Target, c: Target) -> Target:
        """a*b + c"""
        return self.arithmetic(1, 1, a, b, c)

    def add(self, a: Target, b: Target) -> Target:
        return self.arithmetic(1, 1, a, self.one(), b)

    def sub(self, a: Target, b: Target) -> Target:
        # a - b = 1*a*1 + (p-1)*b
        return self.arithmetic(1, P - 1, a, self.one(), b)

    def add_many(self, ts: list[Target]) -> Target:
        if not ts:
            return self.zero()
        acc = ts[0]
        for t in ts[1:]:
            acc = self.add(acc, t)
        return acc

    def mul_const(self, c: int, a: Target) -> Target:
        return self.arithmetic(c, 0, a, self.one(), self.zero())

    def add_const(self, a: Target, c: int) -> Target:
        return self.arithmetic(1, c, a, self.one(), self.one())

    def select(self, b: Target, x: Target, y: Target) -> Target:
        """b ? x : y   (b must be boolean)."""
        d = self.sub(x, y)
        return self.mul_add(b, d, y)

    def assert_zero(self, t: Target):
        self.connect(t, self.zero())

    def assert_equal(self, a: Target, b: Target):
        self.connect(a, b)

    def assert_bool(self, b: Target):
        sq = self.arithmetic(1, P - 1, b, b, b)  # b*b - b
        self.assert_zero(sq)

    def add_virtual_bool_target(self) -> Target:
        b = self.add_virtual_target()
        self.assert_bool(b)
        return b

    def not_(self, b: Target) -> Target:
        # 1 - b = (p-1)*b*1 + 1*one
        return self.arithmetic(P - 1, 1, b, self.one(), self.one())

    def and_(self, a: Target, b: Target) -> Target:
        return self.mul(a, b)

    def or_(self, a: Target, b: Target) -> Target:
        # a + b - ab = (p-1)*a*b + (a+b)
        s = self.add(a, b)
        return self.arithmetic(P - 1, 1, a, b, s)

    def is_equal(self, a: Target, b: Target) -> Target:
        """Boolean target: 1 iff a == b.

        Uses the standard inverse trick: with d = a-b, the prover
        supplies inv0(d); constraints d*inv = 1 - eq and d*eq = 0.
        """
        d = self.sub(a, b)
        inv = self.add_virtual_target()
        eq = self.add_virtual_target()
        self.generators.append(
            Generator(
                lambda dv: (pow(dv, P - 2, P) if dv else 0, 1 if dv == 0 else 0),
                [d],
                [inv, eq],
            )
        )
        # d*inv - (1 - eq) == 0
        lhs = self.mul(d, inv)
        one_minus = self.not_(eq)
        self.assert_equal(lhs, one_minus)
        # d*eq == 0
        z = self.mul(d, eq)
        self.assert_zero(z)
        return eq

    # ------------------------------------------------------------------
    # Decomposition / range checks
    # ------------------------------------------------------------------

    def split_le(self, t: Target, num_bits: int = 32) -> list[Target]:
        """Split into `num_bits` little-endian boolean targets (range check).

        Uses BaseSum2Gate rows (32 bits per slot); for num_bits<32 the
        high bits are constrained to zero by connecting them to zero.
        """
        assert num_bits <= 32
        gate = self._register(G.BaseSum2Gate())
        if self._basesum_cursor is None or self._basesum_cursor[1] >= gate.num_slots:
            row = self.add_row(gate)
            self._basesum_cursor = (row, 0)
        row, slot = self._basesum_cursor
        self._basesum_cursor = (row, slot + 1)
        base = 33 * slot
        value_wire = Target(row, base)
        self.connect(t, value_wire)
        bits = [Target(row, base + 1 + i) for i in range(32)]
        self.generators.append(BitsGenerator([t], row, base + 1))
        zero = self.zero()
        for i in range(num_bits, 32):
            self.connect(bits[i], zero)
        return bits[:num_bits]

    def le_sum(self, bits: list[Target]) -> Target:
        """Recompose little-endian bits into a value: sum b_i 2^i."""
        acc = self.zero()
        for b in reversed(bits):
            # acc = 2*acc + b
            acc = self.arithmetic(2, 1, acc, self.one(), b)
        return acc

    def range_check_u32(self, t: Target):
        self.split_le(t, 32)

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------

    def build(self) -> "CircuitData":
        cfg = self.config
        num_rows_used = len(self.rows)
        log_n = max(2, (num_rows_used + 1 - 1).bit_length())
        # ensure at least one padding row (next-row refs must not wrap into data)
        if (1 << log_n) == num_rows_used:
            log_n += 1
        n = 1 << log_n
        nw = cfg.num_wires

        gate_names = sorted(self.gate_types)
        selectors = np.zeros((len(gate_names), n), dtype=np.uint64)
        name_to_idx = {g: i for i, g in enumerate(gate_names)}
        for r, gname in enumerate(self.rows):
            selectors[name_to_idx[gname], r] = 1
        # pad rows are implicit noop (all-zero selectors for constrained gates)
        constants = np.zeros((cfg.num_constants, n), dtype=np.uint64)
        for r, consts in enumerate(self.row_constants):
            for i, c in enumerate(consts):
                constants[i, r] = c

        # --- permutation sigma ---
        # the copy classes over routed slots, as arrays sorted by class and,
        # within a class, by slot id (row-major: the (row, col) order)
        find = self.uf.find
        ids = np.fromiter(self.uf.parent.keys(), np.int64, len(self.uf.parent))
        roots = np.fromiter((find(int(i)) for i in ids), np.int64, len(ids))
        ids, first = np.unique(np.concatenate([ids, roots]), return_index=True)
        roots = np.concatenate([roots, roots])[first]
        routed = ids % nw < cfg.num_routed_wires
        ids, roots = ids[routed], roots[routed]
        order = np.lexsort((ids, roots))
        ids, roots = ids[order], roots[order]
        starts = np.ones(len(ids), bool)  # a class's first slot, its head
        starts[1:] = roots[1:] != roots[:-1]
        ends = np.ones(len(ids), bool)
        ends[:-1] = starts[1:]
        heads = ids[np.flatnonzero(starts)[np.cumsum(starts) - 1]]  # each slot's head
        # each slot points at the next member of its class, the last at the head
        nexts = np.roll(ids, -1)
        nexts[ends] = heads[ends]
        # sigma defaults to identity
        omega_pows = hf.powers(gl.primitive_root_of_unity(log_n), n)
        k_shifts = hf.powers(gl.MULTIPLICATIVE_GENERATOR, cfg.num_routed_wires)
        sigma = np.empty((cfg.num_routed_wires, n), dtype=np.uint64)
        for c in range(cfg.num_routed_wires):
            sigma[c, :] = hf.mul(np.uint64(k_shifts[c]), omega_pows)
        sigma[ids % nw, ids // nw] = hf.mul(k_shifts[nexts % nw], omega_pows[nexts // nw])

        # representative mapping for witness get/set: each slot's class head
        rep = np.arange(n * nw, dtype=np.int64)
        rep[ids] = heads

        gate_objs = [self.gate_types[g] for g in gate_names]
        return CircuitData(
            config=cfg,
            log_n=log_n,
            num_rows_used=num_rows_used,
            gate_names=gate_names,
            gates=gate_objs,
            selectors=selectors,
            constants=constants,
            sigma=sigma,
            rep=rep,
            generators=list(self.generators),
            public_input_targets=list(self.public_input_targets),
            k_shifts=k_shifts.copy(),
        )


@dataclasses.dataclass
class CircuitData:
    """Built circuit tables (the preprocessed half of the proving key)."""

    config: CircuitConfig
    log_n: int
    num_rows_used: int
    gate_names: list[str]
    gates: list[G.Gate]
    selectors: np.ndarray  # (num_gate_types, n) u64 0/1
    constants: np.ndarray  # (num_constants, n) u64
    sigma: np.ndarray  # (num_routed, n) u64 encoded permutation
    rep: np.ndarray  # (n*num_wires,) representative slot ids
    generators: list
    public_input_targets: list[Target]
    k_shifts: np.ndarray  # (num_routed,) coset shifts k_c

    @property
    def n(self) -> int:
        return 1 << self.log_n

    def new_witness(self) -> "Witness":
        return Witness(self)


class Witness:
    """Dense (rows x wires) witness with copy-class representative aliasing."""

    def __init__(self, data: CircuitData):
        self.data = data
        nw = self._nw = data.config.num_wires
        self._rep = data.rep
        self.values = np.zeros(data.n * nw, dtype=np.uint64)
        self.known = np.zeros(data.n * nw, dtype=bool)

    def _sid(self, t: Target) -> int:
        return int(self._rep[t.row * self._nw + t.col])

    def set(self, t: Target, v: int):
        sid = self._sid(t)
        v = int(v) % P
        if self.known[sid] and int(self.values[sid]) != v:
            raise ValueError(
                f"conflicting witness value at {t}: {int(self.values[sid])} vs {v}"
            )
        self.values[sid] = v
        self.known[sid] = True

    def get(self, t: Target) -> int:
        sid = self._sid(t)
        if not self.known[sid]:
            raise KeyError(f"witness value not set for {t}")
        return int(self.values[sid])

    def set_row_run(self, row: int, col: int, vals: np.ndarray):
        """``set`` of ``len(vals)`` consecutive wires of one row from ``col``,
        as one numpy pass: the same values, and a ValueError where one
        conflicts with a known value or with another of the run's (two of its
        wires may share a copy class)."""
        start = row * self._nw + col
        sids = self._rep[start:start + len(vals)]
        bad = self.known[sids] & (self.values[sids] != vals)
        if not bad.any():
            self.values[sids] = vals
            bad = self.values[sids] != vals
            if not bad.any():
                self.known[sids] = True
                return
        i = int(np.argmax(bad))
        raise ValueError(f"conflicting witness value at {Target(row, col + i)}: "
                         f"{int(self.values[sids[i]])} vs {int(vals[i])}")

    def set_many(self, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray):
        """Vectorized set (no conflict check) for batch generators."""
        sids = self.data.rep[rows.astype(np.int64) * self.data.config.num_wires + cols.astype(np.int64)]
        self.values[sids] = np.asarray(vals, dtype=np.uint64) % np.uint64(P)
        self.known[sids] = True

    def _ready(self, g) -> bool:
        return all(self.known[self._sid(t)] for t in g.inputs)

    def generate(self):
        """Run all witness generators to fixpoint.

        Creation order resolves almost everything in one pass; a
        generator whose inputs are produced later (e.g. a range check
        on a div_rem output) is retried on the next pass.
        """
        pending = list(self.data.generators)
        while pending:
            remaining = []
            for g in pending:
                if self._ready(g):
                    g.run(self)
                else:
                    remaining.append(g)
            if len(remaining) == len(pending):
                raise RuntimeError(
                    f"witness generation stuck: {len(remaining)} generators "
                    f"wait on unset inputs (first: {remaining[0].inputs[:4]})"
                )
            pending = remaining

    def full_matrix(self) -> np.ndarray:
        """(num_wires, n) u64 matrix with copy classes materialized."""
        nw = self.data.config.num_wires
        mat = self.values[self.data.rep].reshape(self.data.n, nw)
        return mat.T.copy()
