"""In-circuit Poseidon permutation: the recursion layer's hash gate.

Port of ``eth_lc_plonky2_tpu/circuit/gates_poseidon.py`` (the counterpart
of plonky2's PoseidonGate): the gate's layout, ``eval``, the builder
functions and the batched witness generator are the JAX package's; the
gate's share of the quotient on the card is the hand-written kernel
``poseidon_gate_quotient_kernel`` of ``csrc/gates.cu`` (in place of the
XLA-fused ``absorb_poseidon_quotient``).  One ROW per full width-12
permutation:

  wires 0..11    input state  (routed)
  wires 12..23   output state (routed)
  wires 24..141  s-box outputs, in round order: 4 full rounds x 12,
                 22 partial rounds x 1, 4 full rounds x 12

Round constants are baked into the gate's constraint polynomials (no
constant columns).  Between s-boxes the state is a LINEAR function of
earlier wires, so every constraint is degree <= 7 (x^7 s-box), 8 with
the selector: the same budget as the SHA segment gate.

The witness for ALL permutation rows is generated by one batched
numpy trace pass (ops.poseidon.permute_trace_np).
"""

from __future__ import annotations

import numpy as np

from ..ops import kernels
from ..ops import poseidon as pos
from .builder import BatchGenerator, CircuitBuilder, Target
from .gates import Gate

W_IN = 0
W_OUT = 12
W_ADV = 24
NUM_ADVICE = pos.N_FULL_ROUNDS * pos.WIDTH + pos.N_PARTIAL_ROUNDS  # 118
NUM_WIRES_REQUIRED = W_ADV + NUM_ADVICE  # 142
KERNEL_LAYOUT = (W_IN, W_OUT, W_ADV)  # in the order of csrc/gates.cu's PoseidonLayout


def _mds(A, st):
    out = []
    for r in range(pos.WIDTH):
        acc = None
        for i in range(pos.WIDTH):
            term = A.mul_small(pos.MDS_CIRC[i], st[(r + i) % pos.WIDTH])
            acc = term if acc is None else A.add(acc, term)
        if pos.MDS_DIAG[r]:
            acc = A.add(acc, A.mul_small(pos.MDS_DIAG[r], st[r]))
        out.append(acc)
    return out


def _x7(A, x):
    x2 = A.mul(x, x)
    x3 = A.mul(x2, x)
    x6 = A.mul(x3, x3)
    return A.mul(x6, x)


class PoseidonGate(Gate):
    """One full Poseidon permutation per row."""

    name = "poseidon"
    degree = 7
    wire_offsets = (0,)

    def __init__(self):
        self.num_constraints = NUM_ADVICE + pos.WIDTH  # 130

    def absorb_quotient_device(self, wires_lde, consts, sel, apow_rows, accs, rate, window=False):
        """This gate's selector-weighted, alpha-combined constraints added to
        ``accs``, on the card: one launch of ``poseidon_gate_quotient_kernel``.

        wires_lde: (num_wires, n_lde) CUDA field tensor; sel: this gate's
        (n_lde,) selector row; apow_rows: per challenge the (130,) alpha
        powers in constraint order; accs: one (n_lde,) accumulator a
        challenge, updated in place (``consts``, ``rate`` and ``window`` are
        not used: the gate has no constant column and reads no neighbouring
        row, so a shard's points are a view of its window).  Returns
        the accumulators, holding what the generic loop over ``eval()`` gives,
        word for word (its plain version, which runs for a CPU tensor).
        """
        return kernels.poseidon_gate_quotient(wires_lde, KERNEL_LAYOUT, pos.kernel_constants(),
                                              sel, apow_rows, accs)

    def eval(self, A, wires, consts):
        rc = pos.round_constants()
        st = [wires(W_IN + i) for i in range(pos.WIDTH)]
        out = []
        adv = W_ADV
        half = pos.N_FULL_ROUNDS // 2
        ridx = 0

        def add_rc(state):
            return [
                A.add(s, A.constant(int(rc[ridx * pos.WIDTH + i])))
                for i, s in enumerate(state)
            ]

        for _ in range(half):
            st = add_rc(st)
            for i in range(pos.WIDTH):
                w = wires(adv)
                out.append(A.sub(_x7(A, st[i]), w))
                st[i] = w
                adv += 1
            st = _mds(A, st)
            ridx += 1
        for _ in range(pos.N_PARTIAL_ROUNDS):
            st = add_rc(st)
            w = wires(adv)
            out.append(A.sub(_x7(A, st[0]), w))
            st[0] = w
            adv += 1
            st = _mds(A, st)
            ridx += 1
        for _ in range(half):
            st = add_rc(st)
            for i in range(pos.WIDTH):
                w = wires(adv)
                out.append(A.sub(_x7(A, st[i]), w))
                st[i] = w
                adv += 1
            st = _mds(A, st)
            ridx += 1
        for i in range(pos.WIDTH):
            out.append(A.sub(wires(W_OUT + i), st[i]))
        return out


def add_poseidon_permutations(b: CircuitBuilder, input_states: list) -> list:
    """Append one permutation row per 12-target input state.

    Returns the list of 12-target output states.  One batched witness
    generator covers all rows.
    """
    assert b.config.num_wires >= NUM_WIRES_REQUIRED, (
        f"Poseidon gate needs num_wires >= {NUM_WIRES_REQUIRED}"
    )
    gate = PoseidonGate()
    b._register(gate)
    rows = []
    outs = []
    for state in input_states:
        assert len(state) == pos.WIDTH
        row = b.add_row(gate)
        for i, t in enumerate(state):
            b.connect(Target(row, W_IN + i), t)
        rows.append(row)
        outs.append([Target(row, W_OUT + i) for i in range(pos.WIDTH)])
    all_inputs = [t for state in input_states for t in state]
    b.generators.append(
        BatchGenerator(
            _make_poseidon_generator(rows, [list(s) for s in input_states]),
            inputs=all_inputs,
        )
    )
    return outs


def _make_poseidon_generator(rows, input_states):
    def run(w):
        n = len(rows)
        states = np.zeros((n, pos.WIDTH), dtype=np.uint64)
        for k, state in enumerate(input_states):
            for i, t in enumerate(state):
                states[k, i] = w.get(t)
        adv, out = pos.permute_trace_np(states)
        rows_a = np.asarray(rows, dtype=np.int64)
        cols_adv = np.arange(W_ADV, W_ADV + NUM_ADVICE, dtype=np.int64)
        w.set_many(
            np.repeat(rows_a, NUM_ADVICE),
            np.tile(cols_adv, n),
            adv.ravel(),
        )
        cols_out = np.arange(W_OUT, W_OUT + pos.WIDTH, dtype=np.int64)
        w.set_many(
            np.repeat(rows_a, pos.WIDTH),
            np.tile(cols_out, n),
            out.ravel(),
        )

    return run


# ---------------------------------------------------------------------------
# Sponge gadgets (mirror ops.poseidon hashing semantics exactly)
# ---------------------------------------------------------------------------


def hash_no_pad_circuit(b: CircuitBuilder, inputs: list) -> list:
    """In-circuit hash_no_pad: absorb rate-8 chunks, return 4-target digest."""
    zero = b.zero()
    state = [zero] * pos.WIDTH
    for start in range(0, len(inputs), pos.SPONGE_RATE):
        chunk = inputs[start : start + pos.SPONGE_RATE]
        state = list(chunk) + state[len(chunk) :]
        state = add_poseidon_permutations(b, [state])[0]
    return state[: pos.DIGEST_LEN]


def compress_circuit(b: CircuitBuilder, left4: list, right4: list) -> list:
    """In-circuit two-to-one digest compression."""
    zero = b.zero()
    state = list(left4) + list(right4) + [zero] * (pos.WIDTH - 8)
    state = add_poseidon_permutations(b, [state])[0]
    return state[: pos.DIGEST_LEN]
