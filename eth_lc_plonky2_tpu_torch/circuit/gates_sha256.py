"""In-circuit SHA-256 as an AIR-style row segment.

Port of ``eth_lc_plonky2_tpu/circuit/gates_sha256.py``: the gate's layout,
``eval``, the builder-side segment construction and the batched witness
generator are the JAX package's; the gate's share of the quotient on the
card is the hand-written kernel ``sha_gate_quotient_kernel`` of
``csrc/gates.cu`` (in place of the XLA-fused ``absorb_sha_quotient``).

Instead of thousands of generic gate rows per compression, one
compression is a uniform 68-row segment:

  rows 0..3   prologue: initial state (d,c,b,a) / (h,g,f,e) as bits
  rows 4..67  round rows t = 0..63

Per-row columns: bits of the working words a, e and schedule word W
(32 advice columns each), their u32 word values on 3 ROUTED columns
(so the permutation argument carries boundary values in/out), and 3
small carry columns.  Transition constraints reference neighbor rows
at offsets {-1,-2,-3,-4,-7,-15,-16}; per-row round constants K_t and
position masks live in preprocessed constant columns.  The witness for
ALL compressions is generated by one batched trace pass
(ops/sha256.compress_trace_np).

The feed-forward (digest = init + final state) is done with generic
u32 adds outside the segment, connected through the routed word
columns.
"""

from __future__ import annotations

import numpy as np

from ..ops import kernels
from ..ops import sha256 as shaops
from .builder import BatchGenerator, CircuitBuilder, Target
from .gates import Gate

# --- column layout ---------------------------------------------------------
COL_WA = 0  # routed: word value of a-bits on this row
COL_WE = 1  # routed: word value of e-bits
COL_WW = 2  # routed: word value of w-bits
A_BITS = 80
E_BITS = 112
W_BITS = 144
CARRY_A = 176
CARRY_E = 177
CARRY_W = 178
NUM_WIRES_REQUIRED = 179

# --- constant-column roles on sha rows ------------------------------------
CONST_K = 0  # round constant K_t (0 off round rows)
CONST_ROUND = 1  # 1 on round rows (t = 0..63)
CONST_SCHED = 2  # 1 on round rows with t >= 16
CONST_BITS = 3  # 1 on all segment rows (prologue + rounds)

ROWS_PER_COMPRESSION = 68
PROLOGUE = 4

# --- constraint index layout of eval(), which csrc/gates.cu mirrors --------
K_ROUND_E = 0  # round constraint for e
K_ROUND_A = 1  # round constraint for a (differenced)
K_SCHED = 2  # message schedule
K_WORD = 3  # 3..5: word/bit consistency of a, e, w
K_BOOL = 6  # 6..101: booleanity of the a, e, w bits
K_CARRY = 102  # 102..104: carry ranges of a, e, w
NUM_CONSTRAINTS = 105

# the wire layout in the order of csrc/gates.cu's ShaLayout
KERNEL_LAYOUT = (COL_WA, COL_WE, COL_WW, A_BITS, E_BITS, W_BITS, CARRY_A, CARRY_E, CARRY_W)

TWO32 = 1 << 32


def _word(A, bits):
    """sum bits[i] * 2^i via Horner (bits little-endian)."""
    acc = A.zero()
    for b in reversed(bits):
        acc = A.add(A.add(acc, acc), b)
    return acc


def _xor2(A, x, y):
    s = A.add(x, y)
    return A.sub(s, A.add(A.mul(x, y), A.mul(x, y)))


def _xor3(A, x, y, z):
    # x+y+z - 2(xy+yz+zx) + 4xyz
    xy = A.mul(x, y)
    yz = A.mul(y, z)
    zx = A.mul(z, x)
    xyz = A.mul(xy, z)
    s = A.add(A.add(x, y), z)
    pair = A.add(A.add(xy, yz), zx)
    four = A.add(A.add(xyz, xyz), A.add(xyz, xyz))
    return A.add(A.sub(s, A.add(pair, pair)), four)


def _rotr_bits(bits, r):
    """bits of rotr(word, r): out[i] = in[(i + r) % 32]."""
    return [bits[(i + r) % 32] for i in range(32)]


def _shr_bits(A, bits, r):
    """bits of (word >> r): out[i] = in[i+r] for i+r<32 else 0."""
    zero = A.zero()
    return [bits[i + r] if i + r < 32 else zero for i in range(32)]


def _xor3_word(A, xs, ys, zs):
    return _word(A, [_xor3(A, x, y, z) for x, y, z in zip(xs, ys, zs)])


class Sha256RoundGate(Gate):
    """The SHA-256 segment gate: all segment constraints, mask-gated."""

    name = "sha256"
    degree = 8  # carry range product (7) * mask column (1)
    wire_offsets = (0, -1, -2, -3, -4, -7, -15, -16)

    def __init__(self):
        # 2 round + 1 schedule + 3 word-consistency + 96 booleanity + 3 carries
        self.num_constraints = 2 + 1 + 3 + 96 + 3
        assert self.num_constraints == NUM_CONSTRAINTS

    def eval(self, A, wires, consts):
        k_t = consts(CONST_K)
        m_round = consts(CONST_ROUND)
        m_sched = consts(CONST_SCHED)
        m_bits = consts(CONST_BITS)

        a_bits = [wires(A_BITS + i) for i in range(32)]
        e_bits = [wires(E_BITS + i) for i in range(32)]
        w_bits = [wires(W_BITS + i) for i in range(32)]
        e1 = [wires(E_BITS + i, -1) for i in range(32)]  # e entering the round
        e2 = [wires(E_BITS + i, -2) for i in range(32)]  # f
        e3 = [wires(E_BITS + i, -3) for i in range(32)]  # g
        a1 = [wires(A_BITS + i, -1) for i in range(32)]  # a
        a2 = [wires(A_BITS + i, -2) for i in range(32)]  # b
        a3 = [wires(A_BITS + i, -3) for i in range(32)]  # c

        out = []
        two32 = A.constant(TWO32)

        # --- round constraint for e: we + ce*2^32 = d + h + S1(e) + ch + K + W
        s1 = _xor3_word(A, _rotr_bits(e1, 6), _rotr_bits(e1, 11), _rotr_bits(e1, 25))
        ch = _word(
            A,
            [
                A.add(A.mul(e, f), A.sub(g, A.mul(e, g)))
                for e, f, g in zip(e1, e2, e3)
            ],
        )
        t1 = A.add(
            A.add(wires(COL_WE, -4), s1),
            A.add(ch, A.add(k_t, wires(COL_WW))),
        )
        rhs_e = A.add(wires(COL_WA, -4), t1)
        lhs_e = A.add(wires(COL_WE), A.mul(wires(CARRY_E), two32))
        out.append(A.mul(m_round, A.sub(lhs_e, rhs_e)))

        # --- round constraint for a (differenced to avoid recomputing T1):
        # (wa - we) + (ca - ce)*2^32 = S0(a) + maj - d
        s0 = _xor3_word(A, _rotr_bits(a1, 2), _rotr_bits(a1, 13), _rotr_bits(a1, 22))
        maj = _word(
            A,
            [
                A.sub(
                    A.add(A.add(A.mul(x, y), A.mul(x, z)), A.mul(y, z)),
                    A.add(A.mul(A.mul(x, y), z), A.mul(A.mul(x, y), z)),
                )
                for x, y, z in zip(a1, a2, a3)
            ],
        )
        lhs_a = A.add(
            A.sub(wires(COL_WA), wires(COL_WE)),
            A.mul(A.sub(wires(CARRY_A), wires(CARRY_E)), two32),
        )
        rhs_a = A.sub(A.add(s0, maj), wires(COL_WA, -4))
        out.append(A.mul(m_round, A.sub(lhs_a, rhs_a)))

        # --- schedule: ww + cw*2^32 = s1(w[-2]) + w[-7] + s0(w[-15]) + w[-16]
        w2 = [wires(W_BITS + i, -2) for i in range(32)]
        w15 = [wires(W_BITS + i, -15) for i in range(32)]
        sig1 = _xor3_word(A, _rotr_bits(w2, 17), _rotr_bits(w2, 19), _shr_bits(A, w2, 10))
        sig0 = _xor3_word(A, _rotr_bits(w15, 7), _rotr_bits(w15, 18), _shr_bits(A, w15, 3))
        lhs_w = A.add(wires(COL_WW), A.mul(wires(CARRY_W), two32))
        rhs_w = A.add(A.add(sig1, wires(COL_WW, -7)), A.add(sig0, wires(COL_WW, -16)))
        out.append(A.mul(m_sched, A.sub(lhs_w, rhs_w)))

        # --- word/bit consistency (all segment rows)
        out.append(A.mul(m_bits, A.sub(wires(COL_WA), _word(A, a_bits))))
        out.append(A.mul(m_bits, A.sub(wires(COL_WE), _word(A, e_bits))))
        out.append(A.mul(m_bits, A.sub(wires(COL_WW), _word(A, w_bits))))

        # --- booleanity
        for bits in (a_bits, e_bits, w_bits):
            for b in bits:
                out.append(A.mul(m_bits, A.sub(A.mul(b, b), b)))

        # --- carry ranges: prod_{v=0..6}(c - v) = 0 (ca, ce); v=0..3 (cw)
        def range_prod(c, hi):
            acc = c
            for v in range(1, hi + 1):
                acc = A.mul(acc, A.sub(c, A.constant(v)))
            return acc

        out.append(A.mul(m_round, range_prod(wires(CARRY_A), 6)))
        out.append(A.mul(m_round, range_prod(wires(CARRY_E), 6)))
        out.append(A.mul(m_sched, range_prod(wires(CARRY_W), 3)))
        return out

    def absorb_quotient_device(self, wires_lde, consts, sel, apow_rows, accs, rate, window=False):
        """This gate's selector-weighted, alpha-combined constraints added to
        ``accs``, on the card: one launch of ``sha_gate_quotient_kernel``.

        wires_lde: (num_wires, n_lde) CUDA field tensor; consts: i -> the
        (n_lde,) constant-column row; sel: this gate's (n_lde,) selector row;
        apow_rows: per challenge the (105,) alpha powers in constraint order;
        accs: one (n_lde,) accumulator a challenge, updated in place.  Returns
        the accumulators, holding what the generic loop over ``eval()`` gives,
        word for word (its plain version, which runs for a CPU tensor).
        ``window``: the kernel's window form (a shard's points, the wires a
        view whose halos hold the neighbour rows).
        """
        const_rows = tuple(consts(i) for i in (CONST_K, CONST_ROUND, CONST_SCHED, CONST_BITS))
        return kernels.sha_gate_quotient(wires_lde, KERNEL_LAYOUT, const_rows, sel,
                                         apow_rows, accs, rate, window)


# ---------------------------------------------------------------------------
# Builder-side segment construction + batched witness generation
# ---------------------------------------------------------------------------


class _ShaInstance:
    def __init__(self, start_row: int, init_targets, block_targets):
        self.start_row = start_row
        self.init_targets = init_targets  # 8 word targets (state in)
        self.block_targets = block_targets  # 16 word targets (message block)


def add_sha256_compressions(b: CircuitBuilder, instances):
    """Append SHA-256 compression segments; returns list of 8-word digests.

    instances: list of (init_words, block_words) where each is a list of
    8 / 16 u32 targets.  One batched witness generator covers them all.
    """
    from .gadgets_u32 import add_u32_mod

    assert b.config.num_wires >= NUM_WIRES_REQUIRED, (
        f"SHA-256 segment needs num_wires >= {NUM_WIRES_REQUIRED}"
    )
    gate = Sha256RoundGate()
    b._register(gate)
    recs = []
    for init_words, block_words in instances:
        assert len(init_words) == 8 and len(block_words) == 16
        start = len(b.rows)
        # prologue rows hold (d,c,b,a)/(h,g,f,e): row p -> state index 3-p
        for p in range(PROLOGUE):
            row = b.add_row(gate, (0, 0, 0, 1))
            b.connect(Target(row, COL_WA), init_words[3 - p])  # d,c,b,a
            b.connect(Target(row, COL_WE), init_words[7 - p])  # h,g,f,e
            # ww unused on prologue rows; word-consistency still binds it to
            # its bits (both witness-filled as zero)
        for t in range(64):
            k_t = int(shaops.K[t])
            row = b.add_row(gate, (k_t, 1, 1 if t >= 16 else 0, 1))
            if t < 16:
                b.connect(Target(row, COL_WW), block_words[t])
        recs.append(_ShaInstance(start, list(init_words), list(block_words)))

    # trace generator FIRST (feed-forward adds read the final-state words)
    all_inputs = [t for rec in recs for t in rec.init_targets + rec.block_targets]
    b.generators.append(
        BatchGenerator(_make_sha_generator(b.config.num_wires, recs), inputs=all_inputs)
    )

    digests = []
    for rec in recs:
        # feed-forward: digest_j = init_j + final_j mod 2^32
        # final a,b,c,d are the a-words of rounds 63,62,61,60; e..h likewise
        last = rec.start_row + PROLOGUE + 63
        final_words = [Target(last - j, COL_WA) for j in range(4)] + [
            Target(last - j, COL_WE) for j in range(4)
        ]
        digest = [add_u32_mod(b, rec.init_targets[j], final_words[j]) for j in range(8)]
        digests.append(digest)
    return digests


def _make_sha_generator(num_wires: int, recs):
    def run(w):
        n_inst = len(recs)
        init = np.zeros((n_inst, 8), dtype=np.uint32)
        block = np.zeros((n_inst, 16), dtype=np.uint32)
        for i, rec in enumerate(recs):
            for j, t in enumerate(rec.init_targets):
                init[i, j] = w.get(t)
            for j, t in enumerate(rec.block_targets):
                block[i, j] = w.get(t)
        tr = shaops.compress_trace_np(init, block)
        # assemble the per-row word streams:
        # rows 0..3: a-words = d,c,b,a = init[3],init[2],init[1],init[0]
        #            e-words = h,g,f,e
        a_words = np.concatenate([init[:, [3, 2, 1, 0]], tr["a"]], axis=1)  # (N, 68)
        e_words = np.concatenate([init[:, [7, 6, 5, 4]], tr["e"]], axis=1)
        w_words = np.concatenate([np.zeros((n_inst, 4), dtype=np.uint32), tr["w"]], axis=1)
        carry_a = np.concatenate([np.zeros((n_inst, 4), dtype=np.uint32), tr["carry_a"]], axis=1)
        carry_e = np.concatenate([np.zeros((n_inst, 4), dtype=np.uint32), tr["carry_e"]], axis=1)
        carry_w = np.concatenate([np.zeros((n_inst, 4), dtype=np.uint32), tr["carry_w"]], axis=1)

        starts = np.array([rec.start_row for rec in recs], dtype=np.int64)
        rows = (starts[:, None] + np.arange(ROWS_PER_COMPRESSION)[None, :]).ravel()

        def scatter(col, vals):
            w.set_many(rows, np.full(rows.shape, col, dtype=np.int64), vals.ravel().astype(np.uint64))

        scatter(COL_WA, a_words)
        scatter(COL_WE, e_words)
        scatter(COL_WW, w_words)
        scatter(CARRY_A, carry_a)
        scatter(CARRY_E, carry_e)
        scatter(CARRY_W, carry_w)
        for i in range(32):
            bit = np.uint32(1) << np.uint32(i)
            scatter(A_BITS + i, (a_words & bit) >> np.uint32(i))
            scatter(E_BITS + i, (e_words & bit) >> np.uint32(i))
            scatter(W_BITS + i, (w_words & bit) >> np.uint32(i))

    return run
