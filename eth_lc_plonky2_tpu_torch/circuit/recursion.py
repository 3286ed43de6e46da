"""Recursion layer (L4): verify a proof of THIS proof system in-circuit.

Copy of ``eth_lc_plonky2_tpu/circuit/recursion.py`` (the port keeps its
own; host-only builder code).  The counterpart of plonky2's recursive
verifier as upstream uses it: `add_virtual_proof_with_pis` /
`add_virtual_verifier_data` / `verify_proof` at targets.rs:468-470 and the
witness setters at targets.rs:896-897.

The gadget is a target-level mirror of prover/verify.py: the SAME gate
`eval` definitions run here through a third algebra (CircuitExtAlgebra
— targets instead of device arrays / host ints), the Fiat-Shamir
transcript is replayed with in-circuit Poseidon permutation gates, and
every Merkle path, FRI fold, and the final-polynomial evaluation is
checked with constraint logic driven by transcript-derived query
indices (bit-decomposed challenges + select trees).

Shape is driven by the inner circuit's CircuitData — the counterpart
of plonky2's CommonCircuitData.
"""

from __future__ import annotations

import dataclasses

from ..ops import goldilocks as gl
from ..ops import poseidon as pos
from .builder import CircuitBuilder, Target
from . import gadgets_ext as gx
from .gadgets_ext import ExtTarget
from .gates_poseidon import add_poseidon_permutations

P = gl.P
SHIFT = gl.MULTIPLICATIVE_GENERATOR


# ---------------------------------------------------------------------------
# Shape helpers (must match prover/verify.py exactly)
# ---------------------------------------------------------------------------


def batch_counts(data) -> dict:
    cfg = data.config
    return {
        "P": len(data.gate_names) + cfg.num_constants + cfg.num_routed_wires,
        "W": cfg.num_wires,
        "Z": cfg.num_challenges * cfg.num_permutation_chunks,
        "Q": cfg.num_challenges * (1 << cfg.rate_bits),
    }


def fri_shape(data) -> tuple[int, int]:
    """(num_fold_layers, final_poly_len)."""
    cfg = data.config
    n_lde = data.n << cfg.rate_bits
    stop = 1 << (cfg.fri.final_poly_bits + cfg.fri.rate_bits)
    layers = 0
    sz = n_lde
    while sz > stop:
        layers += 1
        sz //= 2
    return layers, sz >> cfg.fri.rate_bits


def layer_cap_height(num_leaves: int) -> int:
    return min(4, num_leaves.bit_length() - 1)


# ---------------------------------------------------------------------------
# Targets
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QueryProofTarget:
    batch_leaves: dict  # tag -> list[Target]
    batch_paths: dict  # tag -> list[digest(4 Targets)]
    layer_leaves: list  # per layer: 4 Targets [re0, im0, re1, im1]
    layer_paths: list  # per layer: list[digest]


@dataclasses.dataclass
class ProofWithPisTarget:
    public_inputs: list
    wires_cap: list  # 2^cap digests
    zs_cap: list
    quotient_cap: list
    openings: dict  # (tag, off) -> list[ExtTarget]
    layer_caps: list  # per fold layer: list of digests
    final_poly: list  # list[ExtTarget]
    pow_witness: Target = None
    queries: list = None


@dataclasses.dataclass
class VerifierDataTarget:
    pre_cap: list  # 2^cap digests


def _digests(b: CircuitBuilder, n: int) -> list:
    return [b.add_virtual_targets(4) for _ in range(n)]


def opening_point_specs(data):
    from ..prover.prove import opening_point_specs as specs

    return specs(data)


def add_virtual_proof_with_pis(b: CircuitBuilder, data) -> ProofWithPisTarget:
    """Allocate targets for every field of an inner proof (shape from
    the inner CircuitData)."""
    cfg = data.config
    cap_n = 1 << cfg.cap_height
    counts = batch_counts(data)
    num_layers, final_len = fri_shape(data)
    n_lde = data.n << cfg.rate_bits
    specs = opening_point_specs(data)

    openings = {}
    for tag, off in specs:
        openings[(tag, off)] = [gx.add_virtual_ext(b) for _ in range(counts[tag])]

    layer_caps = []
    sz = n_lde
    for _ in range(num_layers):
        layer_caps.append(_digests(b, 1 << layer_cap_height(sz // 2)))
        sz //= 2

    queries = []
    for _ in range(cfg.fri.num_query_rounds):
        b_leaves = {t: b.add_virtual_targets(counts[t]) for t in ("P", "W", "Z", "Q")}
        depth = (data.log_n + cfg.rate_bits) - cfg.cap_height
        b_paths = {t: _digests(b, depth) for t in ("P", "W", "Z", "Q")}
        l_leaves = []
        l_paths = []
        sz = n_lde
        for li in range(num_layers):
            h = sz // 2
            l_leaves.append(b.add_virtual_targets(4))
            l_paths.append(_digests(b, (h.bit_length() - 1) - layer_cap_height(h)))
            sz = h
        queries.append(
            QueryProofTarget(
                batch_leaves=b_leaves, batch_paths=b_paths,
                layer_leaves=l_leaves, layer_paths=l_paths,
            )
        )

    return ProofWithPisTarget(
        public_inputs=b.add_virtual_targets(len(data.public_input_targets)),
        wires_cap=_digests(b, cap_n),
        zs_cap=_digests(b, cap_n),
        quotient_cap=_digests(b, cap_n),
        openings=openings,
        layer_caps=layer_caps,
        final_poly=[gx.add_virtual_ext(b) for _ in range(final_len)],
        pow_witness=b.add_virtual_target(),
        queries=queries,
    )


def add_virtual_verifier_data(b: CircuitBuilder, data) -> VerifierDataTarget:
    return VerifierDataTarget(pre_cap=_digests(b, 1 << data.config.cap_height))


# ---------------------------------------------------------------------------
# Witness setters (mirror targets.rs:896-897's set_proof_with_pis_target)
# ---------------------------------------------------------------------------


def set_proof_with_pis_target(w, pt: ProofWithPisTarget, proof):
    for t, v in zip(pt.public_inputs, proof.public_inputs):
        w.set(t, int(v))
    for cap_t, cap_v in (
        (pt.wires_cap, proof.wires_cap),
        (pt.zs_cap, proof.zs_cap),
        (pt.quotient_cap, proof.quotient_cap),
    ):
        for d_t, d_v in zip(cap_t, cap_v):
            for t, v in zip(d_t, d_v):
                w.set(t, int(v))
    for key, rows in proof.openings.values.items():
        for et, row in zip(pt.openings[key], rows):
            gx.set_ext(w, et, (int(row[0]), int(row[1])))
    fp = proof.fri_proof
    for cap_t, cap_v in zip(pt.layer_caps, fp.layer_caps):
        for d_t, d_v in zip(cap_t, cap_v):
            for t, v in zip(d_t, d_v):
                w.set(t, int(v))
    for et, coeff in zip(pt.final_poly, fp.final_poly):
        gx.set_ext(w, et, (int(coeff[0]), int(coeff[1])))
    w.set(pt.pow_witness, int(fp.pow_witness))
    for qt, qp in zip(pt.queries, fp.query_proofs):
        for tag in ("P", "W", "Z", "Q"):
            for t, v in zip(qt.batch_leaves[tag], qp.batch_leaves[tag]):
                w.set(t, int(v))
            for d_t, d_v in zip(qt.batch_paths[tag], qp.batch_paths[tag]):
                for t, v in zip(d_t, d_v):
                    w.set(t, int(v))
        for l_t, l_v in zip(qt.layer_leaves, qp.layer_leaves):
            for t, v in zip(l_t, l_v):
                w.set(t, int(v))
        for p_t, p_v in zip(qt.layer_paths, qp.layer_paths):
            for d_t, d_v in zip(p_t, p_v):
                for t, v in zip(d_t, d_v):
                    w.set(t, int(v))


def set_verifier_data_target(w, vd: VerifierDataTarget, vk):
    for d_t, d_v in zip(vd.pre_cap, vk.pre_cap):
        for t, v in zip(d_t, d_v):
            w.set(t, int(v))


# ---------------------------------------------------------------------------
# In-circuit challenger (mirrors prover/transcript.py exactly)
# ---------------------------------------------------------------------------


class RecursiveChallenger:
    def __init__(self, b: CircuitBuilder):
        self.b = b
        self.state = [b.zero()] * pos.WIDTH
        self.input_buffer: list[Target] = []
        self.output_buffer: list[Target] = []

    def observe(self, t: Target):
        self.output_buffer.clear()
        self.input_buffer.append(t)

    def observe_many(self, ts):
        for t in ts:
            self.observe(t)

    def observe_cap(self, cap):
        for d in cap:
            self.observe_many(d)

    def observe_ext(self, e: ExtTarget):
        self.observe(e.re)
        self.observe(e.im)

    def _duplex(self):
        if self.input_buffer:
            for start in range(0, len(self.input_buffer), pos.SPONGE_RATE):
                chunk = self.input_buffer[start : start + pos.SPONGE_RATE]
                self.state = list(chunk) + self.state[len(chunk) :]
                self.state = add_poseidon_permutations(self.b, [self.state])[0]
            self.input_buffer.clear()
        else:
            self.state = add_poseidon_permutations(self.b, [self.state])[0]
        self.output_buffer = list(self.state[: pos.SPONGE_RATE])

    def challenge(self) -> Target:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop(0)

    def challenge_ext(self) -> ExtTarget:
        a = self.challenge()
        bb = self.challenge()
        return ExtTarget(a, bb)


# ---------------------------------------------------------------------------
# The circuit-world algebra (third leg of the dual-algebra design)
# ---------------------------------------------------------------------------


class CircuitExtAlgebra:
    """Gate constraints evaluated over ExtTargets inside the circuit."""

    def __init__(self, b: CircuitBuilder):
        self.b = b

    def constant(self, c: int):
        return gx.ext_constant(self.b, (c % P, 0))

    def add(self, x, y):
        return gx.ext_add(self.b, x, y)

    def sub(self, x, y):
        return gx.ext_sub(self.b, x, y)

    def mul(self, x, y):
        return gx.ext_mul(self.b, x, y)

    def zero(self):
        return gx.ext_zero(self.b)

    def one(self):
        return gx.ext_one(self.b)

    def add_many(self, xs):
        acc = self.zero()
        for x in xs:
            acc = self.add(acc, x)
        return acc

    def mul_small(self, c: int, x):
        return gx.ext_mul_const(self.b, x, (c % P, 0))


# ---------------------------------------------------------------------------
# Merkle path check (order selected by index bits)
# ---------------------------------------------------------------------------


def _hash_leaf(b: CircuitBuilder, leaf_targets: list) -> list:
    from .gates_poseidon import hash_no_pad_circuit

    return hash_no_pad_circuit(b, leaf_targets)


def _verify_merkle_circuit(b, leaf_digest, idx_bits, path, cap_digests):
    """Walk the path with left/right order chosen by idx bits, then
    compare against the cap digest selected by the remaining bits."""
    from .gates_poseidon import compress_circuit

    digest = leaf_digest
    for level, sib in enumerate(path):
        bit = idx_bits[level]
        left = [b.select(bit, s, d) for s, d in zip(sib, digest)]
        right = [b.select(bit, d, s) for d, s in zip(digest, sib)]
        digest = compress_circuit(b, left, right)
    cap_bits = idx_bits[len(path) :]
    expect = gx.random_access_digest(b, cap_bits, cap_digests)
    for d, e in zip(digest, expect):
        b.assert_equal(d, e)


# ---------------------------------------------------------------------------
# verify_proof — the gadget
# ---------------------------------------------------------------------------


def verify_proof_circuit(b: CircuitBuilder, pt: ProofWithPisTarget,
                         vd: VerifierDataTarget, data):
    """In-circuit mirror of prover/verify.py for an inner circuit
    described by `data` (its CircuitData: gate set, config, public
    input rows — the preprocessed commitment comes in via vd)."""
    cfg = data.config
    n = data.n
    rate = cfg.rate_bits
    n_lde = n << rate
    log_lde = data.log_n + rate
    m = cfg.num_permutation_chunks
    cs = cfg.permutation_chunk_size
    num_sel = len(data.gate_names)
    num_con = cfg.num_constants
    counts = batch_counts(data)
    specs = opening_point_specs(data)
    num_layers, final_len = fri_shape(data)
    A = CircuitExtAlgebra(b)

    # ---- 1. replay the transcript -------------------------------------
    ch = RecursiveChallenger(b)
    ch.observe_cap(vd.pre_cap)
    ch.observe_many(pt.public_inputs)
    ch.observe_cap(pt.wires_cap)
    betas, gammas = [], []
    for _ in range(cfg.num_challenges):
        betas.append(ch.challenge())
        gammas.append(ch.challenge())
    ch.observe_cap(pt.zs_cap)
    alphas = [ch.challenge() for _ in range(cfg.num_challenges)]
    ch.observe_cap(pt.quotient_cap)
    zeta = ch.challenge_ext()
    for tag, off in specs:
        for et in pt.openings[(tag, off)]:
            ch.observe(et.re)
            ch.observe(et.im)
    fri_alpha = ch.challenge_ext()

    # ---- 2. constraint identity at zeta --------------------------------
    omega = gl.primitive_root_of_unity(data.log_n)
    p_open = pt.openings[("P", 0)]
    z_open = pt.openings[("Z", 0)]
    z_next_open = pt.openings[("Z", 1)]
    q_open = pt.openings[("Q", 0)]

    def wires(col, offset=0):
        return pt.openings[("W", offset)][col]

    def consts(i):
        return p_open[num_sel + i]

    def sel(i):
        return p_open[i]

    def sigma_c(c):
        return p_open[num_sel + num_con + c]

    max_con = max((g.num_constraints for g in data.gates), default=0)
    gate_slots = [A.zero()] * max_con
    for gi, g in enumerate(data.gates):
        if g.num_constraints == 0:
            continue
        cons = g.eval(A, wires, consts)
        s = sel(gi)
        for k, cval in enumerate(cons):
            gate_slots[k] = A.add(gate_slots[k], A.mul(s, cval))

    # zeta^n by repeated squaring; Z_H = zeta^n - 1
    zeta_pows = gx.ext_pow2_chain(b, zeta, data.log_n)
    zeta_n = zeta_pows[-1]
    one_e = A.one()
    zh = A.sub(zeta_n, one_e)
    n_inv = gl.h_inv(n)
    l0 = A.mul(zh, gx.ext_mul_const(
        b, gx.ext_inverse(b, A.sub(zeta, one_e)), (n_inv, 0)))

    pi_terms = []
    for (r, c), piv in zip(data.public_input_targets, pt.public_inputs):
        wr = pow(omega, r, P)
        lr = A.mul(zh, gx.ext_mul_const(
            b, gx.ext_inverse(b, A.sub(zeta, A.constant(wr))), ((wr * n_inv) % P, 0)))
        pi_terms.append(A.mul(lr, A.sub(wires(c), gx.ext_from_base(b, piv))))

    for j in range(cfg.num_challenges):
        beta_e = gx.ext_from_base(b, betas[j])
        gamma_e = gx.ext_from_base(b, gammas[j])
        z_j = z_open[j * m]
        z_next = z_next_open[j * m]
        partials = [z_open[j * m + 1 + k] for k in range(m - 1)]
        chain = [z_j] + partials + [z_next]
        terms = [A.mul(l0, A.sub(z_j, one_e))]
        for k in range(m):
            acc_n = one_e
            acc_d = one_e
            for c in range(k * cs, (k + 1) * cs):
                wv = wires(c)
                idv = gx.ext_mul_const(b, zeta, (int(data.k_shifts[c]), 0))
                nterm = A.add(A.add(wv, A.mul(beta_e, idv)), gamma_e)
                dterm = A.add(A.add(wv, A.mul(beta_e, sigma_c(c))), gamma_e)
                acc_n = A.mul(acc_n, nterm)
                acc_d = A.mul(acc_d, dterm)
            terms.append(A.sub(A.mul(chain[k + 1], acc_d), A.mul(chain[k], acc_n)))
        terms.extend(pi_terms)
        terms.extend(gate_slots)
        combined = A.zero()
        alpha_e = gx.ext_from_base(b, alphas[j])
        for t in reversed(terms):
            combined = A.add(A.mul(combined, alpha_e), t)
        tq = A.zero()
        zpow = one_e
        for k in range(1 << rate):
            tq = A.add(tq, A.mul(zpow, q_open[j * (1 << rate) + k]))
            zpow = A.mul(zpow, zeta_n)
        gx.ext_assert_equal(b, combined, A.mul(zh, tq))

    # ---- 3. FRI ---------------------------------------------------------
    fri_betas = []
    for cap in pt.layer_caps:
        ch.observe_cap(cap)
        fri_betas.append(ch.challenge_ext())
    for coeff in pt.final_poly:
        ch.observe(coeff.re)
        ch.observe(coeff.im)
    pow_c = ch.challenge()
    # PoW: digest = hash([c, w]); digest[0] < 2^(64 - pow_bits)
    pow_digest = _hash_leaf(b, [pow_c, pt.pow_witness])
    d_bits = gx.split_64(b, pow_digest[0])
    zero = b.zero()
    for bit in d_bits[64 - cfg.fri.proof_of_work_bits :]:
        b.connect(bit, zero)
    ch.observe(pt.pow_witness)

    # alpha powers (sequential ext muls; same order as verify.py)
    tags = ["P", "W", "Z", "Q"]
    offsets_g = {}
    acc = 0
    for t in tags:
        offsets_g[t] = acc
        acc += counts[t]
    total_polys = acc
    apow = [one_e]
    for _ in range(total_polys + len(specs) - 1):
        apow.append(A.mul(apow[-1], fri_alpha))

    # y_j per spec and z_j points
    y_points = []
    for jj, (tag, off) in enumerate(specs):
        wo = pow(omega, off % n, P)
        z_pt = gx.ext_mul_const(b, zeta, (wo, 0))
        y_j = A.zero()
        for i in range(counts[tag]):
            y_j = A.add(y_j, A.mul(apow[offsets_g[tag] + i], pt.openings[(tag, off)][i]))
        y_points.append((tag, z_pt, y_j, apow[total_polys + jj]))

    w_lde = gl.primitive_root_of_unity(log_lde)
    caps = {"P": vd.pre_cap, "W": pt.wires_cap, "Z": pt.zs_cap, "Q": pt.quotient_cap}
    inv2 = gl.h_inv(2)

    for qi in range(cfg.fri.num_query_rounds):
        qp = pt.queries[qi]
        idx_c = ch.challenge()
        bits64 = gx.split_64(b, idx_c)
        idx_bits = bits64[:log_lde]  # idx = challenge % n_lde

        # batch-tree membership at idx
        for tag in tags:
            leaf_digest = _hash_leaf(b, qp.batch_leaves[tag])
            _verify_merkle_circuit(b, leaf_digest, idx_bits, qp.batch_paths[tag], caps[tag])

        # x = SHIFT * w^idx  (and its inverse chain base for folds)
        w_pows = [pow(w_lde, 1 << i, P) for i in range(log_lde)]
        x_t = b.constant(SHIFT)
        for i in range(log_lde):
            factor = b.select(idx_bits[i], b.constant(w_pows[i]), b.one())
            x_t = b.mul(x_t, factor)
        x_e = gx.ext_from_base(b, x_t)

        # G(x) from the opened leaves
        g_val = A.zero()
        for (tag, z_pt, y_j, beta_j) in y_points:
            bsum = A.zero()
            for i in range(counts[tag]):
                term = gx.ext_mul_base(b, apow[offsets_g[tag] + i], qp.batch_leaves[tag][i])
                bsum = A.add(bsum, term)
            numer = A.sub(bsum, y_j)
            denom = A.sub(x_e, z_pt)
            g_val = A.add(g_val, A.mul(beta_j, A.mul(numer, gx.ext_inverse(b, denom))))

        # layer folds
        expected = g_val
        cur_bits = idx_bits
        shift_l = SHIFT
        w_cur = w_lde
        size = n_lde
        for l in range(num_layers):
            h = size // 2
            log_h = h.bit_length() - 1
            jpos_bits = cur_bits[:log_h]
            slot_bit = cur_bits[log_h]  # cur >= h ?
            leaf = qp.layer_leaves[l]
            e0 = ExtTarget(leaf[0], leaf[1])
            e1 = ExtTarget(leaf[2], leaf[3])
            got = gx.ext_select(b, slot_bit, e1, e0)
            gx.ext_assert_equal(b, got, expected)
            leaf_digest = _hash_leaf(b, leaf)
            _verify_merkle_circuit(b, leaf_digest, jpos_bits, qp.layer_paths[l],
                                   pt.layer_caps[l])
            # x_j^{-1} = shift^{-1} * (w^{-1})^{jpos}
            winv = gl.h_inv(w_cur)
            winv_pows = [pow(winv, 1 << i, P) for i in range(log_h)]
            xinv_t = b.constant(gl.h_inv(shift_l))
            for i in range(log_h):
                factor = b.select(jpos_bits[i], b.constant(winv_pows[i]), b.one())
                xinv_t = b.mul(xinv_t, factor)
            t1 = gx.ext_mul_const(b, A.add(e0, e1), (inv2, 0))
            diff = gx.ext_mul_base(b, A.sub(e0, e1), xinv_t)
            t2 = A.mul(fri_betas[l], gx.ext_mul_const(b, diff, (inv2, 0)))
            expected = A.add(t1, t2)
            cur_bits = jpos_bits
            size = h
            shift_l = (shift_l * shift_l) % P
            w_cur = (w_cur * w_cur) % P

        # final polynomial evaluated at the folded point
        log_fin = size.bit_length() - 1
        wfin_pows = [pow(w_cur, 1 << i, P) for i in range(log_fin)]
        xfin_t = b.constant(shift_l)
        for i in range(log_fin):
            factor = b.select(cur_bits[i], b.constant(wfin_pows[i]), b.one())
            xfin_t = b.mul(xfin_t, factor)
        val = A.zero()
        for coeff in reversed(pt.final_poly):
            val = A.add(gx.ext_mul_base(b, val, xfin_t), coeff)
        gx.ext_assert_equal(b, val, expected)
