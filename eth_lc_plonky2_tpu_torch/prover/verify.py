"""Proof verification (host-side scalar GF(p^2) arithmetic).

Copy of ``eth_lc_plonky2_tpu/prover/verify.py`` on the port's modules (the
counterpart of plonky2's `data.verify(proof)`): re-derives every
Fiat-Shamir challenge from the transcript, checks the constraint
identity at zeta against the quotient openings, checks the FRI
low-degree proof (paths, folds, final polynomial, PoW).  Everything runs
on the host: Python integers, numpy, and the plain sponge on CPU tensors
for the batched Merkle checks.

Raises VerificationError on any failure; returns None on success.
"""

from __future__ import annotations

import numpy as np

from ..ops import goldilocks as gl
from ..ops import goldilocks_ext as ge
from ..circuit.algebra import HostExtAlgebra
from ..circuit.builder import CircuitData
from . import fri as frim
from .merkle import verify_merkle_batch
from .prove import Proof, VerifierKey, opening_point_specs
from .transcript import Challenger

P = gl.P
SHIFT = gl.MULTIPLICATIVE_GENERATOR


class VerificationError(Exception):
    pass


def _chk(cond: bool, msg: str):
    if not cond:
        raise VerificationError(msg)


def verify(data: CircuitData, vk: VerifierKey, proof: Proof):
    cfg = data.config
    n = data.n
    rate = cfg.rate_bits
    n_lde = n << rate
    m = cfg.num_permutation_chunks
    cs = cfg.permutation_chunk_size
    num_sel = len(data.gate_names)
    num_con = cfg.num_constants
    point_specs = opening_point_specs(data)
    openings = proof.openings.values
    _chk(len(proof.public_inputs) == len(data.public_input_targets), "bad public input count")

    # ------------------------------------------------------------------
    # 1. Re-derive challenges
    # ------------------------------------------------------------------
    ch = Challenger()
    ch.observe_cap(vk.pre_cap)
    ch.observe_many([int(v) for v in proof.public_inputs])
    ch.observe_cap(proof.wires_cap)
    betas, gammas = [], []
    for _ in range(cfg.num_challenges):
        betas.append(ch.challenge())
        gammas.append(ch.challenge())
    ch.observe_cap(proof.zs_cap)
    alphas = [ch.challenge() for _ in range(cfg.num_challenges)]
    ch.observe_cap(proof.quotient_cap)
    zeta = ch.challenge_ext()
    for tag, offset in point_specs:
        for row in openings[(tag, offset)]:
            ch.observe(int(row[0]))
            ch.observe(int(row[1]))
    fri_alpha = ch.challenge_ext()

    # ------------------------------------------------------------------
    # 2. Constraint identity at zeta
    # ------------------------------------------------------------------
    A = HostExtAlgebra()
    omega = gl.primitive_root_of_unity(data.log_n)
    p_open = openings[("P", 0)]
    z_open = openings[("Z", 0)]
    z_next_open = openings[("Z", 1)]
    q_open = openings[("Q", 0)]

    def wires(col, offset=0):
        row = openings[("W", offset)][col]
        return (int(row[0]), int(row[1]))

    def consts(i):
        row = p_open[num_sel + i]
        return (int(row[0]), int(row[1]))

    def sel(i):
        return (int(p_open[i][0]), int(p_open[i][1]))

    def sigma_c(c):
        row = p_open[num_sel + num_con + c]
        return (int(row[0]), int(row[1]))

    # gate constraint slots
    max_con = max((g.num_constraints for g in data.gates), default=0)
    gate_slots = [A.zero()] * max_con
    for gi, g in enumerate(data.gates):
        if g.num_constraints == 0:
            continue
        cons = g.eval(A, wires, consts)
        s = sel(gi)
        for k, cval in enumerate(cons):
            gate_slots[k] = A.add(gate_slots[k], A.mul(s, cval))

    zeta_n = ge.h_pow(zeta, n)
    zh = ge.h_sub(zeta_n, (1, 0))
    _chk(zh != (0, 0), "zeta landed in H (negligible probability)")
    n_inv = gl.h_inv(n)
    l0 = ge.h_mul(zh, ge.h_mul(ge.h_inv(ge.h_sub(zeta, (1, 0))), (n_inv, 0)))

    pi_terms = []
    for (r, c), piv in zip(data.public_input_targets, proof.public_inputs):
        wr = pow(omega, r, P)
        lr = ge.h_mul(zh, ge.h_mul(ge.h_inv(ge.h_sub(zeta, (wr, 0))), ((wr * n_inv) % P, 0)))
        pi_terms.append(ge.h_mul(lr, ge.h_sub(wires(c), (int(piv) % P, 0))))

    for j in range(cfg.num_challenges):
        z_j = (int(z_open[j * m][0]), int(z_open[j * m][1]))
        z_next = (int(z_next_open[j * m][0]), int(z_next_open[j * m][1]))
        partials = [
            (int(z_open[j * m + 1 + k][0]), int(z_open[j * m + 1 + k][1])) for k in range(m - 1)
        ]
        chain = [z_j] + partials + [z_next]
        terms = [ge.h_mul(l0, ge.h_sub(z_j, (1, 0)))]
        for k in range(m):
            acc_n = (1, 0)
            acc_d = (1, 0)
            for c in range(k * cs, (k + 1) * cs):
                wv = wires(c)
                idv = ge.h_mul((int(data.k_shifts[c]), 0), zeta)
                nterm = ge.h_add(ge.h_add(wv, ge.h_mul((betas[j], 0), idv)), (gammas[j], 0))
                dterm = ge.h_add(ge.h_add(wv, ge.h_mul((betas[j], 0), sigma_c(c))), (gammas[j], 0))
                acc_n = ge.h_mul(acc_n, nterm)
                acc_d = ge.h_mul(acc_d, dterm)
            terms.append(ge.h_sub(ge.h_mul(chain[k + 1], acc_d), ge.h_mul(chain[k], acc_n)))
        terms.extend(pi_terms)
        terms.extend(gate_slots)
        # Horner with alpha_j
        combined = (0, 0)
        for t in reversed(terms):
            combined = ge.h_add(ge.h_mul(combined, (alphas[j], 0)), t)
        # t_j(zeta) recombined from chunks
        tq = (0, 0)
        zpow = (1, 0)
        for k in range(1 << rate):
            row = q_open[j * (1 << rate) + k]
            tq = ge.h_add(tq, ge.h_mul(zpow, (int(row[0]), int(row[1]))))
            zpow = ge.h_mul(zpow, zeta_n)
        _chk(combined == ge.h_mul(zh, tq), f"constraint identity failed at zeta (challenge set {j})")

    # ------------------------------------------------------------------
    # 3. FRI
    # ------------------------------------------------------------------
    fp = proof.fri_proof
    fri_cfg = cfg.fri
    # commit-phase challenges
    fri_betas = []
    for cap in fp.layer_caps:
        ch.observe_cap(cap)
        fri_betas.append(ch.challenge_ext())
    for coeff in fp.final_poly:
        ch.observe(int(coeff[0]))
        ch.observe(int(coeff[1]))
    pow_c = ch.challenge()
    _chk(frim.verify_pow(pow_c, fp.pow_witness, fri_cfg.proof_of_work_bits), "proof of work failed")
    ch.observe(fp.pow_witness)
    indices = [ch.challenge() % n_lde for _ in range(fri_cfg.num_query_rounds)]
    _chk(indices == list(fp.query_indices), "query indices mismatch")

    # expected final layer size
    stop_size = 1 << (fri_cfg.final_poly_bits + fri_cfg.rate_bits)
    num_layers = 0
    sz = n_lde
    while sz > stop_size:
        num_layers += 1
        sz //= 2
    _chk(len(fp.layer_caps) == num_layers, "wrong number of FRI layers")
    _chk(len(fp.final_poly) == (sz >> fri_cfg.rate_bits), "wrong final poly length")

    # global alpha powers / batch combination structure (matches prover)
    tags = ["P", "W", "Z", "Q"]
    counts = {
        "P": num_sel + num_con + cfg.num_routed_wires,
        "W": cfg.num_wires,
        "Z": cfg.num_challenges * m,
        "Q": cfg.num_challenges * (1 << rate),
    }
    offsets_g = {}
    acc = 0
    for t in tags:
        offsets_g[t] = acc
        acc += counts[t]
    total_polys = acc
    apow = [(1, 0)]
    for _ in range(total_polys + len(point_specs)):
        apow.append(ge.h_mul(apow[-1], fri_alpha))
    # y_j per point
    y_points = []
    for j, (tag, off) in enumerate(point_specs):
        z_pt = ge.h_mul(zeta, (pow(omega, off % n, P), 0))
        y_j = (0, 0)
        vals = openings[(tag, off)]
        _chk(len(vals) == counts[tag], f"opening count mismatch for {tag}")
        for i in range(counts[tag]):
            y_j = ge.h_add(y_j, ge.h_mul(apow[offsets_g[tag] + i], (int(vals[i, 0]), int(vals[i, 1]))))
        y_points.append((tag, z_pt, y_j, apow[total_polys + j]))

    w_lde = gl.primitive_root_of_unity(data.log_n + rate)
    caps = {"P": vk.pre_cap, "W": proof.wires_cap, "Z": proof.zs_cap, "Q": proof.quotient_cap}

    # All Merkle path checks batched per tree (lock-step vectorized
    # Poseidon, prover/merkle.py): semantically the same checks the
    # per-query loop below used to make one path at a time.
    for tag in tags:
        for qp in fp.query_proofs:
            _chk(len(qp.batch_leaves[tag]) == counts[tag], f"leaf width mismatch {tag}")
        rows = np.asarray([qp.batch_leaves[tag] for qp in fp.query_proofs], dtype=np.uint64)
        pths = np.asarray([qp.batch_paths[tag] for qp in fp.query_proofs], dtype=np.uint64)
        _chk(
            verify_merkle_batch(rows, indices, pths, caps[tag]),
            f"merkle path failed for batch {tag}",
        )
    for l in range(num_layers):
        h = n_lde >> (l + 1)
        jpos_l = [i % h for i in indices]
        leaves_l = np.asarray([qp.layer_leaves[l] for qp in fp.query_proofs], dtype=np.uint64)
        paths_l = np.asarray([qp.layer_paths[l] for qp in fp.query_proofs], dtype=np.uint64)
        _chk(
            verify_merkle_batch(leaves_l, jpos_l, paths_l, fp.layer_caps[l]),
            f"FRI layer {l} merkle path failed",
        )

    for qi, idx in enumerate(indices):
        qp = fp.query_proofs[qi]
        # G(x_idx) from leaves
        x = (SHIFT * pow(w_lde, idx, P)) % P
        g_val = (0, 0)
        for tag, z_pt, y_j, beta_j in y_points:
            b = (0, 0)
            for i in range(counts[tag]):
                b = ge.h_add(b, ge.h_mul(apow[offsets_g[tag] + i], (int(qp.batch_leaves[tag][i]), 0)))
            numer = ge.h_sub(b, y_j)
            denom = ge.h_sub((x, 0), z_pt)
            g_val = ge.h_add(g_val, ge.h_mul(beta_j, ge.h_mul(numer, ge.h_inv(denom))))
        # layer folds
        cur = idx
        size = n_lde
        shift = SHIFT
        expected = g_val
        w_cur = w_lde
        for l in range(num_layers):
            h = size // 2
            jpos = cur % h
            leaf = [int(v) for v in qp.layer_leaves[l]]
            slot = 0 if cur < h else 1
            _chk(
                (leaf[2 * slot], leaf[2 * slot + 1]) == expected,
                f"FRI layer {l} value mismatch at query {qi}",
            )
            e0 = (leaf[0], leaf[1])
            e1 = (leaf[2], leaf[3])
            x_j = (shift * pow(w_cur, jpos, P)) % P
            inv2 = gl.h_inv(2)
            t1 = ge.h_mul(ge.h_add(e0, e1), (inv2, 0))
            t2 = ge.h_mul(
                fri_betas[l],
                ge.h_mul(ge.h_sub(e0, e1), ((inv2 * gl.h_inv(x_j)) % P, 0)),
            )
            expected = ge.h_add(t1, t2)
            cur = jpos
            size = h
            shift = (shift * shift) % P
            w_cur = (w_cur * w_cur) % P
        # final polynomial evaluation at the folded point
        x_fin = (shift * pow(w_cur, cur, P)) % P
        val = (0, 0)
        for coeff in reversed(fp.final_poly):
            val = ge.h_add(ge.h_mul(val, (x_fin, 0)), (int(coeff[0]), int(coeff[1])))
        _chk(val == expected, f"final polynomial mismatch at query {qi}")
