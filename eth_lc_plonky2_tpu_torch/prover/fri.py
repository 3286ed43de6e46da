"""Batched FRI: commit phase, proof-of-work grind, query proofs.

Port of ``eth_lc_plonky2_tpu/prover/fri.py``.  Radix-2 folding over the
extension field; the combined opening polynomial

    G(x) = sum_j beta_j * (B_j(x) - y_j) / (x - z_j)

is evaluated on the whole LDE coset (the per-point denominators share ONE
Fermat inversion of the (num_specs, n_lde) norm matrix), committed in
pair-leaves [G(j), G(j+N/2)], then folded with per-layer transcript
challenges.  On the card G is one launch of csrc/field.cu ``fri_g_kernel``
and each fold one of ``fri_fold_kernel``; a CPU tensor runs the eager
chains ``g_plain`` and ``fold_plain``.

Device discipline: fold layers and their Merkle trees stay on the device;
the host sees caps, the final polynomial, the PoW result, and one batched
gather of all query rows and paths.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import goldilocks_ext as ge
from ..ops import host_field as hf
from ..ops import kernels
from ..ops import ntt as nttm
from ..ops import poseidon as pos
from .merkle import MerkleTree, _levels_core, gather_rows_and_paths
from .profiler import Profiler
from .transcript import Challenger

P = gl.P
SHIFT = gl.MULTIPLICATIVE_GENERATOR
TAGS = ("P", "W", "Z", "Q")

_SUM_CHUNK = 16  # rows of an LDE per weighted-sum pass (bounds the product)
INV2 = gl.h_inv(2)


@dataclasses.dataclass
class FriQueryProof:
    batch_leaves: dict  # tag -> (num_polys,) u64 leaf row
    batch_paths: dict  # tag -> list of (4,) digests
    layer_leaves: list  # per layer: (4,) u64 [re0, im0, re1, im1]
    layer_paths: list  # per layer: list of (4,) digests


@dataclasses.dataclass
class FriProof:
    layer_caps: list  # (2^cap,4) u64 per fold layer (incl. layer 0 = G itself)
    final_poly: np.ndarray  # (final_len, 2) u64 ext coefficients
    pow_witness: int
    query_indices: list
    query_proofs: list


_ext_mul = ge.mul  # ext tensor * ext tensor (each a pair of field tensors, broadcasting)


def _lde_x(log_n: int, rate_bits: int) -> np.ndarray:
    n_lde = 1 << (log_n + rate_bits)
    w = gl.primitive_root_of_unity(log_n + rate_bits)
    return hf.mul(np.uint64(SHIFT), hf.powers(w, n_lde))


def _tag_offsets(counts: dict) -> tuple[dict, int]:
    offsets, acc = {}, 0
    for t in TAGS:
        offsets[t] = acc
        acc += counts[t]
    return offsets, acc


def _weighted_sum(lde: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """sum_i a[i] * lde[i] over the poly axis, _SUM_CHUNK rows at a time, so
    the full (num, n_lde) product (3 GB for the wires batch at 2^21) is never
    made."""
    acc = None
    for r0 in range(0, lde.shape[0], _SUM_CHUNK):
        rows = slice(r0, r0 + _SUM_CHUNK)
        part = nttm.sum_field(gl.mul(lde[rows], a[rows, None]), axis=0)
        acc = part if acc is None else gl.add(acc, part)
    return acc


def g_plain(ldes, apow_f, y_f, z_f, x_dev, counts: dict, spec_tags: tuple):
    """G(x) over the LDE coset ``x_dev`` as eager field ops: the plain version
    of ``kernels.fri_g`` (csrc/field.cu ``fri_g_kernel``), the CPU path.

    apow_f: (re, im) field tensors of shape (total + num_specs,); y_f and z_f:
    (re, im) of shape (num_specs,).  All per-spec work is batched over a
    (num_specs, n_lde) axis."""
    offsets_g, total = _tag_offsets(counts)
    apre, apim = apow_f
    b_tag = {}
    for ti, t in enumerate(TAGS):
        c0 = offsets_g[t]
        c1 = c0 + counts[t]
        b_tag[t] = (_weighted_sum(ldes[ti], apre[c0:c1]), _weighted_sum(ldes[ti], apim[c0:c1]))
    yre, yim = y_f
    zre, zim = z_f
    # denominators (x - z_j), batched; ONE Fermat inversion of the
    # (S, n_lde) norm matrix
    dre = gl.sub(x_dev[None, :], zre[:, None])
    dim = gl.neg(zim)  # (S,): the imaginary part does not depend on x
    norms = gl.sub(gl.square(dre), gl.mul_small(gl.square(dim), ge.W)[:, None])
    ninv = gl.inv(norms)
    inv_denom = (gl.mul(dre, ninv), gl.mul(ninv, gl.neg(dim)[:, None]))
    del norms, ninv
    b_re = torch.stack([b_tag[t][0] for t in spec_tags])
    b_im = torch.stack([b_tag[t][1] for t in spec_tags])
    numer = (gl.sub(b_re, yre[:, None]), gl.sub(b_im, yim[:, None]))
    term = _ext_mul(numer, inv_denom)
    del numer, inv_denom, b_re, b_im
    term = _ext_mul(term, (apre[total:, None], apim[total:, None]))
    return nttm.sum_field(term[0], axis=0), nttm.sum_field(term[1], axis=0)


def make_g_kernel(pd, counts: dict, num_specs: int, spec_tags: tuple, points=None):
    """G(x) over the LDE domain, or over its points [lo, lo + L) for
    ``points`` = (lo, L) (a shard's); all proof scalars are arguments: one
    launch of ``fri_g_kernel`` for CUDA tensors, ``g_plain`` for CPU
    tensors."""
    data = pd.data
    cfg = data.config
    x_host = _lde_x(data.log_n, cfg.rate_bits)
    if points is not None:
        x_host = x_host[points[0] : points[0] + points[1]]
    x_dev = gl.from_u64(x_host, pd.device)
    spec_batches = tuple(TAGS.index(t) for t in spec_tags)

    def kernel(ldes, apow_f, y_f, z_f):
        if kernels.on_card(x_dev):
            return kernels.fri_g(ldes, apow_f, y_f, z_f, x_dev, spec_batches)
        return g_plain(ldes, apow_f, y_f, z_f, x_dev, counts, spec_tags)

    return kernel


def _fold_core(re, im, hx, half, beta_f):
    """One radix-2 fold: inputs of length 2h -> outputs of length h.

    hx: (h,) the half inverse points; half: 1/2, shape () or (h,); beta_f: a
    pair of shape-() field tensors.
    """
    h = re.shape[0] // 2
    re0, re1, im0, im1 = re[:h], re[h:], im[:h], im[h:]
    term1 = (gl.mul(gl.add(re0, re1), half), gl.mul(gl.add(im0, im1), half))
    dd = (gl.mul(gl.sub(re0, re1), hx), gl.mul(gl.sub(im0, im1), hx))
    term2 = _ext_mul(dd, beta_f)
    return (gl.add(term1[0], term2[0]), gl.add(term1[1], term2[1]))


def fold_plain(re, im, w_inv, scale: int, beta_f):
    """One fold with the half inverse points w_inv * scale made first, as
    eager field ops: the plain version of ``kernels.fri_fold`` (csrc/field.cu
    ``fri_fold_kernel``), the CPU path."""
    half_xinv = gl.mul(w_inv, gl.full((), scale, re.device))
    return _fold_core(re, im, half_xinv, gl.full((), INV2, re.device), beta_f)


def fold_layer(re, im, w_inv, scale: int, beta_f):
    """One radix-2 fold of the ext layer (re, im) of 2h words: w_inv is the
    (h,) table of w^-i, scale = 1 / (2 shift) and beta_f a pair of shape-()
    field tensors.  One launch of ``fri_fold_kernel`` for CUDA tensors,
    ``fold_plain`` for CPU tensors."""
    if kernels.on_card(re):
        return kernels.fri_fold(re, im, w_inv, scale, INV2, beta_f)
    return fold_plain(re, im, w_inv, scale, beta_f)


def _layer_tree_core(g_re, g_im, cap_height: int):
    """Commit an ext layer with pair leaves [re_j, im_j, re_j', im_j']."""
    h = g_re.shape[0] // 2
    leaves = torch.stack([g_re[:h], g_im[:h], g_re[h:], g_im[h:]], dim=1)  # (h, 4)
    return leaves, _levels_core(pos.hash_no_pad(leaves), cap_height)


def _layer_tree(evals, cap_height: int) -> MerkleTree:
    leaves, levels = _layer_tree_core(evals[0], evals[1], cap_height)
    return MerkleTree(leaves=leaves, levels=levels, cap_height=cap_height, leaf_axis=0)


def layer_cap_height(num_leaves: int) -> int:
    return min(4, num_leaves.bit_length() - 1)


def fri_prove(pd, batches, openings, point_specs, zeta, fri_alpha, ch: Challenger,
              prof=None, phases=None) -> FriProof:
    """FRI's commit phase, grind and queries.  ``phases`` (a ``prove.Phases``;
    one device's by default) computes G and answers the batches' queries;
    the layers, their trees and the rest run where G lies."""
    from .prove import Phases, scalar_f, scalars_f  # local import to avoid a cycle

    if prof is None:
        prof = Profiler(enabled=False)
    if phases is None:
        phases = Phases(pd)
    prof.phase("fri_g_setup")

    data = pd.data
    cfg = data.config
    fri_cfg = cfg.fri
    dev = pd.device
    n_lde = data.n << cfg.rate_bits

    # --- G evaluation (proof scalars as arguments) ---
    counts = {t: batches[t].lde.shape[0] for t in TAGS}
    offsets_g, total = _tag_offsets(counts)
    num_specs = len(point_specs)
    spec_tags = tuple(tag for tag, _ in point_specs)
    # alpha powers (host)
    apow = [(1, 0)]
    for _ in range(total + num_specs - 1):
        apow.append(ge.h_mul(apow[-1], fri_alpha))
    # y_j, z_j per spec (host)
    omega = gl.primitive_root_of_unity(data.log_n)
    ys = []
    zs = []
    for tag, off in point_specs:
        z_j = ge.h_mul(zeta, (pow(omega, off % data.n, P), 0))
        y_j = (0, 0)
        vals = openings[(tag, off)]
        for i in range(counts[tag]):
            y_j = ge.h_add(y_j, ge.h_mul(apow[offsets_g[tag] + i], (int(vals[i, 0]), int(vals[i, 1]))))
        ys.append(y_j)
        zs.append(z_j)
    apow_f = (scalars_f([a[0] for a in apow], dev), scalars_f([a[1] for a in apow], dev))
    y_f = (scalars_f([y[0] for y in ys], dev), scalars_f([y[1] for y in ys], dev))
    z_f = (scalars_f([z[0] for z in zs], dev), scalars_f([z[1] for z in zs], dev))
    prof.phase("fri_g_kernel")
    g = phases.fri_g(batches, counts, spec_tags, apow_f, y_f, z_f)

    # --- commit phase (device-resident trees; host sees only caps) ---
    prof.phase("fri_folds")
    trees = []
    evals = g
    size = n_lde
    shift = SHIFT
    stop_size = 1 << (fri_cfg.final_poly_bits + fri_cfg.rate_bits)
    while size > stop_size:
        tree = _layer_tree(evals, layer_cap_height(size // 2))
        trees.append(tree)
        with prof.span("device_read"):
            cap = tree.cap  # [device sync: cap transfer]
        ch.observe_cap(cap)
        beta = ch.challenge_ext()
        h = size // 2
        w = gl.primitive_root_of_unity(size.bit_length() - 1)
        # (1/2) * (shift * w^i)^-1 = w^-i * scale, from the table of w^-i
        # cached on the device
        scale = INV2 * gl.h_inv(shift) % P
        evals = fold_layer(evals[0], evals[1], nttm._powers_on(gl.h_inv(w), h, str(dev)), scale,
                           (scalar_f(beta[0], dev), scalar_f(beta[1], dev)))
        size = h
        shift = (shift * shift) % P
    # --- final polynomial ---
    prof.phase("fri_final_poly")
    final_len = size >> fri_cfg.rate_bits
    coeffs = nttm.coset_intt(torch.stack(evals), 0, shift)
    with prof.span("device_read"):
        coeffs = gl.to_u64(coeffs)  # [device sync]
    if coeffs[:, final_len:].any():
        raise AssertionError(
            "FRI final polynomial exceeds expected degree — constraint system bug")
    final_poly = np.stack([coeffs[0, :final_len], coeffs[1, :final_len]], axis=1)
    for coeff in final_poly:
        ch.observe(int(coeff[0]))
        ch.observe(int(coeff[1]))

    # --- proof of work ---
    prof.phase("fri_pow")
    pow_witness = grind(ch, fri_cfg.proof_of_work_bits, dev)
    ch.observe(pow_witness)

    # --- queries: batched device gathers, ONE transfer for everything ---
    prof.phase("fri_queries")
    num_q = fri_cfg.num_query_rounds
    indices = [ch.challenge() % n_lde for _ in range(num_q)]
    cur = torch.tensor(indices, dtype=torch.int64, device=dev)
    dev_batch = phases.batch_queries(batches, cur)
    dev_layers = []
    sz = n_lde
    for tree in trees:
        sz //= 2
        cur = cur % sz
        dev_layers.append(gather_rows_and_paths(tree, cur))
    with prof.span("device_read"):
        host_batch = {t: (gl.to_u64(v[0]), gl.to_u64(v[1])) for t, v in dev_batch.items()}
        host_layers = [(gl.to_u64(v[0]), gl.to_u64(v[1])) for v in dev_layers]

    query_proofs = []
    for qi in range(num_q):
        query_proofs.append(FriQueryProof(
            batch_leaves={t: host_batch[t][0][qi] for t in TAGS},
            batch_paths={t: list(host_batch[t][1][qi]) for t in TAGS},
            layer_leaves=[rows[qi] for rows, _ in host_layers],
            layer_paths=[list(paths[qi]) for _, paths in host_layers],
        ))
    return FriProof(
        layer_caps=[t.cap for t in trees],
        final_poly=final_poly,
        pow_witness=pow_witness,
        query_indices=indices,
        query_proofs=query_proofs,
    )


def _grind_core(c_f, ws, thr_hi: int):
    """Batched PoW attempt: hash [c, w] for all w; return (found, index of the
    FIRST hit).

    The digest's first element d satisfies d < 2^(64 - pow_bits) iff its
    high 32 bits are below thr_hi (the threshold is a multiple of 2^32 for
    pow_bits <= 32).
    """
    digests = pos.hash_no_pad(torch.stack([c_f.expand(ws.shape[0]), ws], dim=1))
    ok = ((digests[:, 0] >> 32) & 0xFFFF_FFFF) < thr_hi
    idx = torch.argmax(ok.to(torch.uint8))  # the first of equal maxima
    return ok[idx], idx


def grind(ch: Challenger, pow_bits: int, device) -> int:
    """Find w with hash([c, w])[0] < 2^(64 - pow_bits), a batch at a time on
    ``device``.  The batch size and the start decide which witness is found,
    so they are the JAX package's."""
    from .prove import scalar_f

    if pow_bits > 32:
        raise ValueError(f"{pow_bits} proof-of-work bits: at most 32")
    c_f = scalar_f(ch.challenge(), device)
    thr_hi = (1 << (64 - pow_bits)) >> 32
    batch = 1 << min(20, pow_bits + 3)
    start = 0
    while True:
        # witnesses fit 32 bits in practice (expected tries ~2^pow_bits)
        ws = torch.arange(start, start + batch, dtype=torch.int64, device=device)
        found, idx = _grind_core(c_f, ws, thr_hi)
        with ch.prof.span("device_read"):
            if bool(found):  # [device sync]
                return start + int(idx)
        start += batch
        if start >= (1 << 32):
            raise RuntimeError("PoW witness exceeded 32 bits")


def verify_pow(c: int, witness: int, pow_bits: int) -> bool:
    digest = pos.hash_no_pad_host([c, witness])
    return digest[0] < (1 << (64 - pow_bits))
