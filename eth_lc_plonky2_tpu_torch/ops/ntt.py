"""Radix-2 NTT / inverse NTT / coset LDE over Goldilocks, on int64 tensors.

Port of ``eth_lc_plonky2_tpu/ops/ntt.py``: polynomials live on the LAST
axis, leading axes are batch; natural order in and out; the forward
transform is unscaled and the inverse is scaled by 1/n.

A CUDA tensor runs the hand-written kernel ``csrc/ntt.cu`` (through
``kernels.ntt_pass``): one pass for n <= 2^11, a four-step of two passes
(columns with the step twiddle, then rows that store natural order) for n <=
2^22, and three passes beyond, up to 2^33 (the four-step's row transform is
itself a four-step: one launch a batch row for its column pass).
The coset scale shift^i, shift^-i and the 1/n scale are applied inside the
passes, and the LDE's zero padding is neither stored nor loaded: the first
pass reads the n coefficients and is told how many stages only copy.  So no
plain field op, fill or copy runs on a CUDA tensor.  A CPU tensor runs the
plain PyTorch version below (bit-reversal permutation, then log n
decimation-in-time stages), which the tests hold against the JAX package.

``_passes`` plans the launches; ``ntt_pass_plain`` is the plain version of
one launch, so the tests run the very plan the card gets on the CPU.
"""

from __future__ import annotations

import functools

import torch

from . import goldilocks as gl
from . import kernels

MAX_LOG_N = 33  # three passes of at most 2^11


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError(f"NTT length must be a power of two, got {n}")
    return log_n


def _root(log_n: int, inverse: bool) -> int:
    w = gl.primitive_root_of_unity(log_n)
    return gl.h_inv(w) if inverse else w


# ---------------------------------------------------------------------------
# Host tables, cached per device
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _powers_on(base: int, n: int, device: str) -> torch.Tensor:
    return gl.powers(base, n, device)


@functools.lru_cache(maxsize=None)
def _bitrev(log_n: int) -> torch.Tensor:
    idx = torch.arange(1 << log_n)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def ntt_plain(f: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Natural-order radix-2 DIT NTT along the last axis, plain tensor ops."""
    n = f.shape[-1]
    log_n = _log2(n)
    if n == 1:
        return f.clone()
    batch = f.shape[:-1]
    pw = _powers_on(_root(log_n, inverse), n // 2, str(f.device))
    a = f[..., _bitrev(log_n).to(f.device)]
    for lh in range(log_n):
        h = 1 << lh
        a = a.reshape(*batch, n // (2 * h), 2, h)
        tw = pw[torch.arange(h, device=f.device) << (log_n - lh - 1)]
        u = a[..., 0, :]
        v = gl.mul_plain(a[..., 1, :], tw)
        a = torch.stack([gl.add_plain(u, v), gl.sub_plain(u, v)], dim=-2).reshape(*batch, n)
    if inverse:
        a = gl.mul_plain(a, gl.from_u64(gl.h_inv(n), f.device))
    return a


def coset_lde_plain(coeffs: torch.Tensor, rate_bits: int, shift: int) -> torch.Tensor:
    n = coeffs.shape[-1]
    scaled = gl.mul_plain(coeffs, _powers_on(shift, n, str(coeffs.device)))
    padded = torch.nn.functional.pad(scaled, (0, (n << rate_bits) - n))
    return ntt_plain(padded)


def coset_intt_plain(evals: torch.Tensor, shift: int) -> torch.Tensor:
    n = evals.shape[-1]
    return gl.mul_plain(ntt_plain(evals, inverse=True), _powers_on(gl.h_inv(shift), n, str(evals.device)))


# ---------------------------------------------------------------------------
# Kernel path
# ---------------------------------------------------------------------------


STEP_BITS = 11  # csrc/ntt.cu: step twiddle w_n^e = hi[e >> 11] * lo[e & 2047]


def _step_tables(log_n: int, inverse: bool, device) -> tuple:
    """(lo, hi): w_n^b for b < 2^11 and w_n^(a * 2^11) for a < n >> 11."""
    w = _root(log_n, inverse)
    lo = _powers_on(w, min(1 << log_n, 1 << STEP_BITS), str(device))
    hi = _powers_on(pow(w, 1 << STEP_BITS, gl.P), max(1, (1 << log_n) >> STEP_BITS), str(device))
    return lo, hi


def _stage_twiddles(log_m: int, inverse: bool, device) -> torch.Tensor:
    """w_m^k for k < max(1, m/2)."""
    return _powers_on(_root(log_m, inverse), max(1, (1 << log_m) >> 1), str(device))


def _passes(x: torch.Tensor, out: torch.Tensor, inverse: bool, in_tab=None, out_tab=None,
            log_pad: int = 0) -> list:
    """The launches that transform (B, n >> log_pad) ``x``, read as length-n
    rows zero beyond their end, into (B, n) ``out``: a list of
    (src, dst, keyword arguments of ``kernels.ntt_pass``).  ``out`` may be
    ``x`` when log_pad is 0."""
    b, n_in = x.shape
    log_in = _log2(n_in)
    log_n = log_in + log_pad
    n = 1 << log_n
    if log_n > MAX_LOG_N:
        raise ValueError(f"NTT length 2^{log_n} above 2^{MAX_LOG_N}")
    dev = x.device
    scalar = gl.h_inv(n) if inverse else None
    if log_n <= 11:
        return [(x, out, dict(total=b, K=1, in_strides=(n_in, 0, 1), out_strides=(n, 0, 1),
                              tw=_stage_twiddles(log_n, inverse, dev), log_m=log_n,
                              log_pad=log_pad, in_tab=in_tab, out_tab=out_tab, scalar=scalar))]
    # n = n1 * n2, input index i2 + n2*i1: it is zero from i1 = n_in / n2 on,
    # so n2 must not exceed n_in.
    log2 = min(log_n // 2, log_in)
    log1 = log_n - log2
    if log1 > 11:
        return _three_passes(x, out, inverse, in_tab, out_tab, log_pad, scalar)
    n1, n2 = 1 << log1, 1 << log2
    tmp = torch.empty((b, n), dtype=torch.int64, device=dev)
    return [
        # columns: x[i2 + n2*i1] over i1, times w^(i2*j1) -> tmp[j1*n2 + i2]
        (x, tmp, dict(total=b * n2, K=n2, in_strides=(n_in, 1, n2), out_strides=(n, 1, n2),
                      tw=_stage_twiddles(log1, inverse, dev), log_m=log1, log_pad=log_pad,
                      step=_step_tables(log_n, inverse, dev), in_tab=in_tab)),
        # rows: tmp[j1*n2 + i2] over i2 -> out[j1 + n1*j2] (natural order)
        (tmp, out, dict(total=b * n1, K=n1, in_strides=(n, n2, 1), out_strides=(n, 1, n1),
                        tw=_stage_twiddles(log2, inverse, dev), log_m=log2,
                        out_tab=out_tab, scalar=scalar)),
    ]


def _three_passes(x, out, inverse: bool, in_tab, out_tab, log_pad: int, scalar) -> list:
    """n = n1 * n2 * n3 where two passes cannot do (beyond 2^22, or a padding
    the column pass cannot read), each factor at most 2^11.  With i = i3 +
    n3*i2 + N*i1 (N = n2*n3) and j = j1 + n1*j2 + n1*n2*j3:

      A: over i1, times w_n^((i3 + n3*i2)*j1)      x -> out[j1*N + i3 + n3*i2]
      B: over i2, times w_N^(i3*j2), a row apiece  -> tmp[j1*n3 + i3 + n1*n3*j2]
      C: over i3                                   -> out[j1 + n1*j2 + n1*n2*j3]

    A is the two-pass plan's column pass with n2 = N, and reads only the n_in
    coefficients (N <= n_in).  B's sub-transforms (j1, i3) of one row take
    j1 as the launch's row and i3 as its sub-transform, so that the step
    exponent is k*j; a batch row of N-word rows has no single stride in its
    output, so B is one launch a batch row.  C reads (j1 + n1*j2) with one
    stride, and its output position is that of the whole row (``out_tab``).
    A writes ``out`` in place of its input's positions (``out`` may be ``x``)
    and C reads only ``tmp``."""
    b, n_in = x.shape
    log_in = _log2(n_in)
    log_n = log_in + log_pad
    log1 = max(-(-log_n // 3), log_pad)
    log2 = -(-(log_n - log1) // 2)
    log3 = log_n - log1 - log2
    if max(log1, log2, log3) > 11:
        raise ValueError(f"cannot pad 2^{log_in} coefficients to 2^{log_n} in three passes")
    n, n1, n2, n3 = 1 << log_n, 1 << log1, 1 << log2, 1 << log3
    big_n = n2 * n3
    dev = x.device
    tmp = torch.empty((b, n), dtype=torch.int64, device=dev)
    passes = [(x, out, dict(total=b * big_n, K=big_n, in_strides=(n_in, 1, big_n),
                            out_strides=(n, 1, big_n), tw=_stage_twiddles(log1, inverse, dev),
                            log_m=log1, log_pad=log_pad, step=_step_tables(log_n, inverse, dev),
                            in_tab=in_tab))]
    step_b = _step_tables(log2 + log3, inverse, dev)
    tw_b = _stage_twiddles(log2, inverse, dev)
    for r in range(b):
        passes.append((out[r], tmp[r], dict(total=n1 * n3, K=n3, in_strides=(big_n, 1, n3),
                                            out_strides=(n3, 1, n1 * n3), tw=tw_b, log_m=log2,
                                            step=step_b)))
    passes.append((tmp, out, dict(total=b * n1 * n2, K=n1 * n2, in_strides=(n, n3, 1),
                                  out_strides=(n, 1, n1 * n2), tw=_stage_twiddles(log3, inverse, dev),
                                  log_m=log3, out_tab=out_tab, scalar=scalar)))
    return passes


def ntt_pass_plain(src, dst, *, total, K, in_strides, out_strides, tw, log_m, log_pad=0,
                   step=None, in_tab=None, out_tab=None, scalar=None) -> None:
    """What one launch of ``csrc/ntt.cu`` computes, on plain tensor ops:
    ``total`` sub-transforms of length 2^log_m, sub-transform s = b*K + k
    reading element i at b*in_b + k*in_k + i*in_i and writing output j at
    b*out_b + k*out_k + j*out_j (see the kernel's header)."""
    m = 1 << log_m
    head = m >> log_pad
    sub = torch.arange(total)
    b, k = sub // K, sub % K
    flat_in, flat_out = src.reshape(-1), dst.reshape(-1)
    pos_in = k[:, None] * in_strides[1] + torch.arange(head)[None, :] * in_strides[2]
    vals = flat_in[b[:, None] * in_strides[0] + pos_in]
    if in_tab is not None:
        vals = gl.mul_plain(vals, in_tab[pos_in])
    # decimation in time: element i lands on the 2^log_pad slots from
    # bitrev(i) on (what the first log_pad stages would make of a zero tail),
    # and the butterflies start at stage log_pad
    slots = (_bitrev(log_m)[:head, None] + torch.arange(1 << log_pad)[None, :]).reshape(-1)
    res = torch.empty((total, m), dtype=torch.int64)
    res[:, slots] = vals.repeat_interleave(1 << log_pad, dim=1)
    for lh in range(log_pad, log_m):
        h = 1 << lh
        res = res.reshape(total, m // (2 * h), 2, h)
        u = res[:, :, 0, :]
        v = gl.mul_plain(res[:, :, 1, :], tw[torch.arange(h) << (log_m - lh - 1)])
        res = torch.stack([gl.add_plain(u, v), gl.sub_plain(u, v)], dim=2).reshape(total, m)
    j = torch.arange(m)
    if step is not None:
        e = k[:, None] * j[None, :]
        lo, hi = step
        res = gl.mul_plain(res, gl.mul_plain(lo[e & ((1 << STEP_BITS) - 1)], hi[e >> STEP_BITS]))
    pos_out = k[:, None] * out_strides[1] + j[None, :] * out_strides[2]
    if out_tab is not None:
        res = gl.mul_plain(res, out_tab[pos_out])
    if scalar is not None:
        res = gl.mul_plain(res, gl.from_u64(scalar))
    flat_out[b[:, None] * out_strides[0] + pos_out] = res


def _ntt_kernel(x: torch.Tensor, out: torch.Tensor, inverse: bool,
                in_tab=None, out_tab=None, log_pad: int = 0, launch=None) -> None:
    """(B, n >> log_pad) -> (B, n) contiguous tensors; ``launch`` runs one
    pass (``kernels.ntt_pass`` unless a test hands in the plain version)."""
    launch = launch or kernels.ntt_pass
    if x.shape[1] << log_pad == 1:
        if out.data_ptr() != x.data_ptr():
            out.copy_(x)
        return
    for src, dst, args in _passes(x, out, inverse, in_tab, out_tab, log_pad):
        launch(src, dst, **args)


def _as_rows(f: torch.Tensor) -> torch.Tensor:
    return f.reshape(-1, f.shape[-1]).contiguous()


def _out_rows(out, shape, like: torch.Tensor) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=torch.int64, device=like.device)
    if tuple(out.shape) != tuple(shape) or not out.is_contiguous() or out.device != like.device:
        raise ValueError(f"out must be a contiguous {tuple(shape)} tensor on {like.device}")
    return out


# ---------------------------------------------------------------------------
# Public functions
# ---------------------------------------------------------------------------


def ntt(f: torch.Tensor, inverse: bool = False, out: torch.Tensor | None = None) -> torch.Tensor:
    """Forward (or inverse, scaled by 1/n) NTT along the last axis; natural order.

    Forward: out[j] = sum_i f[i] * w^(i*j), w the primitive n-th root.
    ``out`` (same shape, contiguous) receives the result; it may be ``f``.
    """
    if not kernels.on_card(f):
        res = ntt_plain(f, inverse)
        return res if out is None else out.copy_(res)
    x = _as_rows(f)
    dst = _out_rows(None if out is None else out.view(x.shape), x.shape, x)
    _ntt_kernel(x, dst, inverse)
    return dst.view(f.shape) if out is None else out


def intt(f: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    return ntt(f, inverse=True, out=out)


def coset_lde(coeffs: torch.Tensor, rate_bits: int, shift: int = gl.MULTIPLICATIVE_GENERATOR,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """Evaluate degree-<n polynomials on shift*H' with |H'| = n*2^rate_bits.

    out[j] = f(shift * W^j) in natural order, W the primitive
    (n*2^rate_bits)-th root.  On the card the first pass reads the n
    coefficients, scales them by shift^i and skips the stages that the
    zero padding turns into copies; ``out`` has shape (..., n << rate_bits).
    """
    n = coeffs.shape[-1]
    big_shape = coeffs.shape[:-1] + (n << rate_bits,)
    if not kernels.on_card(coeffs):
        res = coset_lde_plain(coeffs, rate_bits, shift)
        return res if out is None else out.copy_(res)
    x = _as_rows(coeffs)
    dst = _out_rows(None if out is None else out.view(x.shape[0], -1),
                    (x.shape[0], n << rate_bits), x)
    _ntt_kernel(x, dst, inverse=False, in_tab=_powers_on(shift, n, str(x.device)),
                log_pad=rate_bits)
    return dst.view(big_shape) if out is None else out


def coset_intt(evals: torch.Tensor, rate_bits: int, shift: int = gl.MULTIPLICATIVE_GENERATOR
               ) -> torch.Tensor:
    """Inverse of coset_lde restricted to the first n = len(evals) coefficients."""
    del rate_bits  # as in the JAX package, n is the evaluation count
    n = evals.shape[-1]
    if not kernels.on_card(evals):
        return coset_intt_plain(evals, shift)
    x = _as_rows(evals)
    dst = torch.empty_like(x)
    _ntt_kernel(x, dst, inverse=True, out_tab=_powers_on(gl.h_inv(shift), n, str(x.device)))
    return dst.view(evals.shape)


# ---------------------------------------------------------------------------
# Powers, rolls and reductions (the quotient's, the openings' and FRI's tools)
# ---------------------------------------------------------------------------


def powers_device(x: torch.Tensor, n: int) -> torch.Tensor:
    """[1, x, ..., x^(n-1)] for a shape-() field tensor x, by log-doubling on
    x's device."""
    out = torch.stack([torch.ones_like(x), x])
    if n == 1:
        return out[:1]
    while (k := out.shape[0]) < n:
        take = min(k, n - k)
        factor = gl.mul(out[k - 1], out[1])  # x^k
        out = torch.cat([out, gl.mul(out[:take], factor)])
    return out[:n]


def roll_lde(arr: torch.Tensor, offset: int, rate_bits: int) -> torch.Tensor:
    """Wire value at row r + offset over the LDE domain (natural order): the
    one next-row helper, shared by the quotient and every gate that reads a
    neighbouring row."""
    if offset == 0:
        return arr
    return torch.roll(arr, -(offset << rate_bits), dims=-1)


def _fold_axis(f: torch.Tensor, axis: int, op) -> torch.Tensor:
    """Reduce ``axis`` with the associative, commutative and exact ``op`` by
    folding its upper half onto its lower half (contiguous halves, so a fold
    of the leading axis runs over two flat blocks); any tree gives the same
    field element."""
    n = f.shape[axis]
    while n > 1:
        h = n // 2
        folded = op(f.narrow(axis, 0, h), f.narrow(axis, h, h))
        f = folded if n == 2 * h else torch.cat([folded, f.narrow(axis, 2 * h, 1)], dim=axis)
        n = f.shape[axis]
    return f.select(axis, 0)


def sum_field(f: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Field sum along an axis (a sum over an empty axis is not defined)."""
    return _fold_axis(f, axis, gl.add)


def prod_field(f: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Field product along an axis."""
    return _fold_axis(f, axis, gl.mul)


def eval_poly(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Evaluate polynomials (coefficients on the last axis) at the shape-()
    field tensor x: powers of x by log-doubling, then a field dot product."""
    return sum_field(gl.mul(coeffs, powers_device(x, coeffs.shape[-1])), axis=-1)
