"""Distributed NTT: the evaluation points sharded across the ranks.

Port of ``eth_lc_plonky2_tpu/parallel/ntt.py``, the transpose (four-step)
form, whose butterfly exchanges are three all-to-alls:

    view x (n,) as M[i2, i1] (n2 x n1 row-major); X = NTT_n(x) is
      A[i1, k2] = NTT_{n2 over i2}(M)          local after a2a #1
      B[i1, k2] = A * w^(i1*k2)                local twiddle
      C[k2, k1] = NTT_{n1 over i1}(B)          local after a2a #2
      X[k1*n2 + k2] = C[k2, k1]                natural order after a2a #3

Rank r holds the block [r n/D, (r+1) n/D) of the points of every row of a
(rows, n) batch, in and out.  Every local transform is ``ops/ntt.py``'s
(``csrc/ntt.cu`` on the card), the twiddle one product of ``csrc/field.cu``
with this rank's (n1/D, n2) table, and the exchanges the ``Mesh``'s; the
transposes between them are copies.  So the result is the one-device NTT's,
word for word.  As in the JAX package, n = n1 n2 needs n1 and n2 divisible
by D, so n >= D^2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import host_field as hf
from ..ops import ntt as nttm
from .mesh import Mesh


def _split_dims(n: int, d: int) -> tuple[int, int]:
    """n = n1 * n2 with n1, n2 powers of two, both divisible by d."""
    log_n = n.bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError(f"distributed NTT length {n} is not a power of two")
    n1 = 1 << (log_n // 2)
    n2 = n // n1
    if n1 % d or n2 % d:
        raise ValueError(f"distributed NTT needs n >= D^2 and D a power of two (n={n}, D={d})")
    return n1, n2


@functools.lru_cache(maxsize=None)
def _twiddle_u64(n: int, n1: int, n2: int, inverse: bool, first: int, count: int) -> np.ndarray:
    """T[i1, k2] = w^((first + i1) * k2), i1 < count, as (count, n2) u64 (w
    the primitive n-th root, inverted for the inverse)."""
    w = gl.primitive_root_of_unity(n.bit_length() - 1)
    if inverse:
        w = gl.h_inv(w)
    rows = hf.powers(w, n1)  # w^i1
    out = np.empty((count, n2), dtype=np.uint64)
    for i in range(count):
        out[i] = hf.powers(int(rows[first + i]), n2)
    return out


def _a2a_blocks(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """(rows, a, D*b) -> (rows, D*a, b): the last axis's block q goes to rank
    q, and the blocks received are stacked along the middle axis in rank
    order."""
    rows, a, db = t.shape
    b = db // mesh.size
    send = t.reshape(rows, a, mesh.size, b).permute(2, 0, 1, 3)  # (D, rows, a, b)
    recv = mesh.all_to_all(send.reshape(mesh.size * rows, a * b))
    return recv.reshape(mesh.size, rows, a, b).permute(1, 0, 2, 3).reshape(rows, mesh.size * a, b)


def make_dist_ntt(mesh: Mesh, n: int, inverse: bool = False):
    """A distributed NTT of length n over ``mesh``: fn(x) with x this rank's
    (rows, n/D) block of points -> its (rows, n/D) block of the transform,
    equal to ``ops.ntt.ntt(f, inverse)`` of the whole rows in natural order."""
    d = mesh.size
    n1, n2 = _split_dims(n, d)
    mine = mesh.block(n1)
    tw = gl.from_u64(_twiddle_u64(n, n1, n2, inverse, mine.start, n1 // d), mesh.device)

    def fn(x: torch.Tensor) -> torch.Tensor:
        rows = x.shape[0]
        if tuple(x.shape) != (rows, n // d):
            raise ValueError(f"distributed NTT: a block of shape {tuple(x.shape)}, expected "
                             f"(rows, {n // d})")
        m = x.reshape(rows, n2 // d, n1)  # rows of M: i2 in this rank's block
        cols = _a2a_blocks(mesh, m)  # (rows, n2, n1/D): i1 in this rank's block
        a = nttm.ntt(cols.transpose(1, 2).contiguous(), inverse=inverse)  # A[i1, k2]
        b = gl.mul(a, tw)  # A * w^(i1*k2)
        rws = _a2a_blocks(mesh, b)  # (rows, n1, n2/D): k2 in this rank's block
        c = nttm.ntt(rws.transpose(1, 2).contiguous(), inverse=inverse)  # C[k2, k1]
        xc = _a2a_blocks(mesh, c)  # (rows, n2, n1/D): k1 in this rank's block
        return xc.transpose(1, 2).reshape(rows, n // d)  # X[k1*n2 + k2]

    return fn


def make_dist_coset_lde(mesh: Mesh, n: int, rate_bits: int,
                        shift: int = gl.MULTIPLICATIVE_GENERATOR):
    """A distributed coset LDE: fn(c) with c this rank's (rows, n/D) block of
    coefficients -> its (rows, (n << rate_bits)/D) block of the evaluations
    on shift * H' in natural order, equal to ``ops.ntt.coset_lde``.  The
    scaled coefficients are gathered and every rank takes its block of the
    zero-padded rows (the JAX package lets XLA move them)."""
    big_n = n << rate_bits
    ntt_big = make_dist_ntt(mesh, big_n, inverse=False)
    mine = mesh.block(n)
    shifts = gl.from_u64(hf.powers(shift, n)[mine], mesh.device)
    padded_block = mesh.block(big_n)

    def fn(coeffs: torch.Tensor) -> torch.Tensor:
        scaled = gl.mul(coeffs, shifts)
        whole = torch.cat(list(mesh.all_gather(scaled)), dim=1)  # (rows, n)
        block = torch.zeros((coeffs.shape[0], big_n // mesh.size), dtype=torch.int64,
                            device=coeffs.device)
        lo, hi = padded_block.start, min(padded_block.stop, n)
        if hi > lo:
            block[:, : hi - lo] = whole[:, lo:hi]
        return ntt_big(block)

    return fn


def make_dist_coset_intt(mesh: Mesh, n: int, shift: int):
    """The inverse of a coset LDE of length n, distributed: fn(e) with e this
    rank's (rows, n/D) block of evaluations on shift * H -> its block of
    the coefficients, equal to ``ops.ntt.coset_intt``."""
    intt = make_dist_ntt(mesh, n, inverse=True)
    unshift = gl.from_u64(hf.powers(gl.h_inv(shift), n)[mesh.block(n)], mesh.device)

    def fn(evals: torch.Tensor) -> torch.Tensor:
        return gl.mul(intt(evals), unshift)

    return fn
