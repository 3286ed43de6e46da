"""Sharded polynomial commitment.

Port of ``eth_lc_plonky2_tpu/parallel/commit.py``, on one mesh axis:

  columns sharded  -> each rank's columns: IFFT + coset LDE   (no exchange)
  all_to_all       -> the LDE's points sharded
  local leaf hash  -> the Poseidon leaves of this rank's points
  local compress   -> tree levels down to 2^cap_height / D rows
  all_gather       -> the Merkle cap (what the transcript absorbs)

Contiguous point blocks keep every compression local while a level has D
or more rows a rank, so with D <= 2^cap_height the whole tree needs no
exchange but the cap's.  The leaves, levels and cap are the one-device
commitment's, word for word.  The JAX package's version runs under
``shard_map``; here every rank runs the same steps on its own block, and
the sharded prover commits every batch through it (PyTorch has no GSPMD
to place the exchanges).
"""

from __future__ import annotations

import torch

from ..ops import goldilocks as gl
from ..ops import poseidon as pos
from ..prover.merkle import MerkleTree, _levels_core
from ..prover.prove import CommitmentBatch, _transform_core
from .mesh import Mesh


def column_rows(mesh: Mesh, num_polys: int) -> list:
    """The polynomial index of each coefficient row of every rank, rank by
    rank, for contiguous column blocks of ``num_polys`` padded to a multiple
    of D (-1 for a padding row)."""
    return [i if i < num_polys else -1 for i in range(mesh.padded(num_polys))]


def make_sharded_commit(mesh: Mesh, rate_bits: int, cap_height: int, halo: int = 0):
    """Returns fn(values, rows, from_coeffs=False) -> (CommitmentBatch, window).

    ``values`` is this rank's (cb, n) block of rows (evaluations on the
    subgroup H, or coefficients with ``from_coeffs``), the same count cb on
    every rank; ``rows`` the polynomial index of every rank's rows, rank by
    rank (D * cb of them, -1 for padding, which never enters a leaf).  The
    batch holds this rank's coefficient rows, the LDE's points [r L, (r+1) L)
    of every polynomial in polynomial order (L = (n << rate_bits) / D), the
    leaves of those points, the local levels down to 2^cap_height / D rows
    and the whole cap.  The LDE is the middle of ``window``, a (polys, L + 2
    halo) buffer whose halo columns the caller fills."""
    d = mesh.size
    if d > (1 << cap_height) or d & (d - 1):
        raise ValueError(f"a sharded commit over {d} ranks needs D a power of two <= "
                         f"2^cap_height = {1 << cap_height}")
    local_cap = cap_height - (d.bit_length() - 1)

    def fn(values: torch.Tensor, rows: list, from_coeffs: bool = False):
        cb, n = values.shape
        if len(rows) != d * cb:
            raise ValueError(f"{len(rows)} row indices for {d} ranks of {cb} rows")
        coeffs, lde = _transform_core(values, rate_bits, from_coeffs)
        width = (n << rate_bits) // d
        # columns -> points: block q of every row goes to rank q
        recv = mesh.all_to_all(lde.reshape(cb, d, width).transpose(0, 1).reshape(d * cb, width))
        del lde
        real = [i for i, p in enumerate(rows) if p >= 0]
        order = sorted(real, key=lambda i: rows[i])
        if [rows[i] for i in order] != list(range(len(order))):
            raise ValueError("the row indices are not a permutation of the polynomials")
        window = torch.empty((len(order), width + 2 * halo), dtype=torch.int64, device=recv.device)
        points = window[:, halo : halo + width]
        if order == list(range(len(order))):
            points.copy_(recv[: len(order)])
        else:
            points.copy_(recv[torch.tensor(order, device=recv.device)])
        del recv
        levels = _levels_core(pos.hash_no_pad(points.T), local_cap)
        cap = torch.cat(list(mesh.all_gather(levels[-1])))
        tree = MerkleTree(leaves=points, levels=levels, cap_height=cap_height, leaf_axis=1,
                          _cap_u64=gl.to_u64(cap))
        return CommitmentBatch(coeffs=coeffs, lde=points, tree=tree, rows=list(rows)), window

    return fn

