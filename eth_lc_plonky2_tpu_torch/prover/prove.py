"""The prover's polynomial commitment: values -> IFFT -> coset LDE -> Merkle cap.

Port of the commitment section of ``eth_lc_plonky2_tpu/prover/prove.py``
(``SHIFT``, ``CommitmentBatch``, ``_transform_core``, ``_hash_levels_core``,
``_commit_core`` and the ``commit_*`` entry points).  Each proof commits
three batches this way (wires, Z, quotient), and the same transforms and
hashes build every FRI layer tree.  The rest of ``prove()`` is later work.

The coefficients, the LDE and every Merkle level stay on the values'
device; only the cap is copied to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import ntt as nttm
from ..ops import poseidon as pos
from .merkle import MerkleTree, _levels_core

SHIFT = gl.MULTIPLICATIVE_GENERATOR  # LDE coset shift g = 7

_COMMIT_CHUNK = 16  # polys per transform pass (bounds the NTT scratch)


@dataclasses.dataclass
class CommitmentBatch:
    """A batch of polynomials committed together: one leaf per LDE point."""

    coeffs: torch.Tensor  # (num_polys, n)
    lde: torch.Tensor  # (num_polys, n << rate_bits)
    tree: MerkleTree

    @property
    def cap(self) -> np.ndarray:
        return self.tree.cap


def _transform_core(vals: torch.Tensor, rate_bits: int, from_coeffs: bool):
    """IFFT -> coset LDE, in chunks of at most _COMMIT_CHUNK polys.

    The coefficients and the LDE are each allocated once, whole, and every
    chunk is transformed in place inside them, so besides the outputs only
    one chunk's NTT scratch is live (the wires LDE alone is (184, 2^21),
    3.1 GB).
    """
    num, n = vals.shape
    coeffs = vals if from_coeffs else torch.empty_like(vals)
    lde = torch.empty((num, n << rate_bits), dtype=torch.int64, device=vals.device)
    for r0 in range(0, num, _COMMIT_CHUNK):
        rows = slice(r0, min(num, r0 + _COMMIT_CHUNK))
        if not from_coeffs:
            nttm.intt(vals[rows], out=coeffs[rows])
        nttm.coset_lde(coeffs[rows], rate_bits, SHIFT, out=lde[rows])
    return coeffs, lde


def _hash_levels_core(lde: torch.Tensor, cap_height: int) -> list:
    """Leaf hash (leaf j = lde[:, j], read through the transposed view) and
    Merkle levels down to the cap."""
    return _levels_core(pos.hash_no_pad(lde.T), cap_height)


def _commit_core(vals, rate_bits: int, cap_height: int, from_coeffs: bool = False):
    coeffs, lde = _transform_core(vals, rate_bits, from_coeffs)
    return coeffs, lde, _hash_levels_core(lde, cap_height)


def _make_batch(coeffs, lde, levels, cap_height: int) -> CommitmentBatch:
    tree = MerkleTree(leaves=lde, levels=levels, cap_height=cap_height, leaf_axis=1)
    return CommitmentBatch(coeffs=coeffs, lde=lde, tree=tree)


def commit_field_values(values: torch.Tensor, rate_bits: int, cap_height: int) -> CommitmentBatch:
    """values: (num_polys, n) field tensor of evaluations on the subgroup H."""
    return _make_batch(*_commit_core(values, rate_bits, cap_height), cap_height)


def commit_values(values_u64: np.ndarray, rate_bits: int, cap_height: int,
                  device="cuda") -> CommitmentBatch:
    """values: (num_polys, n) uint64 host array on the subgroup H.

    The values go to the card and are committed there; without a card the
    default call raises.  ``device="cpu"`` asks for the plain versions.
    """
    return commit_field_values(gl.from_u64(values_u64, device), rate_bits, cap_height)


def commit_coeffs(coeffs: torch.Tensor, rate_bits: int, cap_height: int) -> CommitmentBatch:
    """coeffs: (num_polys, n) field tensor in coefficient form."""
    return _make_batch(*_commit_core(coeffs, rate_bits, cap_height, from_coeffs=True),
                       cap_height)
