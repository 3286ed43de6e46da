"""Poseidon Merkle trees with caps, device-resident.

Port of ``eth_lc_plonky2_tpu/prover/merkle.py``.  Leaves, digests and
every level stay on the tensors' device; only the cap (2^cap_height
digests, what a transcript absorbs) is copied to the host.

Leaf layouts:
  * leaf_axis=0: ``leaves`` is (N, L); leaf i = leaves[i]        (FRI layers)
  * leaf_axis=1: ``leaves`` is (L, N); leaf i = leaves[:, i]     (poly LDEs)
``levels[k]`` has shape (N >> k, 4), pairs are (2i, 2i+1), and the last
level is the cap.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import poseidon as pos


@dataclasses.dataclass
class MerkleTree:
    leaves: torch.Tensor  # see leaf_axis
    levels: list  # [(N >> k, 4) int64 tensors], ending at the cap
    cap_height: int
    leaf_axis: int = 0
    _cap_u64: np.ndarray | None = None

    @property
    def num_leaves(self) -> int:
        return self.leaves.shape[self.leaf_axis]

    @property
    def cap(self) -> np.ndarray:
        """Host (2^cap_height, 4) uint64 cap digests (copied once)."""
        if self._cap_u64 is None:
            self._cap_u64 = gl.to_u64(self.levels[-1])
        return self._cap_u64


def _levels_core(digests: torch.Tensor, cap_height: int) -> list:
    """Digest row (N, 4) -> all levels down to the cap: one launch a level
    while the levels are large, then one launch for all the small ones."""
    levels = [digests]
    while (n := levels[-1].shape[0]) > (1 << cap_height):
        if n // 2 <= pos.TAIL_MAX_PAIRS:
            left = (n.bit_length() - 1) - cap_height
            levels.extend(pos.compress_tail(levels[-1], left))
        else:
            levels.append(pos.compress_level(levels[-1]))
    return levels


def tree_from_digests(leaves, digests, cap_height: int, leaf_axis: int = 0) -> MerkleTree:
    return MerkleTree(leaves=leaves, levels=_levels_core(digests, cap_height),
                      cap_height=cap_height, leaf_axis=leaf_axis)


def build_merkle(leaves, cap_height: int, device="cuda") -> MerkleTree:
    """leaves: (N, L) uint64 host array or int64 tensor; N a power of two.

    A host array goes to ``device`` first: the card by default (the call
    raises where there is none), the plain versions with ``device="cpu"``.
    A tensor is hashed where it lies.
    """
    if isinstance(leaves, np.ndarray):
        leaves = gl.from_u64(leaves, device)
    n = leaves.shape[0]
    if n & (n - 1) or n < (1 << cap_height):
        raise ValueError(f"{n} leaves cannot form a tree with cap height {cap_height}")
    return tree_from_digests(leaves, pos.hash_no_pad(leaves), cap_height, leaf_axis=0)


def gather_rows_and_paths(tree: MerkleTree, idx):
    """Batched query extraction on the tree's device.

    idx: (k,) leaf indices.  Returns (rows (k, L), paths (k, depth, 4)):
    each query's leaf row and its sibling digests from the leaf level up
    to, and excluding, the cap.
    """
    if not isinstance(idx, torch.Tensor):
        idx = torch.from_numpy(np.asarray(idx, dtype=np.int64))
    idx = idx.to(device=tree.leaves.device, dtype=torch.int64)
    if tree.leaf_axis == 1:
        rows = tree.leaves.index_select(1, idx).T
    else:
        rows = tree.leaves.index_select(0, idx)
    sibs = []
    cur = idx
    for level in tree.levels[:-1]:
        sibs.append(level.index_select(0, cur ^ 1))
        cur = cur >> 1
    if sibs:
        paths = torch.stack(sibs, dim=1)
    else:
        paths = torch.zeros((idx.shape[0], 0, 4), dtype=torch.int64, device=idx.device)
    return rows, paths


def owned_rows_and_paths(tree: MerkleTree, idx: torch.Tensor, first: int) -> tuple:
    """A rank's answers to queries of a point-sharded tree: ``tree`` holds the
    leaves [first, first + num_leaves) and its levels' matching blocks down to
    its rows of the cap (``parallel/commit.py``).  Returns (owned (k,) bool,
    rows (k, L), paths (k, depth, 4)): each owned index's leaf row and path
    below the cap, which equal the whole tree's, and zeros for the indices
    another rank owns."""
    local = idx - first
    owned = (local >= 0) & (local < tree.num_leaves)
    rows, paths = gather_rows_and_paths(tree, torch.where(owned, local, torch.zeros_like(local)))
    zero = torch.zeros((), dtype=torch.int64, device=rows.device)
    return (owned, torch.where(owned[:, None], rows, zero),
            torch.where(owned[:, None, None], paths, zero))


def verify_merkle_batch(leaf_rows, indices, paths, cap) -> bool:
    """Host check of a batch of queries against ONE tree, on the plain sponge.

    leaf_rows (N, L), indices (N,), paths (N, depth, 4) and cap
    (2^cap_height, 4) are uint64 arrays (or int64 tensors); all N chains
    are hashed in lock-step on the CPU.
    """
    def host(a):
        if isinstance(a, torch.Tensor):
            return a.detach().cpu()
        return gl.from_u64(a)

    rows = host(leaf_rows)
    path_t = host(paths)
    cap_t = host(cap)
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64))
    digest = pos.hash_no_pad(rows)
    for d in range(path_t.shape[1]):
        sib = path_t[:, d, :]
        odd = (idx & 1).bool()[:, None]
        left = torch.where(odd, sib, digest)
        right = torch.where(odd, digest, sib)
        digest = pos.compress(left, right)
        idx = idx >> 1
    return bool((digest == cap_t[idx]).all())


def merkle_path(tree: MerkleTree, index: int) -> list:
    """One index's host path, as a list of (4,) uint64 digests."""
    _, paths = gather_rows_and_paths(tree, np.array([index], dtype=np.int64))
    return list(gl.to_u64(paths)[0])


def verify_merkle(leaf_values, index: int, path, cap) -> bool:
    """Host check of one path on Python integers: ``leaf_values`` is the full
    leaf row."""
    digest = pos.hash_no_pad_host([int(v) for v in leaf_values])
    idx = index
    for sib in path:
        sib = [int(v) for v in sib]
        digest = pos.compress_host(sib, digest) if idx & 1 else pos.compress_host(digest, sib)
        idx >>= 1
    return digest == [int(v) for v in np.asarray(cap)[idx]]
