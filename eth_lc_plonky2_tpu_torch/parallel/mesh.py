"""The 1-D prover mesh: a group of ranks, one process each, on
``torch.distributed``.

Port of ``eth_lc_plonky2_tpu/parallel/mesh.py``.  The JAX package's mesh
names devices and its shardings tell XLA where each block lives; here every
rank is a process that holds its own block, and the ``Mesh`` gives the
blocks' bounds and the exchanges that move them:

  * ``block(n)``: this rank's contiguous block of an axis of n (the JAX
    package's ``P(AXIS)`` on that axis), n a multiple of the rank count;
  * ``padded(c)``: c rounded up to a multiple of the rank count (columns);
  * ``all_to_all``, ``all_gather`` and ``broadcast`` of int64 field tensors.

The collectives move bit patterns and never add: a field word is its int64
bit pattern, and no reduction touches it.  Under NCCL the tensors go as they
are; under gloo a CUDA tensor is copied through pinned host buffers, since
gloo's exchanges here take host tensors: that is how two ranks share one
card, and it is chosen by the backend's name, never after a failure.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Mesh:
    """The ranks of the default process group, this one's index and count,
    its ``device`` and the collective backend's name."""

    def __init__(self, device):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: call parallel.distributed"
                               ".initialize first")
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.device = torch.device(device)
        self.backend = str(dist.get_backend())
        if self.device.type == "cuda" and self.backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {self.backend} for CUDA tensors")
        self.staged = self.backend == "gloo" and self.device.type == "cuda"

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, size={self.size}, device={self.device}, "
                f"backend={self.backend})")

    # -- blocks ---------------------------------------------------------------

    def block(self, n: int) -> slice:
        """The contiguous block of an axis of ``n`` that this rank holds."""
        if n % self.size:
            raise ValueError(f"an axis of {n} does not split into {self.size} blocks")
        return slice(self.rank * n // self.size, (self.rank + 1) * n // self.size)

    def padded(self, count: int) -> int:
        """``count`` rounded up to a multiple of the rank count."""
        return -(-count // self.size) * self.size

    # -- exchanges ------------------------------------------------------------

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` split into ``size`` equal blocks along axis 0, block q to rank
        q; returns the blocks received, rank by rank along axis 0."""
        t = t.contiguous()
        if t.shape[0] % self.size:
            raise ValueError(f"all_to_all of {t.shape[0]} rows over {self.size} ranks")
        if self.size == 1:
            return t
        if self.staged:
            src = self._host(t)
            out = torch.empty_like(src)
            dist.all_to_all_single(out, src)
            return out.to(self.device)
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (same shape on each), stacked: (size, *t.shape)
        on this rank's device."""
        t = t.contiguous()
        if self.size == 1:
            return t[None]
        if self.backend == "gloo":
            src = self._host(t) if self.staged else t
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src)
            return torch.stack(parts).to(self.device)
        out = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t)
        return out

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank (``t`` gives the shape)."""
        t = t.contiguous()
        if self.size == 1:
            return t
        if self.staged:
            host = self._host(t)
            dist.broadcast(host, 0)
            return host.to(self.device)
        dist.broadcast(t, 0)
        return t
