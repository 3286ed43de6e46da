"""The sharded prover: the same phases, each rank holding its shard.

Port of ``eth_lc_plonky2_tpu/parallel/prover.py``.  The JAX package places
the inputs with NamedShardings and lets XLA's GSPMD insert the collectives;
PyTorch has none, so ``ShardedPhases`` schedules each exchange itself and
``prove_sharded`` runs ``prover/prove.py``'s ``prove_with``, the one-device
prove's transcript, with it.  Field arithmetic is exact, so every rank's
proof equals the one-device ``prove``'s byte for byte.

D ranks, rank r; n trace rows, N = n << rate LDE points, L = N / D;
"points" is a contiguous block of the last axis, "columns" one of the rows:

  witness       every rank builds the whole witness (as the JAX package's
                multi-controller does) and uploads its column block and its
                point block of the routed wires
  commits       parallel/commit.py (column-sharded transforms, one
                all_to_all to points, local leaves and levels, the cap
                gathered); Z's point block is resharded to columns first
  Z             the permutation rows of the rank's n/D rows (the one-device
                kernels), then one carry: the product of the earlier ranks'
                block totals (all_gather of D totals a challenge)
  quotient      each rank's L points with halos of H = (largest row offset,
                1 for Z) << rate points on each side (one exchange with the
                neighbours, wrapping): the kernels' window form
  split         the distributed coset inverse NTT (parallel/ntt.py): the
                rank's block of coefficients is 2^rate / D whole chunks
  openings      each rank's coefficient rows, the values gathered
  FRI           G on the rank's points, gathered (2 x N words); the folds,
                layer trees, final polynomial and grind are replicated
  queries       each rank answers the indices it owns; one exchange

Every rank runs the same ``Challenger`` over the same host words (caps,
opening values, the final polynomial), so every rank returns the same proof.
Limits: D a power of two dividing 2^rate, D <= 2^cap_height, n >= D^2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..circuit.builder import Witness
from ..ops import goldilocks as gl
from ..prover import fri as frim
from ..prover import prove as pr
from ..prover.merkle import MerkleTree, owned_rows_and_paths
from ..prover.profiler import Profiler
from .commit import column_rows, make_sharded_commit
from .mesh import Mesh
from .ntt import make_dist_coset_intt

P = gl.P


def halo_points(data) -> int:
    """The halo H of a quotient window: the largest absolute trace-row offset
    the gates read (and 1, the permutation's next row), in LDE points."""
    return max([1] + [abs(o) for o in pr.wire_offsets_used(data)]) << data.config.rate_bits


def _check_mesh(data, mesh: Mesh) -> None:
    cfg = data.config
    d = mesh.size
    if (d & (d - 1) or (1 << cfg.rate_bits) % d or d > (1 << cfg.cap_height)
            or data.n < d * d):
        raise ValueError(f"{d} ranks: the sharded prover needs D a power of two dividing "
                         f"2^rate_bits = {1 << cfg.rate_bits}, D <= 2^cap_height = "
                         f"{1 << cfg.cap_height} and n = {data.n} >= D^2")


def _rows_block(mesh: Mesh, values: np.ndarray, rows: list) -> np.ndarray:
    """This rank's rows of ``values`` as ``rows`` names them, zeros for
    padding."""
    mine = rows[mesh.block(len(rows))]
    out = np.zeros((len(mine), values.shape[1]), dtype=values.dtype)
    for i, p in enumerate(mine):
        if p >= 0:
            out[i] = values[p]
    return out


def shard_prover_data(pd: pr.ProverData, mesh: Mesh) -> pr.ProverData:
    """This rank's ``ProverData``: its column block of the preprocessed
    coefficients, the window of its points of their LDE (the points [r L - H,
    (r+1) L + H) mod N; the batch's LDE is the middle), the leaves and the
    levels' blocks of those points with the whole cap, and its point block of
    ``sigma`` and ``omega_pows`` on the trace domain."""
    data = pd.data
    _check_mesh(data, mesh)
    cfg = data.config
    dev = mesh.device
    n_lde = data.n << cfg.rate_bits
    width = n_lde // mesh.size
    lo = mesh.rank * width
    halo = halo_points(data)
    if halo > width:
        raise ValueError(f"a halo of {halo} points is wider than a block of {width}")
    batch = pd.pre_batch
    rows = column_rows(mesh, batch.coeffs.shape[0])
    cb = len(rows) // mesh.size
    coeffs = torch.zeros((cb, data.n), dtype=torch.int64, device=dev)
    mine = [p for p in rows[mesh.block(len(rows))] if p >= 0]
    if mine:
        coeffs[: len(mine)] = batch.coeffs[mine[0] : mine[-1] + 1].to(dev)
    cols = torch.arange(lo - halo, lo + width + halo, device=batch.lde.device) % n_lde
    window = batch.lde.index_select(1, cols).to(dev)
    lde = window[:, halo : halo + width]
    levels = [lvl[mesh.block(lvl.shape[0])].to(dev) for lvl in batch.tree.levels]
    tree = MerkleTree(leaves=lde, levels=levels, cap_height=batch.tree.cap_height, leaf_axis=1,
                      _cap_u64=batch.cap)
    out = pr.ProverData(data=data, pre_values=pd.pre_values,
                        pre_batch=pr.CommitmentBatch(coeffs=coeffs, lde=lde, tree=tree, rows=rows))
    nr = cfg.num_routed_wires
    pts = mesh.block(data.n)
    out.dev["sigma"] = gl.from_u64(np.ascontiguousarray(data.sigma[:nr, pts]), dev)
    out.dev["omega_pows"] = pd.dev["omega_pows"][pts].to(dev).contiguous()
    out.dev["k_shifts"] = gl.from_u64(data.k_shifts[:nr], dev)
    out.dev["pre_window"] = window
    out.dev["shard"] = (mesh.rank, mesh.size)
    return out


class ShardedPhases(pr.Phases):
    """``prove_with``'s phases on rank r of ``mesh``, ``pd`` this rank's shard
    (``shard_prover_data``)."""

    def __init__(self, pd: pr.ProverData, mesh: Mesh):
        super().__init__(pd)
        if pd.dev.get("shard") != (mesh.rank, mesh.size):
            raise ValueError("the ProverData is not this rank's shard of the mesh")
        data = pd.data
        self.mesh = mesh
        self.n_lde = data.n << self.rate
        self.width = self.n_lde // mesh.size
        self.lo = mesh.rank * self.width
        self.halo = halo_points(data)
        self.commit = make_sharded_commit(mesh, self.rate, self.cap_h, self.halo)
        self.windows: dict = {}

    # -- witness, commitments ---------------------------------------------------

    def upload(self, wires_u64: np.ndarray) -> None:
        cfg = self.pd.data.config
        self.wires_u64 = wires_u64
        self.wire_rows = column_rows(self.mesh, wires_u64.shape[0])
        self.wires = gl.from_u64(_rows_block(self.mesh, wires_u64, self.wire_rows),
                                 self.device)
        pts = self.mesh.block(self.pd.data.n)
        self.routed = gl.from_u64(np.ascontiguousarray(wires_u64[: cfg.num_routed_wires, pts]),
                                  self.device)

    def _commit_with_window(self, tag: str, values: torch.Tensor, rows: list):
        batch, window = self.commit(values, rows)
        self.windows[tag] = window
        return batch

    def commit_wires(self) -> pr.CommitmentBatch:
        return self._commit_with_window("W", self.wires, self.wire_rows)

    def permutation(self, betas: list, gammas: list) -> torch.Tensor:
        """Z and the partials on this rank's n/D rows, times the product of
        the earlier ranks' block totals."""
        pd, mesh = self.pd, self.mesh
        data, cfg = pd.data, pd.data.config
        m = cfg.num_permutation_chunks
        local = pr.permutation_polys(pd, self.routed, betas, gammas)  # Z from 1 at the block's start
        last = mesh.block(data.n).stop - 1
        z_last = gl.to_u64(local[::m, -1])
        totals = [int(z_last[j]) * _row_ratio(data, self.wires_u64, last, betas[j], gammas[j]) % P
                  for j in range(len(betas))]
        every = gl.to_u64(mesh.all_gather(pr.scalars_f(totals, self.device)))  # (D, challenges)
        carry = []
        for j in range(len(betas)):
            c = 1
            for q in range(mesh.rank):
                c = c * int(every[q, j]) % P
            carry.append(c)
        scale = pr.scalars_f(carry, self.device)[:, None, None]
        return gl.mul(local.reshape(len(betas), m, -1), scale).reshape(local.shape)

    def commit_values(self, values: torch.Tensor) -> pr.CommitmentBatch:
        """Z's point block (rows, n/D) resharded to column blocks, then
        committed."""
        mesh = self.mesh
        rows = column_rows(mesh, values.shape[0])
        cb = len(rows) // mesh.size
        padded = torch.zeros((len(rows), values.shape[1]), dtype=torch.int64, device=self.device)
        padded[: values.shape[0]] = values
        recv = mesh.all_to_all(padded)  # rank q's points of my rows, rank by rank
        cols = recv.reshape(mesh.size, cb, -1).transpose(0, 1).reshape(cb, -1)
        return self._commit_with_window("Z", cols, rows)

    def _fill_halo(self, window: torch.Tensor) -> torch.Tensor:
        h, w = self.halo, self.width
        mesh = self.mesh
        edges = mesh.all_gather(torch.stack([window[:, h : 2 * h], window[:, w : w + h]]))
        window[:, :h] = edges[(mesh.rank - 1) % mesh.size, 1]
        window[:, h + w :] = edges[(mesh.rank + 1) % mesh.size, 0]
        return window

    def quotient(self, wires, zs, pi_values, betas, gammas, alphas) -> torch.Tensor:
        """This rank's chunks of the quotient in coefficient form: the
        quotient's values on its points (window form), then the distributed
        coset inverse NTT; its block of coefficients is whole chunks
        (``_quotient_rows``)."""
        pd, mesh, dev = self.pd, self.mesh, self.device
        data, cfg = pd.data, pd.data.config
        qv = pr._get_kernel(pd, "quotient_values", lambda: pr.make_quotient_values(
            pd, (self.lo, self.halo, self.width)))
        vals = qv(self._fill_halo(self.windows["W"]), self._fill_halo(self.windows["Z"]),
                  pd.dev["pre_window"], pr.scalars_f(pi_values, dev), pr.scalars_f(betas, dev),
                  pr.scalars_f(gammas, dev), alphas)
        intt = pr._get_kernel(pd, "quotient_intt",
                              lambda: make_dist_coset_intt(mesh, self.n_lde, pr.SHIFT))
        coeffs = intt(vals)  # (challenges, L): coefficients [lo, lo + L) of each
        return coeffs.reshape(cfg.num_challenges * (self.width // data.n), data.n)

    def _quotient_rows(self) -> list:
        """Chunk c of challenge j is row j 2^rate + c of the quotient batch;
        rank q holds chunks [q per, (q+1) per) of each challenge, per =
        2^rate / D, challenge by challenge."""
        per = self.width // self.pd.data.n
        return [j * (1 << self.rate) + q * per + c for q in range(self.mesh.size)
                for j in range(self.pd.data.config.num_challenges) for c in range(per)]

    def commit_coeffs(self, coeffs: torch.Tensor) -> pr.CommitmentBatch:
        batch, _ = self.commit(coeffs, self._quotient_rows(), from_coeffs=True)
        return batch

    # -- openings, FRI ------------------------------------------------------------

    def to_host(self, batch: pr.CommitmentBatch, values) -> tuple:
        """Every rank's values of its rows, gathered into polynomial order."""
        both = self.mesh.all_gather(torch.stack(values))  # (D, 2, k, cb)
        host = gl.to_u64(both.permute(1, 2, 0, 3).reshape(2, both.shape[2], -1))
        real = [i for i, p in enumerate(batch.rows) if p >= 0]
        order = np.array(sorted(real, key=lambda i: batch.rows[i]), dtype=np.int64)
        return host[0][:, order], host[1][:, order]

    def fri_g(self, batches, counts, spec_tags, apow_f, y_f, z_f):
        """G on this rank's points, every rank's gathered: the whole coset."""
        pd = self.pd
        gk = pr._get_kernel(pd, "fri_g", lambda: frim.make_g_kernel(
            pd, counts, len(spec_tags), spec_tags, points=(self.lo, self.width)))
        g = gk(tuple(batches[t].lde for t in frim.TAGS), apow_f, y_f, z_f)
        every = self.mesh.all_gather(torch.stack(g))  # (D, 2, L)
        whole = every.permute(1, 0, 2).reshape(2, self.n_lde)
        return whole[0], whole[1]

    def batch_queries(self, batches: dict, idx: torch.Tensor) -> dict:
        """Each index answered by the rank that owns its point, exchanged."""
        out = {}
        for tag in frim.TAGS:
            _, rows, paths = owned_rows_and_paths(batches[tag].tree, idx, self.lo)
            owner = torch.div(idx, self.width, rounding_mode="floor")
            pick = torch.arange(idx.shape[0], device=idx.device)
            out[tag] = (self.mesh.all_gather(rows)[owner, pick],
                        self.mesh.all_gather(paths)[owner, pick])
        return out


def _row_ratio(data, wires_u64: np.ndarray, row: int, beta: int, gamma: int) -> int:
    """prod_i (w_i + beta k_i x + gamma) / prod_i (w_i + beta sigma_i + gamma)
    at trace row ``row`` (x = omega^row) over the routed wires, on the host:
    the row's factor of Z."""
    cfg = data.config
    x = pow(gl.primitive_root_of_unity(data.log_n), row, P)
    num = den = 1
    for i in range(cfg.num_routed_wires):
        w = int(wires_u64[i, row])
        num = num * ((w + beta * int(data.k_shifts[i]) % P * x + gamma) % P) % P
        den = den * ((w + beta * int(data.sigma[i, row]) + gamma) % P) % P
    return num * pow(den, P - 2, P) % P


def prove_sharded(pd: pr.ProverData, witness: Witness, mesh: Mesh,
                  prof: Profiler | None = None) -> pr.Proof:
    """A proof made by the ranks of ``mesh`` together, each calling this with
    the same ``pd`` and ``witness``; every rank returns the proof
    ``prove(pd, witness)`` makes on one device.  ``pd`` is a one-device
    ``ProverData`` (sharded here) or this rank's shard from
    ``shard_prover_data``, which a rank keeps for its next proofs."""
    if pd.dev.get("shard") is None:
        pd = shard_prover_data(pd, mesh)
    return pr.prove_with(ShardedPhases(pd, mesh), witness, prof)
