"""The prover pipeline: witness -> proof.

Port of ``eth_lc_plonky2_tpu/prover/prove.py``:

  witness matrix -> per-column IFFT -> coset LDE (rate 2^3) ->
  Poseidon Merkle-cap commit -> permutation Z + partial products ->
  quotient polynomial (constraint evaluation over the LDE domain) ->
  openings at zeta -> batched FRI.

Goldilocks arithmetic is exact, so a proof equals the JAX package's byte for
byte.  There is no ``jit`` and no executable cache here: PyTorch runs
eagerly, and each field operation on a CUDA tensor is one launch of
``csrc/field.cu``; chains that XLA fuses for the JAX package are one fused
kernel of ``csrc/field.cu`` each on the card (Z and the partial products of
both challenges, three launches a proof; the quotient's permutation terms,
one; the openings, at most two a batch; FRI's G and each fold, in
``prover/fri.py``), and the gates' share of the quotient is
one launch of ``csrc/gates.cu`` for the SHA-256 gate, one for the Poseidon
gate and one for the generic gates with the public inputs.

``prove`` is the transcript's order of phases (``prove_with``) driving a
``Phases``: the device side of each phase on one device.  The sharded prover
(``parallel/prover.py``) drives the same ``prove_with`` with its own
``Phases``, whose tensors are a rank's shard, in place of the JAX package's
``put`` argument.

Host and device traffic: commitments (LDEs, Merkle levels) stay on the
device for the whole prove; the host sees Merkle caps (for the
transcript), opening values, the FRI final polynomial, the PoW result and
one batched gather of all query rows and paths at the end.  ``preprocess``
names the card by default and raises where there is none
(``device="cpu"`` asks for the plain versions); ``prove`` runs where the
``ProverData``'s tensors live.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..circuit.algebra import DeviceBaseAlgebra
from ..circuit.builder import CircuitData, Witness
from ..circuit.gates import absorb_quotient_generic
from ..ops import goldilocks as gl
from ..ops import goldilocks_ext as ge
from ..ops import host_field as hf
from ..ops import kernels
from ..ops import ntt as nttm
from ..ops import poseidon as pos
from . import fri as frim
from .merkle import MerkleTree, _levels_core, gather_rows_and_paths
from .profiler import Profiler
from .transcript import Challenger

P = gl.P

SHIFT = gl.MULTIPLICATIVE_GENERATOR  # LDE coset shift g = 7

_COMMIT_CHUNK = 16  # polys per transform pass (bounds the NTT scratch)


def scalar_f(v: int, device) -> torch.Tensor:
    """Host int -> shape-() field tensor on ``device``."""
    return gl.from_u64(np.uint64(int(v) % P), device)


def scalars_f(vs, device) -> torch.Tensor:
    """Host int list -> field tensor of shape (len,) on ``device``."""
    return gl.from_u64(np.array([int(v) % P for v in vs], dtype=np.uint64), device)


@dataclasses.dataclass
class CommitmentBatch:
    """A batch of polynomials committed together: one leaf per LDE point.

    On one device ``coeffs`` and ``lde`` hold every polynomial and point.  A
    rank's shard (``parallel/commit.py``) holds some of the coefficient rows,
    whose polynomial indices are ``rows`` (-1 for a padding row), and the
    LDE's points [lo, lo + L) of every polynomial; ``tree`` is then its part
    of the Merkle tree (``parallel/commit.py``)."""

    coeffs: torch.Tensor  # (num_polys, n)
    lde: torch.Tensor  # (num_polys, n << rate_bits)
    tree: MerkleTree
    rows: list | None = None  # a shard's coefficient rows: their polynomial indices

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


# ---------------------------------------------------------------------------
# Preprocessed data (proving/verification key halves)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ProverData:
    data: CircuitData
    pre_values: np.ndarray  # (num_pre, n) selectors ++ constants ++ sigmas
    pre_batch: CommitmentBatch
    kernels: dict = dataclasses.field(default_factory=dict)  # per-circuit tables and closures
    dev: dict = dataclasses.field(default_factory=dict)  # device-resident constants

    @property
    def device(self) -> torch.device:
        return self.pre_batch.lde.device


@dataclasses.dataclass
class VerifierKey:
    """What the verifier needs besides the circuit description."""

    pre_cap: np.ndarray  # (2^cap_height, 4) u64


def preprocess(data: CircuitData, device="cuda") -> tuple[ProverData, VerifierKey]:
    """Commit the circuit's tables on ``device``: the card by default (the call
    raises where there is none), the plain versions with ``device="cpu"``."""
    pre = np.concatenate([
        data.selectors.astype(np.uint64),
        data.constants.astype(np.uint64),
        data.sigma.astype(np.uint64),
    ])
    batch = commit_values(pre, data.config.rate_bits, data.config.cap_height, device=device)
    return prover_data(data, pre, batch), VerifierKey(pre_cap=batch.cap)


def prover_data(data: CircuitData, pre_values: np.ndarray, batch: CommitmentBatch) -> ProverData:
    """The ``ProverData`` of a committed preprocess, with the permutation's
    tables on the batch's device (``preprocess`` and the circuit cache)."""
    pd = ProverData(data=data, pre_values=pre_values, pre_batch=batch)
    nr = data.config.num_routed_wires
    dev = pd.device
    pd.dev["sigma"] = gl.from_u64(data.sigma[:nr], dev)
    pd.dev["omega_pows"] = nttm._powers_on(gl.primitive_root_of_unity(data.log_n), data.n, str(dev))
    pd.dev["k_shifts"] = gl.from_u64(data.k_shifts[:nr], dev)
    return pd


# ---------------------------------------------------------------------------
# Proof container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OpeningSet:
    """Opened values: {(batch_tag, row_offset): (num_polys, 2) u64 ext pairs}."""

    values: dict


@dataclasses.dataclass
class Proof:
    public_inputs: np.ndarray  # (num_pis,) u64
    wires_cap: np.ndarray
    zs_cap: np.ndarray
    quotient_cap: np.ndarray
    openings: OpeningSet
    fri_proof: "frim.FriProof"


# ---------------------------------------------------------------------------
# Domain helpers
# ---------------------------------------------------------------------------


def _lde_domain_u64(log_n: int, rate_bits: int) -> np.ndarray:
    """x values of the LDE coset: g * w^i, i < 2^(log_n+rate_bits)."""
    n_lde = 1 << (log_n + rate_bits)
    w = gl.primitive_root_of_unity(log_n + rate_bits)
    return hf.mul(np.uint64(SHIFT), hf.powers(w, n_lde))


def _zh_on_lde(log_n: int, rate_bits: int) -> np.ndarray:
    """Z_H(x) = x^n - 1 on the LDE coset (pattern of period 2^rate_bits)."""
    n = 1 << log_n
    n_lde = n << rate_bits
    gn = pow(SHIFT, n, P)
    wn = pow(gl.primitive_root_of_unity(log_n + rate_bits), n, P)  # order 2^rate
    pat = np.array([(gn * pow(wn, i, P) - 1) % P for i in range(1 << rate_bits)], dtype=np.uint64)
    return np.tile(pat, n_lde >> rate_bits)


def wire_offsets_used(data: CircuitData) -> list[int]:
    offs = {0}
    for g in data.gates:
        offs.update(g.wire_offsets)
    return sorted(offs)


_roll_lde = nttm.roll_lde  # the single shared definition


# ---------------------------------------------------------------------------
# Permutation argument
# ---------------------------------------------------------------------------


def _prefix_mul(ratio: torch.Tensor, n: int) -> torch.Tensor:
    """Inclusive prefix product along an (n,) field tensor.

    PyTorch has no scan over a modular product, so this is the doubling
    scan: ceil(log2 n) multiplications of the tensor by itself shifted.
    Multiplication mod p is exact and associative, so the values are those
    of the JAX package's two-level scan.
    """
    out = ratio
    shift = 1
    while shift < n:
        out = torch.cat([out[:shift], gl.mul(out[shift:], out[:-shift])])
        shift *= 2
    return out


def _perm_core(wires, sigma, omega_pows, k_shifts, beta_f, gamma_f, chunk_size: int):
    """Z and partial products for one (beta, gamma) challenge set.

    wires/sigma: (nr, n) field tensors; omega_pows: (n,); k_shifts: (nr,);
    beta_f/gamma_f: shape-() field tensors.  Returns the (m, n) field rows
    [Z, p_0, ..., p_{m-2}] evaluated on H: one batched (m, n) Fermat
    inversion, pairwise tree products over each chunk, a running product
    over the m rows and a prefix product along n.  The plain version of
    ``kernels.perm_z`` (csrc/field.cu ``perm_z_kernel`` and its scan and
    fix-up), on eager field ops: the CPU path.
    """
    nr, n = wires.shape
    cs = chunk_size
    m = nr // cs
    id_enc = gl.mul(k_shifts[:, None], omega_pows[None, :])
    num = gl.add(gl.add(wires, gl.mul(id_enc, beta_f)), gamma_f)
    den = gl.add(gl.add(wires, gl.mul(sigma, beta_f)), gamma_f)
    num_chunk = nttm.prod_field(num.reshape(m, cs, n), axis=1)
    den_chunk = nttm.prod_field(den.reshape(m, cs, n), axis=1)
    ratio = gl.mul(num_chunk, gl.inv(den_chunk))  # (m, n)
    # rat_pref[k] = prod_{i<=k} ratio_i
    rows = [ratio[0]]
    for k in range(1, m):
        rows.append(gl.mul(rows[-1], ratio[k]))
    rat_pref = torch.stack(rows)
    # Z(w^i) = prod_{j<i} row_ratio_j  (exclusive prefix product along n)
    pref = _prefix_mul(rat_pref[m - 1], n)
    z = torch.cat([gl.ones((1,), wires.device), pref[:-1]])
    # partials p_k = Z * rat_pref[k]
    rest = gl.mul(rat_pref[: m - 1], z[None, :])
    return torch.cat([z[None], rest])


def perm_rows_plain(wires, sigma, omega_pows, k_shifts, betas_f, gammas_f, chunk_size: int):
    """The plain version of ``kernels.perm_z``, on its arguments: the rows of
    ``_perm_core`` for each challenge j (betas_f[j], gammas_f[j]), one after
    another."""
    return torch.cat([_perm_core(wires, sigma, omega_pows, k_shifts, betas_f[j], gammas_f[j],
                                 chunk_size) for j in range(betas_f.shape[0])])


def permutation_polys(pd: ProverData, wires_dev, betas: list, gammas: list):
    """Field rows [Z_j, p_j0, ..., p_j(m-2)] of each challenge j (host ints
    betas[j], gammas[j]), one after another: shape (len(betas) * m, n) on
    the wires' device.  On the card: the three launches of csrc/field.cu's
    ``perm_z_kernel`` for all the challenges, straight into the rows that
    the Z commitment takes; a CPU tensor runs ``perm_rows_plain``."""
    cfg = pd.data.config
    dev = wires_dev.device
    args = (wires_dev[: cfg.num_routed_wires], pd.dev["sigma"], pd.dev["omega_pows"],
            pd.dev["k_shifts"])
    rows = kernels.perm_z if kernels.on_card(wires_dev) else perm_rows_plain
    return rows(*args, scalars_f(betas, dev), scalars_f(gammas, dev), cfg.permutation_chunk_size)


def compute_permutation_polys(pd: ProverData, wires_dev, beta: int, gamma: int):
    """Field rows [Z, p_0, ..., p_{m-2}] of shape (m, n) on the wires' device,
    for one challenge (as the JAX package's)."""
    return permutation_polys(pd, wires_dev, [beta], [gamma])


# ---------------------------------------------------------------------------
# Quotient (one closure per circuit, with its domain tables)
# ---------------------------------------------------------------------------


def perm_quotient_terms_plain(w_all, sigma_all, zs_lde, x_dev, l0, ks_dev, betas_f, gammas_f,
                              apows, cs: int, rate: int) -> list:
    """The permutation argument's terms of the quotient, one (n_lde,)
    accumulator a challenge j: sum_k apows[j][k] * term_k with term 0 =
    l0 * (Z_j - 1) and term 1 + k = chain_j[k+1] * prod(w + beta_j sigma +
    gamma_j) - chain_j[k] * prod(w + beta_j k_i x + gamma_j) over chunk k's
    cs routed columns, chain_j = [Z_j, its partials, Z_j at the next row].

    The plain version of ``kernels.perm_quotient`` (csrc/field.cu
    ``perm_quotient_kernel``), on eager field ops; the CPU path.
    """
    nr, n_lde = w_all.shape
    m = nr // cs
    num_challenges = len(apows)
    dev = w_all.device
    one = scalar_f(1, dev)
    accs = [gl.zeros((n_lde,), dev) for _ in range(num_challenges)]

    def absorb(j: int, idx: int, t):
        accs[j] = gl.add(accs[j], gl.mul(t, apows[j][idx]))

    chains = []
    for j in range(num_challenges):
        z = zs_lde[j * m]
        partials = [zs_lde[j * m + 1 + k] for k in range(m - 1)]
        chains.append([z] + partials + [_roll_lde(z, 1, rate)])
        absorb(j, 0, gl.mul(l0, gl.sub(z, one)))
    # permutation products a chunk of cs columns at a time: the
    # (cs, n_lde) products are freed before the next chunk's are made
    for k in range(m):
        sl = slice(k * cs, (k + 1) * cs)
        id_k = gl.mul(ks_dev[sl, None], x_dev[None, :])
        for j in range(num_challenges):
            n_k = gl.add(gl.add(w_all[sl], gl.mul(id_k, betas_f[j])), gammas_f[j])
            acc_n = nttm.prod_field(n_k, axis=0)
            del n_k
            d_k = gl.add(gl.add(w_all[sl], gl.mul(sigma_all[sl], betas_f[j])), gammas_f[j])
            acc_d = nttm.prod_field(d_k, axis=0)
            del d_k
            absorb(j, 1 + k, gl.sub(gl.mul(chains[j][k + 1], acc_d),
                                    gl.mul(chains[j][k], acc_n)))
        del id_k
    return accs


def split_gates(data: CircuitData) -> tuple:
    """The (selector index, gate) pairs of the circuit's gates that have
    constraints, as (generic, own): the generic gates, whose share
    ``kernels.generic_gate_quotient`` computes, and the gates with a kernel of
    their own (``Gate.absorb_quotient_device``)."""
    generic, own = [], []
    for gi, g in enumerate(data.gates):
        if g.num_constraints:
            (generic if g.name in kernels.GENERIC_GATES else own).append((gi, g))
    return generic, own


def generic_quotient_terms_plain(generic: list, A, wires, consts, pre_lde, lr_rows, pi_f,
                                 pi_cols, apows, accs, pi0: int, k0: int) -> list:
    """The public-input terms apows[j][pi0 + i] * lr_i * (w_{c_i} - pi_i)
    (c_i = pi_cols[i], host ints) and the share sel * sum_k apows[j][k0 + k]
    * C_k of each (selector index, gate) pair of ``generic``, added to
    ``accs`` (one (n_lde,) accumulator a challenge) one field operation at a
    time.  The plain version of ``kernels.generic_gate_quotient``
    (csrc/gates.cu ``generic_gate_quotient_kernel``), on eager field ops; the
    CPU path."""
    accs = list(accs)

    def absorb(j: int, idx: int, t):
        accs[j] = gl.add(accs[j], gl.mul(t, apows[j][idx]))

    for i, col in enumerate(pi_cols):
        t = gl.mul(lr_rows[i], gl.sub(wires(col), pi_f[i]))
        for j in range(len(accs)):
            absorb(j, pi0 + i, t)
    for gi, g in generic:
        s = pre_lde[gi]
        apow_rows = [apows[j][k0 : k0 + g.num_constraints] for j in range(len(accs))]
        accs[:] = absorb_quotient_generic(g, A, wires, consts, s, apow_rows, accs)
    return accs


def make_quotient_values(pd: ProverData, window: tuple | None = None):
    """The quotient's values on the LDE coset: a closure of (wires_lde,
    zs_lde, pre_lde, pi_f, betas_f, gammas_f, alphas) -> (num_challenges, L)
    field rows (the constraints' alpha-combination over Z_H), made once a
    circuit with its domain tables.

    ``window`` None: the whole domain, L = n_lde, the LDEs (rows, n_lde) and
    every neighbour read wrapping.  ``window`` (lo, halo, L): a shard's
    points [lo, lo + L), the LDEs its windows (rows, L + 2 halo) of the
    points [lo - halo, lo + L + halo) mod n_lde; the kernels run their window
    form on the middle L columns, and the plain versions run the eager code on
    the whole window (no neighbour read there wraps) and keep the middle."""
    data = pd.data
    cfg = data.config
    dev = pd.device
    n = data.n
    rate = cfg.rate_bits
    lo, halo, width = (0, 0, n << rate) if window is None else window
    n_lde = width + 2 * halo  # the columns of the tables and of the plain versions
    mid = slice(halo, halo + width)
    num_sel = len(data.gate_names)
    num_con = cfg.num_constants
    cs = cfg.permutation_chunk_size
    m = cfg.num_permutation_chunks
    nr = cfg.num_routed_wires
    num_pi = len(data.public_input_targets)
    max_con = max((g.num_constraints for g in data.gates), default=0)

    # Per-circuit domain tables, made once: the coset x, Z_H on it, and ONE
    # batched Fermat inversion over [Z_H, x - 1, x - w^r ...] on the device.
    x_host, zh_host = _lde_domain_u64(data.log_n, rate), _zh_on_lde(data.log_n, rate)
    if window is not None:
        cols = np.arange(lo - halo, lo + width + halo) % (n << rate)
        x_host, zh_host = x_host[cols], zh_host[cols]
    x_dev, zh = gl.from_u64(x_host, dev), gl.from_u64(zh_host, dev)
    n_inv = gl.h_inv(n)
    omega = gl.primitive_root_of_unity(data.log_n)
    pi_roots = [pow(omega, r, P) for (r, c) in data.public_input_targets]
    denoms = torch.stack([zh, gl.sub(x_dev, scalar_f(1, dev))]
                         + [gl.sub(x_dev, scalar_f(wr, dev)) for wr in pi_roots])
    inv_all = gl.inv(denoms)
    zh_inv = inv_all[0]
    l0 = gl.mul(gl.mul(zh, inv_all[1]), scalar_f(n_inv, dev))
    lr_rows = [gl.mul(gl.mul(zh, inv_all[2 + k]), scalar_f((wr * n_inv) % P, dev))
               for k, wr in enumerate(pi_roots)]
    # the public inputs' Lagrange rows as one (num_pi, n_lde) table, and their
    # wire columns, for the generic gates' kernel (on the host, where its plan
    # places them)
    lr_rows = torch.stack(lr_rows) if lr_rows else gl.zeros((0, n_lde), dev)
    pi_cols_host = [t.col for t in data.public_input_targets]
    pi_cols = torch.tensor(pi_cols_host, dtype=torch.int64)
    del denoms, inv_all
    ks_dev = gl.from_u64(np.asarray(data.k_shifts[:nr], dtype=np.uint64), dev)
    A = DeviceBaseAlgebra((n_lde,), dev)
    generic, own = split_gates(data)

    on_window = window is not None  # the kernels' window form

    def values(wires_win, zs_win, pre_win, pi_f, betas_f, gammas_f, alphas: list):
        card = kernels.on_card(wires_win)
        # the kernels compute the middle columns of the windows
        wires_lde, zs_lde, pre_lde = ((wires_win[:, mid], zs_win[:, mid], pre_win[:, mid])
                                      if card else (wires_win, zs_win, pre_win))
        x_k, l0_k, lr_k = (x_dev[mid], l0[mid], lr_rows[:, mid]) if card else (x_dev, l0, lr_rows)

        def wires(col, offset=0):
            return _roll_lde(wires_lde[col], offset, rate)

        def consts(i):
            return pre_lde[num_sel + i]

        w_all = wires_lde[:nr]
        sigma_all = pre_lde[num_sel + num_con : num_sel + num_con + nr]

        # The alpha-power-weighted combination is INCREMENTAL: each (n_lde,)
        # term (16 MB at 2^21) is consumed the moment it is produced and
        # freed, never all 1 + m + num_pi + max_con of them at once.
        # Exponents: permutation terms 0..m, public inputs, then one slot a
        # constraint index (shared across gates).
        # The powers of each host alpha (int) on the host, uploaded as one
        # (num_challenges, n_terms) table whose rows the kernels read.
        n_terms = 1 + m + num_pi + max_con
        apows = list(gl.from_u64(np.stack([hf.powers(a, n_terms) for a in alphas]), dev))

        # the permutation terms 0..m: one launch of csrc/field.cu for both
        # challenges on the card, the eager chain on the CPU
        if card:
            accs = list(kernels.perm_quotient(w_all, sigma_all, zs_lde, x_k, l0_k, ks_dev, betas_f,
                                              gammas_f, apows, cs, rate, window=on_window))
        else:
            accs = perm_quotient_terms_plain(w_all, sigma_all, zs_lde, x_dev, l0, ks_dev, betas_f,
                                             gammas_f, apows, cs, rate)

        # the public inputs 1+m.. and the generic gates from k0: one launch of
        # csrc/gates.cu on the card (in place), the eager loop on the CPU
        k0 = 1 + m + num_pi
        if card:
            kernels.generic_gate_quotient(generic, wires_lde, pre_lde, num_sel, num_con, lr_k,
                                          pi_f, pi_cols, apows, accs, 1 + m, k0)
        else:
            accs = generic_quotient_terms_plain(generic, A, wires, consts, pre_lde, lr_rows, pi_f,
                                                pi_cols_host, apows, accs, 1 + m, k0)

        for gi, g in own:
            s = pre_lde[gi]
            apow_rows = [apows[j][k0 : k0 + g.num_constraints] for j in range(cfg.num_challenges)]
            absorber = getattr(g, "absorb_quotient_device", None)
            if absorber is None and card and on_window:
                raise ValueError(f"gate {g.name!r} has no kernel for a shard's window")
            if absorber is not None and card:
                # the gate's own kernel: the same words as the generic loop
                accs[:] = absorber(wires_lde, consts, s, apow_rows, accs, rate, window=on_window)
            else:
                accs[:] = absorb_quotient_generic(g, A, wires, consts, s, apow_rows, accs)

        quotients = gl.mul(torch.stack(accs), (zh_inv[mid] if card else zh_inv)[None, :])
        return quotients if card or not on_window else quotients[:, mid]

    return values


def make_quotient_kernel(pd: ProverData):
    """The quotient's chunks in coefficient form: a closure of the arguments
    of ``make_quotient_values`` -> (num_challenges << rate_bits, n) field
    rows, each quotient split into 2^rate_bits chunks of degree < n."""
    values = make_quotient_values(pd)
    cfg = pd.data.config

    def kernel(*args):
        qc = nttm.coset_intt(values(*args), 0, SHIFT)  # (num_challenges, n_lde) coefficients
        return qc.reshape(cfg.num_challenges << cfg.rate_bits, pd.data.n)

    return kernel


def _get_kernel(pd: ProverData, name: str, factory):
    k = pd.kernels.get(name)
    if k is None:
        k = factory()
        pd.kernels[name] = k
    return k


# ---------------------------------------------------------------------------
# Openings: batched evaluation at ext points
# ---------------------------------------------------------------------------


def _open_core(coeffs, z_re_f, z_im_f):
    """Evaluate base-coefficient polys (batch, n) at k ext points.

    z_re_f/z_im_f: field tensors of shape (k,).  Returns (re, im) field
    tensors of shape (k, batch): value of poly b at point j.  One batch of
    ``open_batches``.
    """
    return open_batches([coeffs], z_re_f, z_im_f, [tuple(range(z_re_f.shape[0]))])[0]


def open_batches(coeffs: list, z_re_f, z_im_f, point_rows: list) -> list:
    """Each batch ``coeffs[b]`` (rows_b, n) at the points z[i], i in
    ``point_rows[b]``, of the (k,) field tensors z_re_f, z_im_f: one (re, im)
    pair of (len(point_rows[b]), rows_b) tensors a batch.  On the card this
    is csrc/field.cu's openings, one call for all the batches (the power
    table, the product, the slices' sum); a CPU tensor runs
    ``open_batches_plain``."""
    if kernels.on_card(z_re_f):
        return kernels.field_open(coeffs, z_re_f, z_im_f, point_rows)
    return open_batches_plain(coeffs, z_re_f, z_im_f, point_rows)


def open_batches_plain(coeffs: list, z_re_f, z_im_f, point_rows: list) -> list:
    """The plain version of ``open_batches``: ``_open_core_plain`` a batch."""
    out = []
    for c, rows_of in zip(coeffs, point_rows):
        idx = torch.tensor(list(rows_of), dtype=torch.int64, device=z_re_f.device)
        out.append(_open_core_plain(c, z_re_f[idx], z_im_f[idx]))
    return out


def _open_core_plain(coeffs, z_re_f, z_im_f):
    """The plain version of one batch's openings: for each point, its ext
    powers by log-doubling, then two products with the coefficients and two
    sums."""
    n = coeffs.shape[-1]
    outs_re, outs_im = [], []
    for j in range(z_re_f.shape[0]):
        zp_re, zp_im = ge.powers_device((z_re_f[j], z_im_f[j]), n)
        outs_re.append(nttm.sum_field(gl.mul(coeffs, zp_re), axis=-1))
        outs_im.append(nttm.sum_field(gl.mul(coeffs, zp_im), axis=-1))
    return torch.stack(outs_re), torch.stack(outs_im)


def open_table_plain(z_re_f, z_im_f, n: int) -> torch.Tensor:
    """The plain version of ``kernels.field_open_table``: the powers z_j^c, c
    < n, of each point as the rows 2j (real) and 2j + 1 (imaginary), zero to
    n_pad, each 32-column group's words split into 8 byte planes of 32 bytes,
    a plane's bytes in the product's order (``kernels.open_column``)."""
    k = z_re_f.shape[0]
    n_pad = -(-n // kernels.OPEN_KS) * kernels.OPEN_KS
    values = torch.zeros((2 * k, n_pad), dtype=torch.int64, device=z_re_f.device)
    for j in range(k):
        zp_re, zp_im = ge.powers_device((z_re_f[j], z_im_f[j]), n)
        values[2 * j, :n], values[2 * j + 1, :n] = zp_re, zp_im
    column = torch.tensor([kernels.open_column(p) for p in range(32)], device=values.device)
    by_position = values.view(2 * k, n_pad // 32, 32)[:, :, column].contiguous()
    planes = by_position.view(torch.uint8).view(2 * k, n_pad // 32, 32, 8).permute(0, 1, 3, 2)
    return planes.contiguous().view(torch.int64).reshape(2 * k, n_pad)


def eval_poly_ext_many(coeffs, z_exts: list):
    """Evaluate base-coefficient polynomials (batch, n) at host ext points.

    Returns ((k, batch) re, (k, batch) im) on the coefficients' device: the
    caller decides when to transfer.
    """
    return eval_poly_ext_batches([(coeffs, z_exts)])[0]


def eval_poly_ext_batches(items: list) -> list:
    """Each (coeffs (batch, n), host ext points) of ``items`` evaluated, in one
    call of ``open_batches``: the points' union goes to the device once, each
    batch reads its own.  Returns one ((k, batch) re, (k, batch) im) pair an
    item, on the coefficients' device."""
    union: dict = {}
    for _, z_exts in items:
        for z in z_exts:
            union.setdefault((int(z[0]), int(z[1])), len(union))
    dev = items[0][0].device
    z_re = scalars_f([z[0] for z in union], dev)
    z_im = scalars_f([z[1] for z in union], dev)
    rows = [tuple(union[(int(z[0]), int(z[1]))] for z in z_exts) for _, z_exts in items]
    return open_batches([c for c, _ in items], z_re, z_im, rows)


# ---------------------------------------------------------------------------
# Main prove: the transcript's phases, and their device side on one device
# ---------------------------------------------------------------------------


class Phases:
    """The device side of each phase of ``prove_with`` on one device: every
    polynomial and point of every batch on ``pd``'s device.  The sharded
    prover's ``Phases`` (``parallel/prover.py``) keeps a rank's shard and
    exchanges what the transcript needs; both hand the transcript the same
    host words."""

    def __init__(self, pd: ProverData):
        self.pd = pd
        self.device = pd.device
        cfg = pd.data.config
        self.rate, self.cap_h = cfg.rate_bits, cfg.cap_height

    def upload(self, wires_u64: np.ndarray) -> None:
        self.wires = gl.from_u64(wires_u64, self.device)

    def commit_wires(self) -> CommitmentBatch:
        return commit_field_values(self.wires, self.rate, self.cap_h)

    def permutation(self, betas: list, gammas: list) -> torch.Tensor:
        return permutation_polys(self.pd, self.wires, betas, gammas)

    def commit_values(self, values: torch.Tensor) -> CommitmentBatch:
        return commit_field_values(values, self.rate, self.cap_h)

    def quotient(self, wires: CommitmentBatch, zs: CommitmentBatch, pi_values, betas: list,
                 gammas: list, alphas: list) -> torch.Tensor:
        """The quotient's chunks (num_challenges << rate, n), coefficient form."""
        qk = _get_kernel(self.pd, "quotient", lambda: make_quotient_kernel(self.pd))
        dev = self.device
        return qk(wires.lde, zs.lde, self.pd.pre_batch.lde, scalars_f(pi_values, dev),
                  scalars_f(betas, dev), scalars_f(gammas, dev), alphas)

    def commit_coeffs(self, coeffs: torch.Tensor) -> CommitmentBatch:
        return commit_coeffs(coeffs, self.rate, self.cap_h)

    def open(self, items: dict) -> dict:
        """Each polynomial of each batch at its host ext points, ``items`` =
        {tag: (batch, points)}, in one call: {tag: ((k, num_polys) re, (k,
        num_polys) im)} on the device; ``to_host`` reads each."""
        values = eval_poly_ext_batches([(b.coeffs, pts) for b, pts in items.values()])
        return dict(zip(items, values))

    def to_host(self, batch: CommitmentBatch, values) -> tuple:
        """[device sync: the opening values] (re, im) u64 (k, num_polys)."""
        return gl.to_u64(values[0]), gl.to_u64(values[1])

    def fri_g(self, batches: dict, counts: dict, spec_tags: tuple, apow_f, y_f, z_f):
        """G on the whole LDE coset: (re, im) rows of n_lde words."""
        pd = self.pd
        gk = _get_kernel(pd, "fri_g", lambda: frim.make_g_kernel(pd, counts, len(spec_tags),
                                                                  spec_tags))
        return gk(tuple(batches[t].lde for t in frim.TAGS), apow_f, y_f, z_f)

    def batch_queries(self, batches: dict, idx: torch.Tensor) -> dict:
        """Each batch's leaf rows and Merkle paths at the query indices, on the
        device: {tag: (rows (q, num_polys), paths (q, depth, 4))}."""
        return {tag: gather_rows_and_paths(batches[tag].tree, idx) for tag in frim.TAGS}


def prove(pd: ProverData, witness: Witness, prof: Profiler | None = None) -> Proof:
    """One proof of ``pd``'s circuit for ``witness``, on ``pd``'s device.

    ``pd`` comes from this module's ``preprocess``.  ``prof`` records the
    phases' times when enabled (default: ``Profiler.current()``, enabled by
    ELP_PROFILE).
    """
    return prove_with(Phases(pd), witness, prof)


def prove_with(ph: Phases, witness: Witness, prof: Profiler | None = None) -> Proof:
    """The transcript's order of phases, each phase's device side run by
    ``ph``: the one-device ``prove`` and the sharded prover run this."""
    if prof is None:
        prof = Profiler.current()
    try:
        return _prove_phases(ph, witness, prof)
    finally:
        prof.close()  # the trace's open span, on an exception too


def _prove_phases(ph: Phases, witness: Witness, prof: Profiler) -> Proof:
    pd = ph.pd
    data = pd.data
    cfg = data.config
    prof.phase("witness_matrix")

    # 0. witness matrix + public input values (host -> device ONCE)
    wires_u64 = witness.full_matrix()  # (num_wires, n)
    pi_values = np.array(
        [witness.get(t) for t in data.public_input_targets], dtype=np.uint64
    ).reshape(-1)
    prof.phase("witness_upload")
    ph.upload(wires_u64)

    ch = Challenger(prof)
    ch.observe_cap(pd.pre_batch.cap)
    ch.observe_many([int(v) for v in pi_values])

    # 1. commit wires
    prof.phase("commit_wires")
    wires_batch = ph.commit_wires()
    with prof.span("device_read"):
        cap = wires_batch.cap  # [device sync: cap transfer]
    ch.observe_cap(cap)

    # 2. permutation challenges + Z/partials, one batch of rows a challenge set
    prof.phase("perm_polys")
    betas, gammas = [], []
    for _ in range(cfg.num_challenges):
        betas.append(ch.challenge())
        gammas.append(ch.challenge())
    zs_vals = ph.permutation(betas, gammas)
    prof.phase("commit_zs")
    zs_batch = ph.commit_values(zs_vals)
    with prof.span("device_read"):
        cap = zs_batch.cap  # [device sync]
    ch.observe_cap(cap)

    # 3. quotient
    prof.phase("quotient")
    alphas = [ch.challenge() for _ in range(cfg.num_challenges)]
    chunk_coeffs = ph.quotient(wires_batch, zs_batch, pi_values, betas, gammas, alphas)
    prof.phase("commit_quotient")
    quotient_batch = ph.commit_coeffs(chunk_coeffs)
    with prof.span("device_read"):
        cap = quotient_batch.cap  # [device sync]
    ch.observe_cap(cap)

    # 4. opening point + openings (one batched evaluation of all batches)
    prof.phase("openings")
    zeta = ch.challenge_ext()
    omega = gl.primitive_root_of_unity(data.log_n)

    def point_at(offset: int):
        wo = pow(omega, offset % (1 << data.log_n), P)
        return ge.h_mul(zeta, (wo, 0))

    point_specs = opening_point_specs(data)
    batches = {"P": pd.pre_batch, "W": wires_batch, "Z": zs_batch, "Q": quotient_batch}
    # group specs per batch tag, keeping spec order within the tag
    tag_offsets: dict[str, list[int]] = {}
    for tag, offset in point_specs:
        tag_offsets.setdefault(tag, []).append(offset)
    open_dev = ph.open({tag: (batches[tag], [point_at(o) for o in offs])
                        for tag, offs in tag_offsets.items()})
    openings = {}
    for tag, offs in tag_offsets.items():
        with prof.span("device_read"):
            re_u, im_u = ph.to_host(batches[tag], open_dev[tag])  # [device sync]
        for j, off in enumerate(offs):
            openings[(tag, off)] = np.stack([re_u[j], im_u[j]], axis=1)

    for tag, offset in point_specs:
        for row in openings[(tag, offset)]:
            ch.observe(int(row[0]))
            ch.observe(int(row[1]))

    # 5. FRI on the combined opening polynomial
    prof.phase("fri")
    fri_alpha = ch.challenge_ext()
    fri_proof = frim.fri_prove(
        pd, batches, openings, point_specs, zeta, fri_alpha, ch, prof=prof, phases=ph
    )
    prof.finish()

    return Proof(
        public_inputs=pi_values,
        wires_cap=wires_batch.cap,
        zs_cap=zs_batch.cap,
        quotient_cap=quotient_batch.cap,
        openings=OpeningSet(values=openings),
        fri_proof=fri_proof,
    )


def opening_point_specs(data: CircuitData) -> list[tuple[str, int]]:
    """Fixed order of (batch, row-offset) opening points."""
    specs = [("P", 0)]
    for off in wire_offsets_used(data):
        specs.append(("W", off))
    specs.append(("Z", 0))
    specs.append(("Z", 1))
    specs.append(("Q", 0))
    return specs
