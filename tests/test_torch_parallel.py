"""The port's ``parallel/`` on real process groups: D ranks (D in {1, 2, 4}),
one spawned process each, over gloo on the CPU, joined through a FileStore
under pytest's temporary directory (no port to race for).  Each rank runs
the distributed NTT (forward and inverse at log n 8 and 10), the distributed
coset LDE, the sharded commit at (16, 256) and ``prove_sharded`` of the
dryrun circuit; the parent holds every rank's results against the JAX
package's ``ops.ntt`` and ``prove.commit_values`` on the same seeded numpy
inputs, and the proofs against ``assets/dryrun/ref_proof.json`` (a JAX-package
proof) byte for byte.  The quotient's window form is walked shard by shard on
a circuit of SHA-256 and Poseidon rows.  Every comparison is exact."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from eth_lc_plonky2_tpu.ops import goldilocks as jgl
from eth_lc_plonky2_tpu.ops import ntt as jntt
from eth_lc_plonky2_tpu.prover import prove as jpr
from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.ops import kernels
from eth_lc_plonky2_tpu_torch.parallel import commit as pcommit
from eth_lc_plonky2_tpu_torch.parallel import ntt as pntt
from eth_lc_plonky2_tpu_torch.parallel import prover as pprover
from eth_lc_plonky2_tpu_torch.prover import prove as pr
from torch_parallel_ranks import CAP, LDE_RATE, NTT_CASES, RATE, failing_rank, inputs, run_ranks

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = (1, 2, 4)


@pytest.fixture(scope="module", params=RANKS)
def ranks(request, tmp_path_factory):
    size = request.param
    store = str(tmp_path_factory.mktemp(f"store{size}") / "store")
    return size, run_ranks(size, store, from_env=size == 1)


def _jax(u64):
    return jgl.from_u64(u64)


@pytest.mark.parametrize("log_n,inverse", NTT_CASES)
def test_dist_ntt_equals_the_jax_packages(ranks, log_n, inverse):
    size, res = ranks
    want = jgl.to_u64(jntt.ntt(_jax(inputs()["ntt"][log_n]), inverse=inverse))
    for r in range(size):
        assert np.array_equal(res[r][("ntt", log_n, inverse)], want), r


def test_dist_coset_lde_equals_the_jax_packages(ranks):
    size, res = ranks
    want = jgl.to_u64(jntt.coset_lde(_jax(inputs()["lde"]), LDE_RATE))
    for r in range(size):
        assert np.array_equal(res[r]["lde"], want), r


def test_sharded_commit_equals_the_jax_packages(ranks):
    size, res = ranks
    ref = jpr.commit_values(inputs()["commit"], RATE, CAP)
    for r in range(size):
        lde, leaves, cap, in_window = res[r]["commit"]
        assert np.array_equal(lde, jgl.to_u64(ref.lde))
        assert np.array_equal(leaves, jgl.to_u64(ref.tree.levels[0]))
        assert np.array_equal(cap, ref.cap) and in_window


def test_sharded_proof_equals_the_committed_reference_and_verifies(ranks):
    size, res = ranks
    with open(os.path.join(REPO, "assets", "dryrun", "ref_proof.json")) as f:
        text = f.read()
    for r in range(size):
        assert res[r]["proof"] == text, r  # byte for byte; each rank verified its proof
        assert res[r]["world"] == (size, r) and res[r]["backend"] == "gloo"


def test_mesh_moves_bit_patterns(ranks):
    """broadcast and all_gather move int64 words with the sign bit set as
    they are, in rank order."""
    size, res = ranks
    words = [[(-1 << 63) + 10 * r + i for i in range(4)] for r in range(size)]
    for r in range(size):
        assert res[r]["broadcast"] == words[0] and res[r]["gather"] == words
        assert res[r]["multiprocess"] == (size > 1)


@pytest.mark.parametrize("ranks", [1], indirect=True)
def test_initialize_reads_the_elp_variables(ranks):
    """The one-rank group is started from ELP_COORDINATOR, ELP_NUM_PROCESSES
    and ELP_PROCESS_ID alone (``initialize`` without arguments)."""
    size, res = ranks
    assert size == 1 and res[0]["world"] == (1, 0) and res[0]["backend"] == "gloo"


# ---------------------------------------------------------------------------
# What the mesh refuses
# ---------------------------------------------------------------------------


class _Ranks:
    """A mesh's size and rank, without a process group: what the plans read
    before any exchange."""

    def __init__(self, size, rank=0):
        self.size, self.rank, self.device = size, rank, torch.device("cpu")

    def block(self, n):
        return slice(self.rank * n // self.size, (self.rank + 1) * n // self.size)


@pytest.mark.parametrize("size,n", [(3, 1 << 10), (4, 8), (2, 2), (8, 32)])
def test_three_ranks_and_short_transforms_raise(size, n):
    with pytest.raises(ValueError):
        pntt.make_dist_ntt(_Ranks(size), n)


def test_the_commit_and_the_prover_refuse_three_ranks():
    with pytest.raises(ValueError):
        pcommit.make_sharded_commit(_Ranks(3), RATE, CAP)
    with pytest.raises(ValueError):
        pcommit.make_sharded_commit(_Ranks(32), RATE, CAP)  # more ranks than cap rows
    data, _ = chip_smoke.dryrun_circuit()
    for size in (3, 16):
        with pytest.raises(ValueError):
            pprover._check_mesh(data, _Ranks(size))


@pytest.mark.parametrize("how", ["raise", "exit"])
def test_a_failed_rank_fails_the_collection_at_once(how):
    """A rank that raises, or exits without its results, ends the wait well
    before the deadline, and no rank is left running."""
    import time

    from eth_lc_plonky2_tpu_torch.parallel import distributed as dist

    procs, queue = dist.spawn_ranks(failing_rank, 2, (how,))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exit codes"):
        dist.collect_ranks(procs, queue, timeout_s=600)
    assert time.monotonic() - t0 < 60
    assert not any(p.is_alive() for p in procs)


def test_initialize_without_a_card_raises():
    from eth_lc_plonky2_tpu_torch.parallel import distributed as dist

    if torch.cuda.is_available():
        pytest.skip("this test is for a machine without a card")
    with pytest.raises(RuntimeError):
        dist.initialize("tcp://localhost:1", 1, 0)
    with pytest.raises(ValueError):
        dist.initialize(num_processes=None, process_id=None, device="cpu")


# ---------------------------------------------------------------------------
# The quotient's window form, walked shard by shard on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sha_poseidon():
    """A circuit of SHA-256 rows (neighbour offsets down to -16) and Poseidon
    rows, its wires and Z committed, and its whole quotient on one device."""
    data, w, _, _ = chip_smoke.light_client_circuit(1, 6, 3)
    pd, _ = pr.preprocess(data, device="cpu")
    ph = pr.Phases(pd)
    ph.upload(w.full_matrix())
    wires = ph.commit_wires()
    rng = np.random.default_rng(5)
    betas, gammas, alphas = ([int(v) for v in rng.integers(0, gl.P, 2, dtype=np.uint64)]
                             for _ in range(3))
    zs = ph.commit_values(ph.permutation(betas, gammas))
    pis = np.array([w.get(t) for t in data.public_input_targets], dtype=np.uint64)
    args = (pr.scalars_f(pis, "cpu"), pr.scalars_f(betas, "cpu"), pr.scalars_f(gammas, "cpu"), alphas)
    whole = pr.make_quotient_values(pd)(wires.lde, zs.lde, pd.pre_batch.lde, *args)
    return data, pd, (wires.lde, zs.lde, pd.pre_batch.lde), args, whole


@pytest.mark.parametrize("size", [2, 4])
def test_window_walk_equals_the_whole_quotient(sha_poseidon, size):
    data, pd, ldes, args, whole = sha_poseidon
    assert min(pr.wire_offsets_used(data)) == -16 and {"sha256", "poseidon"} <= {
        g.name for g in data.gates}
    n_lde = ldes[0].shape[1]
    width, halo = n_lde // size, pprover.halo_points(data)
    assert halo == 16 << data.config.rate_bits
    parts = []
    for r in range(size):
        cols = torch.arange(r * width - halo, (r + 1) * width + halo) % n_lde
        windows = [t.index_select(1, cols) for t in ldes]
        parts.append(pr.make_quotient_values(pd, (r * width, halo, width))(*windows, *args))
        assert parts[-1].shape == (2, width)
    assert torch.equal(torch.cat(parts, dim=1), whole)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("rate", [1, 3])
def test_sha_window_plan_stages_the_words_neighbour_columns_names(size, rate):
    """The SHA-256 gate's window form on rank r's points [lo, lo + L) of an
    n_lde-point domain: column c of the plan (negative in the halo) is the
    window's column H + c, i.e. the domain's (lo + c) mod n_lde; every staged
    read of a live thread must be the column ``neighbour_columns`` names."""
    n_lde = 1 << 12
    width = n_lde // size
    plan = kernels.sha_gate_plan(width, rate, window=True)
    assert plan["mask"] == -1
    for r in range(size):
        lo = r * width
        for _, halo_key, _, raw, signed in _sha_groups():
            halo = plan[halo_key]
            want = {k: kernels.neighbour_columns(n_lde, -k, rate) for k in raw + signed}
            for block in range(plan["blocks"]):
                staged = kernels.staged_columns(plan, block, halo)
                assert int(staged.min()) >= -halo and int(staged.max()) <= width - 1
                x0 = block * plan["tile"]
                t = torch.arange(min(plan["tile"], width - x0))
                for k in want:
                    got = (lo + staged[t + halo - k * plan["step"]]) % n_lde
                    assert torch.equal(got, want[k][lo + x0 + t]), (r, block, k)


def _sha_groups():
    """The SHA-256 gate's bit groups: first wire, halo key, sign key, raw and
    signed row offsets (tests/test_torch_gate_kernels.py's SHA_GROUPS)."""
    from eth_lc_plonky2_tpu_torch.circuit import gates_sha256 as gsha

    return ((gsha.A_BITS, "halo_ae", "signs_ae", (0, 1, 2, 3), (1,)),
            (gsha.E_BITS, "halo_ae", "signs_ae", (0, 1, 2, 3), (1,)),
            (gsha.W_BITS, "halo_w", "signs_w", (0,), (2, 15)))
