"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and nvcc, and skip elsewhere.  On the card, where
there is no jax, run them without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.ops import kernels, ntt, poseidon as pos
from eth_lc_plonky2_tpu_torch.prover import merkle, prove

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    kernels.build()
    return "cuda"


def _rand(shape, seed):
    x = np.random.default_rng(seed).integers(0, gl.P, size=shape, dtype=np.uint64)
    x.reshape(-1)[0] = gl.P - 1
    return x


@pytest.mark.parametrize("log_n", [1, 4, 11, 12, 15])
def test_ntt_kernel_matches_plain(dev, log_n):
    t = gl.from_u64(_rand((5, 1 << log_n), log_n), dev)
    before = kernels.launches["ntt"]
    assert torch.equal(ntt.ntt(t), ntt.ntt_plain(t))
    assert torch.equal(ntt.intt(t), ntt.ntt_plain(t, inverse=True))
    assert torch.equal(ntt.coset_lde(t, 3), ntt.coset_lde_plain(t, 3, 7))
    assert torch.equal(ntt.coset_lde(t, 1), ntt.coset_lde_plain(t, 1, 7))
    assert torch.equal(ntt.coset_intt(t, 0), ntt.coset_intt_plain(t, 7))
    assert kernels.launches["ntt"] > before


@pytest.mark.parametrize("length", [4, 8, 20, 184])
@pytest.mark.parametrize("n", [1, 513, 2049])
def test_sponge_kernel_matches_plain(dev, length, n):
    t = gl.from_u64(_rand((length, n), length + n), dev)
    before = kernels.launches["poseidon"]
    assert torch.equal(pos.hash_no_pad(t.T), pos._hash_plain(t.T))
    level = gl.from_u64(_rand((2 * n, 4), n), dev)
    assert torch.equal(pos.compress_level(level), pos._hash_plain(level.reshape(-1, 8)))
    assert kernels.launches["poseidon"] == before + 2


@pytest.mark.parametrize("cap_height", [0, 4])
@pytest.mark.parametrize("n", [16, 32, 2048, 4096])
def test_tree_with_one_launch_tail_matches_cpu(dev, n, cap_height):
    leaves = _rand((n, 5), n + cap_height)
    before = kernels.launches["poseidon"]
    card = merkle.build_merkle(leaves, cap_height)
    host = merkle.build_merkle(leaves, cap_height, device="cpu")
    assert len(card.levels) == len(host.levels)
    for a, b in zip(card.levels, host.levels):
        assert torch.equal(a.cpu(), b)
    # one launch for the leaves, one a large level, one for all the small ones
    large = sum(1 for lv in host.levels[1:] if lv.shape[0] > pos.TAIL_MAX_PAIRS)
    assert kernels.launches["poseidon"] == before + 1 + large + (len(host.levels) > 1 + large)


def test_commitment_on_card_matches_cpu(dev):
    vals = _rand((20, 1 << 12), 9)
    card = prove.commit_values(vals, 3, 4)  # the card is the default
    host = prove.commit_values(vals, 3, 4, device="cpu")
    assert card.lde.device.type == dev and host.lde.device.type == "cpu"
    assert torch.equal(card.lde.cpu(), host.lde)
    assert np.array_equal(card.cap, host.cap)
    tree = merkle.build_merkle(vals[:16, :8].copy(), 2)
    assert tree.levels[0].device.type == dev
    assert np.array_equal(tree.cap, merkle.build_merkle(vals[:16, :8].copy(), 2, device="cpu").cap)


FIELD_OPS = {"add": (gl.add, gl.add_plain), "sub": (gl.sub, gl.sub_plain),
             "mul": (gl.mul, gl.mul_plain)}


@pytest.mark.parametrize("op", sorted(FIELD_OPS))
@pytest.mark.parametrize("n", [1, 1023, 1 << 16])
def test_field_kernel_matches_plain(dev, op, n):
    kernel, plain = FIELD_OPS[op]
    a = gl.from_u64(_rand((6, n), n), dev)
    b = gl.from_u64(_rand((6, n), n + 1), dev)
    before = kernels.launches["field"]
    pairs = [(a, b), (a, b[2, 0]), (a[0, 0], b), (a, b[:1]), (a, b[:, :1]), (a[:1], b[:, :1]),
             (a, b[3]), (a[:, ::2], b[:, ::2]), (a[::2], b[1::2]),
             (a.reshape(2, 3, n), b[:3, :1]), (a.T[:, :1], b.T[:, 1:2])]
    launched = 0
    for u, v in pairs:
        out = kernel(u, v)
        assert torch.equal(out, plain(u, v))
        launched += out.numel() > 0  # an empty result (n = 1, odd columns) needs no launch
    assert kernels.launches["field"] == before + launched


def test_field_inverse_and_edge_words(dev):
    p = gl.P
    edge = np.array([0, 1, 2, p - 1, p - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, 1 << 63,
                     (1 << 63) - 1, p >> 1, (p >> 1) + 1, 0xFFFF_FFFF_0000_0000], dtype=np.uint64)
    ea = gl.from_u64(np.repeat(edge, len(edge)), dev)
    eb = gl.from_u64(np.tile(edge, len(edge)), dev)
    for kernel, plain in FIELD_OPS.values():
        assert torch.equal(kernel(ea, eb), plain(ea, eb))
    x = gl.from_u64(np.concatenate([edge, _rand((4096,), 3)]), dev)
    inv = gl.inv(x)
    assert torch.equal(inv, gl.inv_plain(x))
    assert torch.equal(gl.mul(inv, x), (x != 0).to(torch.int64))
    assert torch.equal(gl.neg(x), gl.sub_plain(torch.zeros_like(x), x))
    assert torch.equal(gl.mul_small(x, 7), gl.mul_plain(x, torch.full_like(x, 7)))
    with pytest.raises(ValueError):
        gl.mul(x, x.cpu())  # a CUDA tensor never falls back to the plain version


def test_dryrun_proof_on_card_matches_reference(dev):
    import json
    import os

    import chip_smoke

    data, witness = chip_smoke.dryrun_circuit()
    pd, vk = prove.preprocess(data)  # the card is the default
    assert pd.device.type == dev
    before = dict(kernels.launches)
    got = chip_smoke.proof_dict(prove.prove(pd, witness))
    assert all(kernels.launches[k] > before[k] for k in ("ntt", "poseidon", "field"))
    assert kernels.launches["gates"] == before["gates"] + 1  # the generic gates' one launch
    with open(os.path.join(chip_smoke.REPO, "assets", "dryrun", "ref_proof.json")) as f:
        assert chip_smoke.first_difference(got, json.load(f)) is None
    from unittest import mock

    before = dict(kernels.launches)
    with mock.patch.object(kernels, "on_card", lambda t: False):  # plain versions on the card
        plain_pd = prove.ProverData(data=data, pre_values=pd.pre_values, pre_batch=pd.pre_batch,
                                    dev=pd.dev)
        assert chip_smoke.proof_dict(prove.prove(plain_pd, witness)) == got
    assert kernels.launches == before


@pytest.mark.parametrize("n_lde", [1 << 7, 1 << 8, 1 << 9, 1 << 12])
@pytest.mark.parametrize("gate_name", ["sha256", "poseidon"])
def test_gate_kernel_matches_generic_loop(dev, gate_name, n_lde):
    """csrc/gates.cu against the generic eval loop on the plain ops, on random
    field words with the edge words among them; at n_lde = 2^7 and rate 2^3
    offset -16 wraps around the start of the domain, 2^8 is one tile of the
    SHA-256 kernel and 2^9 the smallest domain where its w halo lies in
    another block.  The kernel adds to copies of the accumulators in place."""
    import chip_smoke
    from eth_lc_plonky2_tpu_torch.circuit import gates

    gate = gates.gate_from_spec({"type": gate_name})
    inputs = chip_smoke.gate_inputs(np.random.default_rng(n_lde), n_lde, gate.num_constraints)
    accs = [a.clone() for a in inputs[4]]
    before = dict(kernels.launches)
    got = chip_smoke.gate_kernel(gate, inputs, 3, accs)
    assert kernels.launches["gates"] == before["gates"] + 1
    assert kernels.launches["field"] == before["field"]
    assert all(new is acc for new, acc in zip(got, accs))  # updated in place and returned
    want = chip_smoke.gate_generic(gate, inputs, 3, plain=True)
    on_field_kernel = chip_smoke.gate_generic(gate, inputs, 3, plain=False)
    for j in range(2):
        assert torch.equal(got[j], want[j]) and torch.equal(on_field_kernel[j], want[j])
    with pytest.raises(ValueError):
        chip_smoke.gate_kernel(gate, (inputs[0][:, ::2], *inputs[1:]), 3)
    with pytest.raises(ValueError):  # one accumulator twice
        chip_smoke.gate_kernel(gate, inputs, 3, [accs[0], accs[0]])


def test_sha_and_poseidon_proof_on_card_verifies(dev):
    """A proof of SHA-256 and Poseidon rows made on the card: three launches of
    csrc/gates.cu (the two gates and the generic gates), equal to the proof on
    the plain versions, accepted by the port's verifier; a forged witness of
    either gate is rejected."""
    import chip_smoke
    from eth_lc_plonky2_tpu_torch.prover.verify import VerificationError, verify

    data, witness, leaves, first_state = chip_smoke.light_client_circuit(1, 3, 5)
    pd, vk = prove.preprocess(data)
    before = kernels.launches["gates"]
    proof = prove.prove(pd, witness)
    assert kernels.launches["gates"] == before + 3
    verify(data, vk, proof)
    chip_smoke.check_light_client_outputs(proof, leaves, first_state, 3, "card test")
    got = chip_smoke.prove_kernels_and_plain(torch, pd, witness, "card test",
                                             ("ntt", "poseidon", "field", "gates"))
    assert got == chip_smoke.proof_dict(proof)
    for gate_name in ("sha256", "poseidon"):
        forged = chip_smoke.forged_witness(data, witness, gate_name)
        with pytest.raises(VerificationError):
            verify(data, vk, prove.prove(pd, forged))


# phase 7's offsets, then more for batches of more points than an entry holds
OPEN_OFFSETS = (0, -1, -2, -3, -4, -7, -15, -16, 2, 3, 5, 6, 9, 10, 11, 13)


@pytest.mark.parametrize("zeta", ["seeded", "edge"])
@pytest.mark.parametrize("k", [1, 8, 12, 16])
@pytest.mark.parametrize("log_n", [4, 12, 18])
def test_field_open_kernel_matches_plain(dev, log_n, k, zeta):
    """The openings' kernels (the power table, the product on the int8 tensor
    cores, the slices' sum) against the plain openings on the card, one call
    for a table of three batches: 37 rows read through a row stride wider
    than n, 20 and 5 rows (none a multiple of 16), points zeta * omega^o at
    phase 7's offsets and Z's next row, shared between batches through the
    table's union, edge words in the coefficients and, for "edge", in zeta.
    With more than 8 points the first batch spans two entries and the table
    is taken three times, 12 entries in two launches of the product."""
    import chip_smoke
    from eth_lc_plonky2_tpu_torch.ops import goldilocks_ext as ge

    rng = np.random.default_rng(log_n * 10 + k)
    n, p = 1 << log_n, gl.P
    wide = _rand((37, n + 8), log_n + k)
    edge = chip_smoke.field_edge_words()
    wide[:, : min(n, len(edge))] = edge[: min(n, len(edge))]
    coeffs = [gl.from_u64(wide, dev)[:, :n], gl.from_u64(_rand((20, n), 1), dev),
              gl.from_u64(_rand((5, n), 2), dev)]
    z = ((p - 1, 1 << 63) if zeta == "edge"
         else tuple(int(v) for v in rng.integers(0, p, size=2, dtype=np.uint64)))
    omega = gl.primitive_root_of_unity(log_n)
    points = [ge.h_mul(z, (pow(omega, o % n, p), 0)) for o in OPEN_OFFSETS[:k] + (1,)]
    z_re = gl.from_u64([q[0] for q in points], dev)
    z_im = gl.from_u64([q[1] for q in points], dev)
    point_rows = [tuple(range(k)), (0, k), (k,)]
    if k > kernels.OPEN_MAX_POINTS:
        coeffs, point_rows = coeffs * 3, point_rows * 3
    plans = kernels.field_open_plans([c.shape[0] for c in coeffs], point_rows, n)
    assert len(plans) == (1 if k <= kernels.OPEN_MAX_POINTS else 2)
    before = kernels.launches["field"]
    got = kernels.field_open(coeffs, z_re, z_im, point_rows)
    assert kernels.launches["field"] == before + 1 + sum(p["launches"] - 1 for _, p in plans)
    want = chip_smoke.on_plain(lambda: prove.open_batches_plain(coeffs, z_re, z_im, point_rows))
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])


@pytest.mark.parametrize("n", [1, 2, 63, 64, 100, 1 << 18])
def test_field_open_table_kernel_matches_plain(dev, n):
    """field_open_table_kernel against its plain version: the byte planes of
    the powers of 3 points (one an edge point) over n columns, zero to the
    padding, in the product's order; one launch."""
    pts = [(gl.P - 1, 1 << 63), (0, 1), tuple(int(v) for v in _rand((2,), n))]
    z_re = gl.from_u64([q[0] for q in pts], dev)
    z_im = gl.from_u64([q[1] for q in pts], dev)
    before = kernels.launches["field"]
    got = kernels.field_open_table(z_re, z_im, n)
    assert kernels.launches["field"] == before + 1
    assert torch.equal(got, prove.open_table_plain(z_re, z_im, n))


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("log_n_lde", [7, 12, 15, 21])
def test_perm_quotient_kernel_matches_plain(dev, log_n_lde, window):
    """perm_quotient_kernel against the plain permutation terms on the card:
    80 routed rows of a 184-row LDE, 80 sigma rows of a 92-row preprocessed
    LDE (real row strides), random and edge words; at 2^7 the next row of
    every column in the last 2^3 wraps to the start; 2^21 is the main path's.
    The window form: rank 0's half of the domain, on views at the halo's
    offset of windows whose halo holds the next row, against the plain
    version on the whole window cut to the middle."""
    import chip_smoke

    inputs = chip_smoke.perm_inputs(np.random.default_rng(log_n_lde), log_n_lde)
    before = kernels.launches["field"]
    if not window:
        got = chip_smoke.perm_terms(inputs)
        assert kernels.launches["field"] == before + 1
        assert torch.equal(got, chip_smoke.perm_terms(inputs, plain=True))
        return
    width = (1 << log_n_lde) // 2
    h = min(chip_smoke.WINDOW_HALO, width)
    w_all, sigma, zs, x, l0 = (chip_smoke.windows_of(t, 0, width, h) for t in inputs[:5])
    mid = slice(h, h + width)
    got = kernels.perm_quotient(w_all[:, mid], sigma[:, mid], zs[:, mid], x[mid], l0[mid],
                                *inputs[5:], window=True)
    assert kernels.launches["field"] == before + 1
    want = chip_smoke.on_plain(lambda: prove.perm_quotient_terms_plain(w_all, sigma, zs, x, l0,
                                                                      *inputs[5:]))
    assert torch.equal(got, torch.stack(want)[:, mid])


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("log_n_lde,past_visit,num_pi", [(7, 0, 12), (7, 3, 12), (12, 3, 16),
                                                        (12, 3, 64), (21, 0, 12), (21, 0, 16)])
def test_generic_gate_kernel_matches_plain(dev, log_n_lde, past_visit, num_pi, window):
    """generic_gate_quotient_kernel against the plain generic loop with the
    public inputs on the card: phase 7's gates and 12, 16 (the flagship's: a
    ring of 3 stages) or 64 (tiles of 128 columns) public inputs (some at
    columns past the 80 the gates visit, two of those in one column), rows of
    a (184, n_lde) wires LDE and a (92, n_lde) preprocessed LDE, random and
    edge words; the accumulators are updated in place.  The window form:
    views at the halo's offset of rank 0's windows."""
    import chip_smoke

    inp = chip_smoke.generic_inputs(np.random.default_rng(log_n_lde), 1 << log_n_lde, past_visit,
                                    num_pi)
    want = chip_smoke.generic_terms(inp, "plain")
    accs = [a.clone() for a in inp["accs"]]
    wires, pre, lr = inp["wires"], inp["pre"], inp["lr"]
    if window:
        width = (1 << log_n_lde) // 2
        h = min(chip_smoke.WINDOW_HALO, width)
        mid = slice(h, h + width)
        wires, pre, lr = (chip_smoke.windows_of(t, 0, width, h)[:, mid] for t in (wires, pre, lr))
        want, accs = want[:, :width], [a[:width].clone() for a in accs]
    before = dict(kernels.launches)
    kernels.generic_gate_quotient(inp["generic"], wires, pre, inp["num_sel"], inp["num_con"], lr,
                                  inp["pi"], inp["pi_cols"], inp["apows"], accs, inp["pi0"],
                                  inp["k0"])
    assert kernels.launches["gates"] == before["gates"] + 1
    assert kernels.launches["field"] == before["field"]
    assert torch.equal(torch.stack(accs), want)


@pytest.mark.parametrize("num_specs", [5, 12])
@pytest.mark.parametrize("log_n_lde", [7, 12, 21])
def test_fri_g_kernel_matches_plain(dev, log_n_lde, num_specs):
    """fri_g_kernel against the plain G on the card: phase 7's batches (92,
    184, 20, 16 rows), 5 or 12 specs, one norm zero at one column, edge
    words; one tile of 2^7 columns, or tiles of G_TILE walked by persistent
    blocks; one launch."""
    import chip_smoke

    inp = chip_smoke.g_inputs(np.random.default_rng(log_n_lde + num_specs), log_n_lde, num_specs)
    before = kernels.launches["field"]
    got = chip_smoke.g_terms(inp)
    assert kernels.launches["field"] == before + 1
    assert torch.equal(got, chip_smoke.g_terms(inp, "plain"))


def test_fri_fold_kernel_matches_plain(dev):
    """fri_fold_kernel against the plain fold at every layer size 2^1 to
    2^21, one launch each."""
    import chip_smoke

    rng = np.random.default_rng(21)
    for log_size in range(1, 22):
        inp = chip_smoke.fold_inputs(rng, log_size)
        before = kernels.launches["field"]
        got = chip_smoke.fold_terms(inp)
        assert kernels.launches["field"] == before + 1
        assert torch.equal(got, chip_smoke.fold_terms(inp, "plain")), log_size


@pytest.mark.parametrize("op", sorted(FIELD_OPS))
@pytest.mark.parametrize("n", [1, 2, 3, 1023, 1 << 16, (1 << 16) + 1])
def test_field_kernel_views_match_plain(dev, op, n):
    """field_binary_kernel against the plain op on the views the prover
    gives it: runs of odd and even length, views at an odd word offset, one
    word broadcast (at an even or odd offset), strided views, rows of a
    wider array; one launch each."""
    kernel, plain = FIELD_OPS[op]
    a = gl.from_u64(_rand((2 * n + 4,), n), dev)
    b = gl.from_u64(_rand((2 * n + 4,), n + 1), dev)
    wide = gl.from_u64(_rand((4, n + 2), n + 2), dev)
    pairs = [(a[:n], b[:n]), (a[:n], b[1]), (a[3], b[:n]), (a[2:n + 2], b[2:n + 2]),
             (a[:n], b[5:6].expand(n)), (a[1:n + 1], b[1:n + 1]), (a[:n], b[1:n + 1]),
             (a[1:n + 1], b[0]), (a[:2 * n:2], b[1:2 * n + 1:2]), (wide[:, :n], wide[:, 1:n + 1])]
    before = kernels.launches["field"]
    for u, v in pairs:
        assert torch.equal(kernel(u, v), plain(u, v)), (u.shape, u.stride(), v.stride())
    assert kernels.launches["field"] == before + len(pairs)


@pytest.mark.parametrize("log_n,challenges,routed,chunk", [
    (log_n, challenges, 80, 8) for log_n in (4, 8, 12, 18) for challenges in (1, 2)] + [
    (12, 2, 256, 4), (14, 2, 256, 4), (12, 1, 256, 4), (12, 2, 128, 8)])
def test_perm_z_kernel_matches_plain(dev, log_n, challenges, routed, chunk):
    """perm_z_kernel, its scan and its fix-up against the plain permutation
    rows: 80 routed rows of a 184-row wires matrix, chunk 8, edge words, a
    zero den chunk of each challenge (the grand product ends there); 2^4 is
    less than a block, 2^8 one block, 2^18 the flagship's 1,024 blocks.  Also
    256 routed wires in chunks of 4 (m = 64: blocks of 32 columns; 2^14 is
    512 blocks) and 128 in chunks of 8 (blocks of 128)."""
    import chip_smoke

    n = 1 << log_n
    m = routed // chunk
    zeros = ((0, 1, n // 3),) + (((1, m - 1, n - 2),) if challenges == 2 else ())
    inputs = chip_smoke.perm_z_inputs(np.random.default_rng(log_n), log_n, zeros, routed, chunk)
    if challenges == 1:
        inputs = inputs[:4] + (inputs[4][:1], inputs[5][:1], inputs[6])
    before = kernels.launches["field"]
    got = chip_smoke.perm_rows(inputs)
    assert kernels.launches["field"] == before + 3
    assert got.shape == (m * challenges, n)
    assert torch.equal(got, chip_smoke.perm_rows(inputs, "plain"))
    assert int(got[0, -1]) == 0 and int(got[0, 0]) == 1


@pytest.mark.parametrize("n", [1, 7, 8, 9, 1023, 4097, 1 << 21])
def test_field_inv_kernel_runs_match_plain(dev, n):
    """field_inv_kernel's runs of 16 words against the plain inverse at
    lengths inside one run, one tile and many, zeros at every place of a run
    (``chip_smoke.inverse_words``); one launch."""
    import chip_smoke

    x = gl.from_u64(chip_smoke.inverse_words(np.random.default_rng(n), n), dev)
    before = kernels.launches["field"]
    inv = gl.inv(x)
    assert kernels.launches["field"] == before + 1
    assert torch.equal(inv, gl.inv_plain(x))
    assert torch.equal(gl.mul(inv, x), (x != 0).to(torch.int64))


# ---------------------------------------------------------------------------
# The light-client circuit and the CLI on the card
# ---------------------------------------------------------------------------


def _dummy_inner(size: int):
    from eth_lc_plonky2_tpu_torch.eth.synthetic import make_synthetic_update_pair
    from eth_lc_plonky2_tpu_torch.models import bls
    from eth_lc_plonky2_tpu_torch.prover.config import FriConfig

    kw = make_synthetic_update_pair(size, seed=7).witness_kwargs
    data = bls.build_dummy_bls_circuit(size, fri=FriConfig(proof_of_work_bits=4,
                                                           num_query_rounds=4))
    args = [kw[k] for k in ("signing_root", "signature", "sync_committee_pubkeys",
                            "sync_committee_bits")]
    return data, args


def test_dummy_inner_proof_on_the_card_equals_the_cpus(dev):
    """The dummy BLS circuit (142 wires, 2^6 rows at committee 4) proved on
    the kernels and on the plain versions on the CPU: the same bytes."""
    from eth_lc_plonky2_tpu_torch.models import bls
    from eth_lc_plonky2_tpu_torch.prover import serialize
    from eth_lc_plonky2_tpu_torch.prover.verify import verify

    data, args = _dummy_inner(4)
    before = dict(kernels.launches)
    proof, vk = bls.prove_dummy_bls(data, *args)
    assert all(kernels.launches[k] > before[k] for k in ("ntt", "poseidon", "field", "gates"))
    cpu_proof, cpu_vk = bls.prove_dummy_bls(data, *args, device="cpu")
    assert np.array_equal(vk.pre_cap, cpu_vk.pre_cap)
    assert serialize.proof_to_dict(proof, True) == serialize.proof_to_dict(cpu_proof, True)
    verify(data, vk, proof)


def test_cli_run_proves_and_verifies_on_the_card(dev, tmp_path):
    """cli.run at --synthetic 4 --bls dummy with a reduced FRI, on the card by
    default: proved, exported, verified by the port and by
    tools/verify_standalone.py, the public inputs the host SSZ roots."""
    import io
    import json
    import os
    import subprocess
    import sys

    from eth_lc_plonky2_tpu_torch import cli
    from eth_lc_plonky2_tpu_torch.eth.synthetic import make_synthetic_update_pair

    syn = make_synthetic_update_pair(4, seed=3)
    path = str(tmp_path / "bundle.json")
    keep = {}
    report = cli.run(syn.witness_kwargs, 4, syn.threshold, pow_bits=4, query_rounds=4,
                     bls_mode="dummy", export_bundle_path=path, out=io.StringIO(), keep=keep)
    assert keep["pd"].device.type == "cuda"
    assert (report["rows_used"], report["degree_bits"]) == (9341, 14)
    assert (report["cur_state"], report["new_state"]) == (syn.cur_state.hex(), syn.new_state.hex())
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tool = os.path.join(repo, "tools", "verify_standalone.py")
    res = subprocess.run([sys.executable, tool, path], capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    with open(path) as f:
        assert json.load(f)["circuit"]["log_n"] == 14


def test_aggregate_proof_on_the_kernels_equals_the_plain_versions(dev):
    """The 2-member BLS12-381 aggregate circuit (8,946 of 2^14 rows, 184 wires)
    proved on the kernels and on the plain versions, both on the card: the
    same bytes, and verify accepts it."""
    from unittest import mock

    from eth_lc_plonky2_tpu_torch.eth.synthetic import make_valid_pubkey
    from eth_lc_plonky2_tpu_torch.models import bls_aggregate as agg
    from eth_lc_plonky2_tpu_torch.prover import serialize
    from eth_lc_plonky2_tpu_torch.prover.config import FriConfig
    from eth_lc_plonky2_tpu_torch.prover.verify import verify

    rng = np.random.default_rng(2)
    keys = [make_valid_pubkey(rng) for _ in range(2)]
    data = agg.build_aggregate_bls_circuit(
        2, fri=FriConfig(proof_of_work_bits=4, num_query_rounds=4), num_wires=184)
    assert (data.num_rows_used, data.log_n) == (8946, 14)
    args = (bytes(range(32)), bytes(range(96)), keys, [1, 1])
    before = dict(kernels.launches)
    proof, vk, pd = agg.prove_aggregate_bls(data, *args)
    assert pd.device.type == "cuda"
    assert all(kernels.launches[k] > before[k] for k in ("ntt", "poseidon", "field", "gates"))
    before = dict(kernels.launches)
    with mock.patch.object(kernels, "on_card", lambda t: False):
        plain_pd = prove.ProverData(data=pd.data, pre_values=pd.pre_values,
                                    pre_batch=pd.pre_batch, dev=pd.dev)
        plain = prove.prove(plain_pd, agg.aggregate_witness(data, *args))
    assert kernels.launches == before
    assert serialize.proof_to_dict(proof, True) == serialize.proof_to_dict(plain, True)
    verify(data, vk, proof)


def test_cli_run_proves_two_aggregate_slices_on_the_card(dev, tmp_path):
    """cli.run at --synthetic 4 --bls aggregate:slices=2 with a reduced FRI, on
    the card: both slices proved with one preprocess, the outer absorbing both
    proved, exported, verified by the port and by tools/verify_standalone.py."""
    import io
    import os
    import subprocess
    import sys

    from eth_lc_plonky2_tpu_torch import cli
    from eth_lc_plonky2_tpu_torch.eth.synthetic import make_synthetic_update_pair
    from eth_lc_plonky2_tpu_torch.prover.verify import verify

    syn = make_synthetic_update_pair(4, seed=3, valid_pubkeys=True)
    path = str(tmp_path / "bundle.json")
    keep = {}
    report = cli.run(syn.witness_kwargs, 4, syn.threshold, pow_bits=4, query_rounds=4,
                     bls_mode="aggregate:slices=2", export_bundle_path=path, out=io.StringIO(),
                     keep=keep)
    assert report["degree_bits"] == 14
    assert (report["cur_state"], report["new_state"]) == (syn.cur_state.hex(), syn.new_state.hex())
    assert len(keep["bls_inners"]) == 2
    for data, proof, vk in keep["bls_inners"]:
        assert data.num_rows_used == 8946
        verify(data, vk, proof)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tool = os.path.join(repo, "tools", "verify_standalone.py")
    res = subprocess.run([sys.executable, tool, path], capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr


def test_prove_stream_on_the_card_equals_sequential_proves(dev):
    """prove_stream of four witnesses on the card: in order, each equal to a
    sequential prove of the same witness."""
    from eth_lc_plonky2_tpu_torch.circuit.builder import CircuitBuilder
    from eth_lc_plonky2_tpu_torch.prover import serialize
    from eth_lc_plonky2_tpu_torch.prover.config import CircuitConfig, FriConfig
    from eth_lc_plonky2_tpu_torch.prover.pipeline import prove_stream

    b = CircuitBuilder(CircuitConfig(fri=FriConfig(proof_of_work_bits=4, num_query_rounds=4)))
    x = b.add_virtual_target()
    acc = x
    for _ in range(60):
        acc = b.mul_add(acc, x, x)
    b.register_public_input(acc)
    data = b.build()
    pd, _ = prove.preprocess(data)

    def make_witness(d, val):
        w = d.new_witness()
        w.set(x, val)
        w.generate()
        return w

    inputs = [3, 5, 7, 11]
    streamed = list(prove_stream(pd, inputs, make_witness, prefetch=1))
    for val, proof in zip(inputs, streamed):
        again = prove.prove(pd, make_witness(data, val))
        assert serialize.proof_to_dict(proof, True) == serialize.proof_to_dict(again, True)


# ---------------------------------------------------------------------------
# The device SHA-256 (csrc/sha256.cu)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 31, 32, 33, (1 << 20) + 1])
def test_sha256_kernels_match_plain(dev, n):
    """compress and two_to_one on the card against their plain versions on
    the card, edge words in the first rows; one launch a call; torch.int32
    words are read as u32."""
    import chip_smoke
    from eth_lc_plonky2_tpu_torch.ops import sha256 as sha

    rng = np.random.default_rng(n)
    state, block = chip_smoke.sha256_words(rng, (n, 8), dev), chip_smoke.sha256_words(rng, (n, 16), dev)
    left, right = chip_smoke.sha256_words(rng, (n, 8), dev), chip_smoke.sha256_words(rng, (n, 8), dev)
    for run, plain, a, b in ((sha.compress, sha.compress_plain, state, block),
                             (sha.two_to_one, sha.two_to_one_plain, left, right)):
        want = plain(a, b).view(torch.int32)
        before = kernels.launches["sha256"]
        got = run(a, b)
        assert kernels.launches["sha256"] == before + 1
        assert got.dtype == torch.uint32 and got.device.type == dev
        assert torch.equal(got.view(torch.int32), want)
        assert torch.equal(run(a.view(torch.int32), b.view(torch.int32)).view(torch.int32), want)
        assert kernels.launches["sha256"] == before + 2


def test_sha256_committee_root_and_refusals_on_the_card(dev):
    """The sync committee root of 512 seeded keys by two_to_one on the card is
    eth/ssz's (12 launches); a CUDA tensor the kernel cannot read raises, it
    never falls back to the plain version."""
    import chip_smoke
    from eth_lc_plonky2_tpu_torch.eth import ssz
    from eth_lc_plonky2_tpu_torch.ops import sha256 as sha

    rng = np.random.default_rng(512)
    keys, aggregate = [rng.bytes(48) for _ in range(512)], rng.bytes(48)
    before = kernels.launches["sha256"]
    assert chip_smoke.sha256_committee_root(keys, aggregate, dev) == ssz.sync_committee_root(
        keys, aggregate)
    assert kernels.launches["sha256"] == before + 12
    words = torch.zeros(4 * 16 + 1, dtype=torch.int32, device=dev)
    aligned, off = words[:32].view(4, 8), words[1:33].view(4, 8)
    for a, b in ((off, aligned), (aligned, words[:64].view(4, 16)[:, ::2]), (aligned, aligned.cpu()),
                 (aligned, aligned.to(torch.int64)), (aligned, aligned[:3])):
        with pytest.raises(ValueError):
            sha.two_to_one(a, b)
    assert kernels.launches["sha256"] == before + 12


# ---------------------------------------------------------------------------
# The NTT past 2^22, the kernels' window form, one rank over NCCL
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_n", [23, 24])
def test_three_pass_ntt_matches_plain(dev, log_n):
    t = gl.from_u64(_rand((2, 1 << log_n), log_n), dev)
    before = kernels.launches["ntt"]
    assert torch.equal(ntt.ntt(t), ntt.ntt_plain(t))
    assert torch.equal(ntt.coset_intt(t, 0), ntt.coset_intt_plain(t, 7))
    assert kernels.launches["ntt"] == before + 2 * (2 + 2)  # A, B a row, C
    c = gl.from_u64(_rand((2, 1 << (log_n - 3)), log_n + 1), dev)
    assert torch.equal(ntt.coset_lde(c, 3), ntt.coset_lde_plain(c, 3, 7))


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("n_lde", [1 << 7, 1 << 12, 1 << 15])
def test_window_form_kernels_match_plain(dev, size, n_lde):
    """The four quotient kernels' window form on every rank's window of a
    domain split ``size`` ways (chip_smoke.py phase 10's check) against the
    plain versions on the window, cut to the middle."""
    import chip_smoke

    chk = chip_smoke.Checker()
    saved = chip_smoke.GATE_SIZES, chip_smoke.LOG_N
    chip_smoke.GATE_SIZES, chip_smoke.LOG_N = (n_lde,), n_lde.bit_length() - 1 - chip_smoke.RATE_BITS
    try:
        before = dict(kernels.launches)
        for rank in range(size):
            chip_smoke.check_window_kernels(torch, chk, np.random.default_rng(rank), rank, size,
                                            "[cuda test]")
    finally:
        chip_smoke.GATE_SIZES, chip_smoke.LOG_N = saved
    assert kernels.launches["gates"] == before["gates"] + 3 * size
    assert kernels.launches["field"] >= before["field"] + size
    assert chk.err == {"ntt": 0.0, "poseidon": 0.0, "field": 0.0, "gates": 0.0, "sha256": 0.0}


def test_one_nccl_rank_proves_the_dryrun_reference(dev, tmp_path):
    """make_dist_ntt, make_sharded_commit and prove_sharded on one rank over
    NCCL against the one-device functions and assets/dryrun/ref_proof.json."""
    import chip_smoke
    from eth_lc_plonky2_tpu_torch.parallel import distributed as dist

    saved = chip_smoke.LOG_N, chip_smoke.DIST_NTT_LOGS
    chip_smoke.LOG_N, chip_smoke.DIST_NTT_LOGS = 12, (10, 16)
    dist.initialize("file://" + str(tmp_path / "store"), 1, 0)
    try:
        mesh = dist.make_global_mesh()
        assert mesh.backend == "nccl" and mesh.device.type == "cuda"
        chk = chip_smoke.Checker()
        chip_smoke.check_sharded_steps(torch, chk, mesh, "[cuda test]")
    finally:
        chip_smoke.LOG_N, chip_smoke.DIST_NTT_LOGS = saved
        dist.shutdown()
