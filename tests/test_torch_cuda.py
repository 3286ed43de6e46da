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


OPEN_OFFSETS = (0, -1, -2, -3, -4, -7, -15, -16)


@pytest.mark.parametrize("zeta", ["seeded", "edge"])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("log_n", [4, 12, 18])
def test_field_open_kernel_matches_plain(dev, log_n, k, zeta):
    """field_open_kernel (and its sum over the slices) against the plain
    openings on the card: 37 rows read through a row stride wider than n,
    points zeta * omega^o at phase 7's offsets, edge words in the
    coefficients and, for "edge", in zeta."""
    import chip_smoke
    from eth_lc_plonky2_tpu_torch.ops import goldilocks_ext as ge

    rng = np.random.default_rng(log_n * 10 + k)
    n, p = 1 << log_n, gl.P
    wide = _rand((37, n + 8), log_n + k)
    edge = chip_smoke.field_edge_words()
    wide[:, : min(n, len(edge))] = edge[: min(n, len(edge))]
    coeffs = gl.from_u64(wide, dev)[:, :n]
    z = ((p - 1, 1 << 63) if zeta == "edge"
         else tuple(int(v) for v in rng.integers(0, p, size=2, dtype=np.uint64)))
    omega = gl.primitive_root_of_unity(log_n)
    points = [ge.h_mul(z, (pow(omega, o % n, p), 0)) for o in OPEN_OFFSETS[:k]]
    z_re = gl.from_u64([q[0] for q in points], dev)
    z_im = gl.from_u64([q[1] for q in points], dev)
    before = kernels.launches["field"]
    got = kernels.field_open(coeffs, z_re, z_im)
    assert kernels.launches["field"] == before + kernels.field_open_plan(37, n, k)["launches"]
    want = chip_smoke.on_plain(lambda: prove._open_core_plain(coeffs, z_re, z_im))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("log_n_lde", [7, 12, 15])
def test_perm_quotient_kernel_matches_plain(dev, log_n_lde):
    """perm_quotient_kernel against the plain permutation terms on the card:
    80 routed rows of a 184-row LDE, 80 sigma rows of a 92-row preprocessed
    LDE (real row strides), random and edge words; at 2^7 the next row of
    every column in the last 2^3 wraps to the start."""
    import chip_smoke

    inputs = chip_smoke.perm_inputs(np.random.default_rng(log_n_lde), log_n_lde)
    before = kernels.launches["field"]
    got = chip_smoke.perm_terms(inputs)
    assert kernels.launches["field"] == before + 1
    assert torch.equal(got, chip_smoke.perm_terms(inputs, plain=True))


@pytest.mark.parametrize("log_n_lde", [7, 12, 21])
def test_generic_gate_kernel_matches_plain(dev, log_n_lde):
    """generic_gate_quotient_kernel against the plain generic loop with the
    public inputs on the card: phase 7's gates and 12 public inputs, rows of a
    (184, n_lde) wires LDE and a (92, n_lde) preprocessed LDE, random and edge
    words; the accumulators are updated in place."""
    import chip_smoke

    inp = chip_smoke.generic_inputs(np.random.default_rng(log_n_lde), 1 << log_n_lde)
    want = chip_smoke.generic_terms(inp, "plain")
    before = dict(kernels.launches)
    accs = [a.clone() for a in inp["accs"]]
    kernels.generic_gate_quotient(inp["generic"], inp["wires"], inp["pre"], inp["num_sel"],
                                  inp["num_con"], inp["lr"], inp["pi"], inp["pi_cols"],
                                  inp["apows"], accs, inp["pi0"], inp["k0"])
    assert kernels.launches["gates"] == before["gates"] + 1
    assert kernels.launches["field"] == before["field"]
    assert torch.equal(torch.stack(accs), want)


@pytest.mark.parametrize("num_specs", [5, 12])
@pytest.mark.parametrize("log_n_lde", [12, 21])
def test_fri_g_kernel_matches_plain(dev, log_n_lde, num_specs):
    """fri_g_kernel against the plain G on the card: phase 7's batches (92,
    184, 20, 16 rows), 5 or 12 specs, one norm zero at one column, edge
    words; one launch."""
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


@pytest.mark.parametrize("challenges", [1, 2])
@pytest.mark.parametrize("log_n", [4, 8, 12, 18])
def test_perm_z_kernel_matches_plain(dev, log_n, challenges):
    """perm_z_kernel, its scan and its fix-up against the plain permutation
    rows: 80 routed rows of a 184-row wires matrix, chunk 8, edge words, a
    zero den chunk of each challenge (the grand product ends there); 2^4 is
    less than a block, 2^8 one block, 2^18 the flagship's 1,024 blocks."""
    import chip_smoke

    n = 1 << log_n
    zeros = ((0, 1, n // 3),) + (((1, 9, n - 2),) if challenges == 2 else ())
    inputs = chip_smoke.perm_z_inputs(np.random.default_rng(log_n), log_n, zeros)
    if challenges == 1:
        inputs = inputs[:4] + (inputs[4][:1], inputs[5][:1], inputs[6])
    before = kernels.launches["field"]
    got = chip_smoke.perm_rows(inputs)
    assert kernels.launches["field"] == before + 3
    assert got.shape == (10 * challenges, n)
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
