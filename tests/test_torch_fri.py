"""The port's FRI module against the JAX package (numpy backend): the G kernel,
one fold, a layer tree, the grind at 8 bits and the PoW check, and the
single-path Merkle helpers.  Same numpy-seeded inputs through both; exact."""

import numpy as np
import pytest
import torch

from eth_lc_plonky2_tpu.circuit.builder import CircuitBuilder as JCircuitBuilder
from eth_lc_plonky2_tpu.ops import goldilocks as jgl
from eth_lc_plonky2_tpu.prover import config as jconfig
from eth_lc_plonky2_tpu.prover import fri as jfri
from eth_lc_plonky2_tpu.prover import merkle as jmerkle
from eth_lc_plonky2_tpu.prover import prove as jpr
from eth_lc_plonky2_tpu.prover.transcript import Challenger as JChallenger
from eth_lc_plonky2_tpu_torch import convert
from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.prover import fri, merkle
from eth_lc_plonky2_tpu_torch.prover import prove as pr
from eth_lc_plonky2_tpu_torch.prover.transcript import Challenger

torch.set_num_threads(1)

P = gl.P


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _same(torch_field, jax_field):
    return np.array_equal(gl.to_u64(torch_field), jgl.to_u64(jax_field))


@pytest.fixture(scope="module")
def circuits():
    """One small circuit preprocessed by both packages (16 wires, 2^5 rows)."""
    cfg = jconfig.CircuitConfig(num_wires=16, num_routed_wires=16, num_constants=2,
                                permutation_chunk_size=4,
                                fri=jconfig.FriConfig(cap_height=2, proof_of_work_bits=8,
                                                      num_query_rounds=4, final_poly_bits=2))
    b = JCircuitBuilder(cfg)
    x = b.add_virtual_target()
    acc = x
    while len(b.rows) < 20:
        acc = b.mul_add(acc, x, x)
    b.register_public_input(acc)
    jdata = b.build()
    jpd, _ = jpr.preprocess(jdata)
    pd, _ = pr.preprocess(convert.circuit_data_from_jax(jdata), device="cpu")
    return jpd, pd


def test_g_kernel(circuits):
    jpd, pd = circuits
    n_lde = pd.data.n << pd.data.config.rate_bits
    counts = {"P": 5, "W": 18, "Z": 3, "Q": 4}  # 18 rows: two weighted-sum chunks
    spec_tags = ("P", "W", "W", "Z", "Z", "Q")
    total = sum(counts.values())
    ldes = [_rand((counts[t], n_lde), 10 + i) for i, t in enumerate(fri.TAGS)]
    apow = (_rand((total + len(spec_tags),), 20), _rand((total + len(spec_tags),), 21))
    ys = (_rand((len(spec_tags),), 22), _rand((len(spec_tags),), 23))
    zs = (_rand((len(spec_tags),), 24), _rand((len(spec_tags),), 25))
    t = lambda pair: tuple(gl.from_u64(a) for a in pair)  # noqa: E731
    j = lambda pair: tuple(jgl.from_u64(a) for a in pair)  # noqa: E731
    got = fri.make_g_kernel(pd, counts, len(spec_tags), spec_tags)(
        tuple(gl.from_u64(a) for a in ldes), t(apow), t(ys), t(zs))
    want = jfri.make_g_kernel(jpd, counts, len(spec_tags), spec_tags)(
        tuple(jgl.from_u64(a) for a in ldes), j(apow), j(ys), j(zs))
    assert got[0].shape == (n_lde,)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.parametrize("log_size", [1, 4, 9])
def test_fold_core(log_size):
    size = 1 << log_size
    h = size // 2
    re, im, hx = _rand((size,), 30), _rand((size,), 31), _rand((h,), 32)
    beta = (int(_rand((), 33)), int(_rand((), 34)))
    inv2 = gl.h_inv(2)
    want = jfri._fold_core(jgl.from_u64(re), jgl.from_u64(im), jgl.from_u64(hx),
                           jgl.full((h,), inv2),
                           (jgl.from_u64(np.uint64(beta[0])), jgl.from_u64(np.uint64(beta[1]))))
    beta_t = (pr.scalar_f(beta[0], "cpu"), pr.scalar_f(beta[1], "cpu"))
    for half in (pr.scalar_f(inv2, "cpu"), gl.full((h,), inv2, "cpu")):
        got = fri._fold_core(gl.from_u64(re), gl.from_u64(im), gl.from_u64(hx), half, beta_t)
        assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.parametrize("log_size,cap_height", [(6, 4), (5, 4), (3, 2), (11, 4)])
def test_layer_tree_core(log_size, cap_height):
    re, im = _rand((1 << log_size,), 40), _rand((1 << log_size,), 41)
    leaves, levels = fri._layer_tree_core(gl.from_u64(re), gl.from_u64(im), cap_height)
    jleaves, jlevels = jfri._layer_tree_core(jgl.from_u64(re), jgl.from_u64(im),
                                            cap_height=cap_height)
    assert _same(leaves, jleaves) and len(levels) == len(jlevels)
    for a, b in zip(levels, jlevels):
        assert _same(a, b)
    assert levels[-1].shape == (1 << cap_height, 4)
    assert fri.layer_cap_height(1 << (log_size - 1)) == jfri.layer_cap_height(1 << (log_size - 1))


def _seeded_challengers(seed):
    xs = [int(v) for v in _rand((11,), seed)]
    ours, theirs = Challenger(), JChallenger()
    ours.observe_many(xs)
    theirs.observe_many(xs)
    return ours, theirs


@pytest.mark.parametrize("seed", [50, 51, 52])
def test_grind_at_8_bits_finds_the_same_witness(seed):
    ours, theirs = _seeded_challengers(seed)
    got = fri.grind(ours, 8, "cpu")
    assert got == jfri.grind(theirs, 8)
    _, replay = _seeded_challengers(seed)
    c = replay.challenge()
    assert fri.verify_pow(c, got, 8) and jfri.verify_pow(c, got, 8)
    assert not any(fri.verify_pow(c, w, 8) for w in range(got))  # the FIRST witness
    assert ours.challenge() == theirs.challenge()  # the transcripts stay in step


def test_grind_core_returns_the_first_hit_of_a_batch():
    c_f = pr.scalar_f(12345, "cpu")
    ws = torch.arange(0, 1 << 10, dtype=torch.int64)
    found, idx = fri._grind_core(c_f, ws, (1 << 59) >> 32)  # 5 bits: several hits in 1024
    hits = [w for w in range(1 << 10) if fri.verify_pow(12345, w, 5)]
    assert bool(found) and len(hits) > 1 and int(idx) == hits[0]
    found, _ = fri._grind_core(c_f, ws[:4], 1)  # 63 bits: no hit among four
    assert not bool(found)


def test_verify_pow_matches():
    for c, w in ((1, 2), (P - 1, 77), (123456789, 1 << 31)):
        for bits in (1, 8, 16):
            assert fri.verify_pow(c, w, bits) == jfri.verify_pow(c, w, bits)


@pytest.mark.parametrize("leaf_axis", [0, 1])
def test_merkle_path_and_verify_merkle(leaf_axis):
    vals = _rand((32, 6), 60)
    tree = merkle.build_merkle(vals, 2, device="cpu")
    jtree = jmerkle.build_merkle(vals, 2)
    if leaf_axis == 1:  # a commitment's layout: leaf i is column i
        tree = merkle.tree_from_digests(tree.leaves.T.contiguous(), tree.levels[0], 2, leaf_axis=1)
    for index in (0, 13, 31):
        path = merkle.merkle_path(tree, index)
        assert all(np.array_equal(a, b) for a, b in zip(path, jmerkle.merkle_path(jtree, index)))
        assert len(path) == 3
        assert merkle.verify_merkle(vals[index], index, path, tree.cap)
        assert jmerkle.verify_merkle(vals[index], index, path, jtree.cap)
        assert not merkle.verify_merkle(vals[index], index ^ 1, path, tree.cap)
        bad = [p.copy() for p in path]
        bad[1][2] ^= np.uint64(1)
        assert not merkle.verify_merkle(vals[index], index, bad, tree.cap)
