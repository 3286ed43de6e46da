"""The port's commitment slice (plain path on the CPU) against the JAX
package on its numpy backend and against the committed dryrun oracle.  Exact."""

import os

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from eth_lc_plonky2_tpu.ops import goldilocks as jgl
from eth_lc_plonky2_tpu.prover import merkle as jmerkle
from eth_lc_plonky2_tpu.prover import prove as jprove
from eth_lc_plonky2_tpu_torch import convert
from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.prover import merkle, prove

# The suite runs in parallel worker processes: one intra-op thread each keeps
# torch from oversubscribing the cores (a test ran 15x slower without it).
torch.set_num_threads(1)

PRE = os.path.join(graft.ASSET_DIR, "pre.npz")


@pytest.fixture(scope="module")
def pre():
    return np.load(PRE)


@pytest.fixture(scope="module")
def batches(pre):
    """The same preprocessed values committed by the port and by the JAX package."""
    ours = prove.commit_values(pre["pre_values"], 3, 6, device="cpu")
    ref = jprove.commit_values(pre["pre_values"], 3, 6)
    return ours, ref


def test_entry_cap_matches_commit_forward():
    fn, (lo, hi) = graft.entry()
    want = jgl.to_u64(fn(lo, hi))  # (16, 4) cap of the 32 x 1024 input
    got = prove.commit_values(jgl.to_u64((lo, hi)), graft.RATE_BITS, 4, device="cpu").cap
    assert np.array_equal(got, want)


def test_commit_values_reproduces_dryrun_oracle(pre, batches):
    ours, _ = batches
    assert np.array_equal(gl.to_u64(ours.coeffs), pre["pre_coeffs"])
    assert np.array_equal(gl.to_u64(ours.lde), pre["pre_lde"])
    num_levels = int(pre["num_levels"][0])
    assert len(ours.tree.levels) == num_levels
    for i in range(num_levels):
        assert np.array_equal(gl.to_u64(ours.tree.levels[i]), pre[f"level_{i}"]), i
    assert ours.cap.shape == (1 << 6, 4)


def test_commit_coeffs_matches_jax(pre):
    coeffs = pre["pre_coeffs"][:5]
    ours = prove.commit_coeffs(gl.from_u64(coeffs), 3, 4)
    ref = jprove.commit_coeffs(jgl.from_u64(coeffs), 3, 4)
    assert np.array_equal(gl.to_u64(ours.lde), jgl.to_u64(ref.lde))
    assert np.array_equal(ours.cap, ref.cap)


def test_gather_rows_and_paths_match_jax(batches):
    ours, ref = batches
    idx = np.random.default_rng(3).integers(0, ours.tree.num_leaves, size=24)
    rows, paths = merkle.gather_rows_and_paths(ours.tree, idx)
    jrows, jpaths = jmerkle.gather_rows_and_paths(ref.tree, idx.astype(np.int32))
    assert np.array_equal(gl.to_u64(rows), jgl.to_u64(jrows))
    assert np.array_equal(gl.to_u64(paths), jgl.to_u64(jpaths))


def test_paths_verify_on_both_verifiers(batches):
    ours, _ = batches
    idx = np.random.default_rng(4).integers(0, ours.tree.num_leaves, size=24)
    rows, paths = merkle.gather_rows_and_paths(ours.tree, idx)
    rows_u, paths_u = gl.to_u64(rows), gl.to_u64(paths)
    assert jmerkle.verify_merkle_batch(rows_u, idx, paths_u, ours.cap)
    assert merkle.verify_merkle_batch(rows_u, idx, paths_u, ours.cap)
    bad = rows_u.copy()
    bad[5, 2] ^= np.uint64(1)
    assert not merkle.verify_merkle_batch(bad, idx, paths_u, ours.cap)


def test_build_merkle_matches_jax():
    leaves = np.random.default_rng(5).integers(0, gl.P, size=(64, 4), dtype=np.uint64)
    ours = merkle.build_merkle(leaves, 2, device="cpu")
    ref = jmerkle.build_merkle(leaves, 2)
    assert len(ours.levels) == len(ref.levels) == 5
    assert np.array_equal(ours.cap, ref.cap)
    rows, paths = merkle.gather_rows_and_paths(ours, [0, 63, 17])
    assert merkle.verify_merkle_batch(rows, [0, 63, 17], paths, ours.cap)


@pytest.mark.parametrize("entry", ["commit_values", "build_merkle"])
def test_host_data_goes_to_the_card_by_default(entry):
    """Without ``device="cpu"`` the entry points ask for the card; a machine
    without one raises and never carries on with the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: tests/test_torch_cuda.py checks the default there")
    vals = np.random.default_rng(6).integers(0, gl.P, size=(8, 16), dtype=np.uint64)
    call = {"commit_values": lambda **kw: prove.commit_values(vals, 1, 0, **kw),
            "build_merkle": lambda **kw: merkle.build_merkle(vals, 0, **kw)}[entry]
    with pytest.raises((RuntimeError, AssertionError)):
        call()
    assert call(device="cpu").cap.shape == (1, 4)


def test_convert_round_trips_a_jax_commitment_batch(batches):
    ours, ref = batches
    conv = convert.commitment_batch_from_jax(ref)
    assert conv.tree.leaf_axis == ref.tree.leaf_axis == 1
    assert conv.tree.cap_height == ref.tree.cap_height
    assert torch.equal(conv.coeffs, ours.coeffs) and torch.equal(conv.lde, ours.lde)
    for a, b in zip(conv.tree.levels, ours.tree.levels, strict=True):
        assert torch.equal(a, b)
    # and back to the JAX package's limb layout
    back = jprove.CommitmentBatch(
        coeffs=convert.field_to_limbs(conv.coeffs), lde=convert.field_to_limbs(conv.lde),
        tree=jmerkle.MerkleTree(leaves=convert.field_to_limbs(conv.lde),
                                levels=[convert.field_to_limbs(lv) for lv in conv.tree.levels],
                                cap_height=conv.tree.cap_height, leaf_axis=1))
    assert np.array_equal(back.cap, ref.cap)
    for a, b in zip(convert.field_to_limbs(conv.lde), ref.lde):
        assert np.array_equal(a, np.asarray(b))
    assert torch.equal(convert.field_to_torch(jgl.to_u64(ref.coeffs)), ours.coeffs)
