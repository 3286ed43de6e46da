"""The port's verifier and its proofs of the SHA-256 circuits against the JAX
package (numpy backend): whole proofs of the two-to-one and Merkle-tree
circuits byte for byte, each verifier on the other package's proofs (carried
across by ``convert.py``), and the same tampered proofs rejected by both: a
forged SHA-256 witness, a flipped opening, a wrong PoW witness, a wrong cap, a
changed FRI leaf, a changed public input.  The circuits of generic gates and
the committed dryrun proof go through the port's verifier too.  Every
comparison is exact."""

import copy
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from eth_lc_plonky2_tpu.prover import prove as jpr
from eth_lc_plonky2_tpu.prover import serialize as jserialize
from eth_lc_plonky2_tpu.prover import verify as jverify
from eth_lc_plonky2_tpu_torch import convert
from eth_lc_plonky2_tpu_torch.circuit import gates_sha256 as gsha
from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.ops import kernels
from eth_lc_plonky2_tpu_torch.prover import prove as pr
from eth_lc_plonky2_tpu_torch.prover import serialize
from eth_lc_plonky2_tpu_torch.prover import verify as pverify

from test_torch_gates import CIRCUITS, JAX, PORT

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_proved = {}


def _both(name):
    """(jax data, jax vk, jax proof, port data, port vk, port proof, port pd, port witness)."""
    if name not in _proved:
        jdata, jw = CIRCUITS[name](JAX)
        data, w = CIRCUITS[name](PORT)
        jpd, jvk = jpr.preprocess(jdata)
        pd, vk = pr.preprocess(data, device="cpu")
        before = dict(kernels.launches)
        proof = pr.prove(pd, w)
        assert kernels.launches == before  # a CPU tensor never reaches a kernel
        _proved[name] = (jdata, jvk, jpr.prove(jpd, jw), data, vk, proof, pd, w)
    return _proved[name]


SHA_CIRCUITS = ["two_to_one", "merkle_height_2"]


@pytest.mark.parametrize("name", SHA_CIRCUITS)
def test_sha_circuit_proofs_equal_the_jax_packages(name):
    jdata, jvk, jproof, data, vk, proof, _, _ = _both(name)
    assert np.array_equal(vk.pre_cap, jvk.pre_cap)
    assert chip_smoke.first_difference(
        serialize.proof_to_dict(proof, include_indices=True),
        jserialize.proof_to_dict(jproof, include_indices=True)) is None
    assert sorted(proof.openings.values) == sorted(
        [("P", 0), ("Z", 0), ("Z", 1), ("Q", 0)] + [("W", o) for o in gsha.Sha256RoundGate.wire_offsets])


@pytest.mark.parametrize("name", SHA_CIRCUITS)
def test_each_verifier_accepts_the_other_packages_proofs(name):
    jdata, jvk, jproof, data, vk, proof, _, _ = _both(name)
    assert pverify.verify(data, vk, proof) is None
    jverify.verify(jdata, jvk, convert.proof_to_jax(proof))
    pverify.verify(data, vk, convert.proof_from_jax(jproof))
    # the JAX circuit carried across, its key too
    pverify.verify(convert.circuit_data_from_jax(jdata), pr.VerifierKey(pre_cap=np.array(jvk.pre_cap)),
                   convert.proof_from_jax(jproof))


def _rejected_by_both(name, proof):
    jdata, jvk, _, data, vk, _, _, _ = _both(name)
    with pytest.raises(pverify.VerificationError) as ours:
        pverify.verify(data, vk, proof)
    with pytest.raises(jverify.VerificationError) as theirs:
        jverify.verify(jdata, jvk, convert.proof_to_jax(proof))
    assert str(ours.value) == str(theirs.value)  # the same check fails in both
    return str(ours.value)


def test_forged_sha_witness_rejected():
    """Forge one round's output word (copy-consistent): the proof is made, and
    the SHA-256 segment constraints reject it at verification, in both packages."""
    _, _, _, data, _, _, pd, w = _both("two_to_one")
    forged = chip_smoke.forged_witness(data, w, "sha256")
    assert int((forged.values != w.values).sum()) == 2  # one bit wire and its word
    why = _rejected_by_both("two_to_one", pr.prove(pd, forged))
    assert "constraint identity" in why


TAMPERINGS = ["flipped opening", "flipped neighbour-row opening", "wrong pow witness",
              "wrong wires cap", "wrong quotient cap", "changed fri leaf", "changed batch leaf",
              "changed public input", "changed final polynomial", "dropped fri layer"]


@pytest.mark.parametrize("what", TAMPERINGS)
def test_tampered_proofs_are_rejected_by_both_verifiers(what):
    proof = copy.deepcopy(_both("two_to_one")[5])
    fp = proof.fri_proof
    one = np.uint64(1)
    if what == "flipped opening":
        proof.openings.values[("W", 0)][gsha.A_BITS, 0] ^= one
    elif what == "flipped neighbour-row opening":
        proof.openings.values[("W", -16)][gsha.COL_WW, 0] ^= one
    elif what == "wrong pow witness":
        fp.pow_witness += 1
    elif what == "wrong wires cap":
        proof.wires_cap[0, 0] ^= one
    elif what == "wrong quotient cap":
        proof.quotient_cap[3, 1] ^= one
    elif what == "changed fri leaf":
        fp.query_proofs[2].layer_leaves[0][1] ^= one
    elif what == "changed batch leaf":
        fp.query_proofs[0].batch_leaves["W"][gsha.E_BITS] ^= one
    elif what == "changed public input":
        proof.public_inputs[0] ^= one
    elif what == "changed final polynomial":
        fp.final_poly[0, 0] ^= one
    elif what == "dropped fri layer":
        fp.layer_caps.pop()
    _rejected_by_both("two_to_one", proof)


def test_generic_gate_circuit_and_dryrun_proof_verify():
    """Circuits without neighbour-row offsets: the dryrun circuit's committed
    proof, and the port's own of the same circuit."""
    data, w = chip_smoke.dryrun_circuit()
    pd, vk = pr.preprocess(data, device="cpu")
    with open(os.path.join(REPO, "assets", "dryrun", "ref_proof.json")) as f:
        stored = serialize.proof_from_dict(json.load(f))
    pverify.verify(data, vk, stored)
    proof = pr.prove(pd, w)
    chip_smoke.check_proof(data, vk, proof, w, "dryrun circuit")
    stored.openings.values[("Z", 1)][0, 1] ^= np.uint64(1)
    with pytest.raises(pverify.VerificationError):
        pverify.verify(data, vk, stored)
    bad_key = pr.VerifierKey(pre_cap=vk.pre_cap ^ np.uint64(1))
    with pytest.raises(pverify.VerificationError):
        pverify.verify(data, bad_key, proof)
    assert (gl.to_u64(gl.from_u64(vk.pre_cap)) == vk.pre_cap).all()
