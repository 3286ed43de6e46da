"""The port's BLS sub-proof path (``models/bls.py``) against the JAX package's
at committee 4 with a reduced FRI: the dummy inner circuit (48 rows on 2^6)
and its proof byte for byte, the absorbing light-client circuit (9,330 rows
on 2^14) and its witness, the port absorbing a JAX-made inner proof, and a
mismatched signing root or participation bit rejected in both packages.  The
port's CPU proof of the absorbing circuit, checked by both verifiers and by
``tools/verify_standalone.py``, is a ``heavy`` test: the plain versions take
about 15 minutes of one CPU core for it."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from eth_lc_plonky2_tpu_torch import convert
from eth_lc_plonky2_tpu_torch.ops import poseidon as pos
from torch_circuits import JAX, PORT, cfg, preprocess, same_circuit, same_witness, violations

torch.set_num_threads(1)

SIZE = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fri(pkg):
    return pkg.config.FriConfig(proof_of_work_bits=4, num_query_rounds=4)


def _inner_proof(pkg, data, kw, **over):
    args = {k: kw[k] for k in ("signing_root", "signature", "sync_committee_pubkeys",
                               "sync_committee_bits")} | over
    extra = {"device": "cpu"} if pkg.port else {}
    return pkg.bls.prove_dummy_bls(data, args["signing_root"], args["signature"],
                                   args["sync_committee_pubkeys"], args["sync_committee_bits"],
                                   **extra)


def _absorbing(pkg, inner_data):
    s = pkg.syn.make_synthetic_update_pair(SIZE, seed=7)
    b = pkg.builder.CircuitBuilder(cfg(pkg))
    t = pkg.lc.add_virtual_proof_target(b, committee_size=SIZE, threshold=s.threshold)
    pt, vd = pkg.bls.absorb_bls_proof(b, t, inner_data)
    b.register_public_inputs(t.cur_state)
    b.register_public_inputs(t.new_state)
    return b.build(), t, pt, vd


def _witness(pkg, data, t, pt, vd, kw, proof, vk):
    w = data.new_witness()
    pkg.lc.set_proof_target(w, t, **kw)
    pkg.bls.set_bls_proof_target(w, pt, vd, proof, vk)
    w.generate()
    return w


@pytest.fixture(scope="module")
def both():
    out = {}
    for pkg in (PORT, JAX):
        kw = pkg.syn.make_synthetic_update_pair(SIZE, seed=7).witness_kwargs
        inner = pkg.bls.build_dummy_bls_circuit(SIZE, fri=_fri(pkg))
        proof, vk = _inner_proof(pkg, inner, kw)
        out[pkg.port] = (kw, inner, proof, vk, *_absorbing(pkg, inner))
    return out[True], out[False]


def test_dummy_inner_circuit_and_proof_equal_the_jax_packages(both):
    (kw, inner, proof, vk, *_), (_, jinner, jproof, jvk, *_) = both
    same_circuit(inner, jinner)
    assert (inner.num_rows_used, inner.log_n) == (48, 6)
    assert inner.config.num_wires == 142 and len(inner.public_input_targets) == PORT.bls.DIGEST_LEN
    assert np.array_equal(vk.pre_cap, jvk.pre_cap)
    assert PORT.ser.proof_to_dict(proof, True) == JAX.ser.proof_to_dict(jproof, True)
    # the public inputs are the host Poseidon digest of the bound values, in order
    vals = list(kw["signing_root"]) + list(kw["signature"])
    for pk, bit in zip(kw["sync_committee_pubkeys"], kw["sync_committee_bits"]):
        vals += list(pk) + [int(bit)]
    assert len(vals) == PORT.bls.num_bls_bound_values(SIZE)
    assert [int(v) for v in proof.public_inputs] == [int(v) for v in pos.hash_no_pad_host(vals)]
    PORT.verify.verify(inner, vk, proof)
    JAX.verify.verify(jinner, jvk, convert.proof_to_jax(proof))


def test_absorbing_circuit_and_witness_equal_the_jax_packages(both):
    (kw, _, proof, vk, data, t, pt, vd), (jkw, _, jproof, jvk, jdata, jt, jpt, jvd) = both
    same_circuit(data, jdata)
    assert (data.num_rows_used, data.log_n) == (9330, 14)
    w = _witness(PORT, data, t, pt, vd, kw, proof, vk)
    same_witness(w, _witness(JAX, jdata, jt, jpt, jvd, jkw, jproof, jvk))
    assert violations(PORT, data, w) == []
    assert [w.get(x) for x in pt.public_inputs] == [int(v) for v in proof.public_inputs]


def test_the_port_absorbs_a_jax_made_inner_proof(both):
    (kw, _, proof, vk, data, t, pt, vd), (_, _, jproof, jvk, *_) = both
    carried = _witness(PORT, data, t, pt, vd, kw, convert.proof_from_jax(jproof),
                       convert.verifier_key_from_jax(jvk))
    same_witness(carried, _witness(PORT, data, t, pt, vd, kw, proof, vk))


@pytest.mark.parametrize("what", ["signing_root", "participation_bit"])
def test_mismatched_inner_proofs_are_rejected_by_both_packages(both, what):
    got = []
    for pkg, (kw, inner, _, _, data, t, pt, vd) in zip((PORT, JAX), both):
        if what == "signing_root":
            over = {"signing_root": bytes(32)}
        else:
            bits = list(kw["sync_committee_bits"])
            bits[0] = 1 - int(bits[0])
            over = {"sync_committee_bits": bits}
        bad_proof, bad_vk = _inner_proof(pkg, inner, kw, **over)
        try:
            w = _witness(pkg, data, t, pt, vd, kw, bad_proof, bad_vk)
        except ValueError:
            got.append("conflict")
        else:
            got.append(violations(pkg, data, w))
    assert got[0] == got[1] and got[0]


def test_artifacts_round_trip_as_the_jax_packages(both, tmp_path):
    (_, inner, proof, vk, *_), (_, jinner, jproof, jvk, *_) = both
    PORT.bls.save_bls_artifacts(str(tmp_path / "port"), inner, proof, vk)
    JAX.bls.save_bls_artifacts(str(tmp_path / "jax"), jinner, jproof, jvk)
    for name in ("circuit.json", "proof.json", "vk.json"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    data, got, key = PORT.bls.load_bls_artifacts(str(tmp_path / "jax"))
    assert PORT.ser.proof_to_dict(got, True) == PORT.ser.proof_to_dict(proof, True)
    assert np.array_equal(key.pre_cap, vk.pre_cap)
    assert PORT.ser.common_data_to_dict(data) == PORT.ser.common_data_to_dict(inner)


@pytest.mark.heavy
def test_cpu_proof_of_the_absorbing_circuit_verifies_everywhere(both, tmp_path):
    (kw, _, proof, vk, data, t, pt, vd), (_, _, _, _, jdata, *_) = both
    pd, ovk = preprocess(PORT, data)
    outer = PORT.pr.prove(pd, _witness(PORT, data, t, pt, vd, kw, proof, vk))
    PORT.verify.verify(data, ovk, outer)
    JAX.verify.verify(jdata, convert.verifier_key_from_jax(ovk), convert.proof_to_jax(outer))
    path = str(tmp_path / "bundle.json")
    PORT.ser.export_proof_bundle(path, data, ovk, outer)
    spec = importlib.util.spec_from_file_location(
        "verify_standalone", os.path.join(REPO, "tools", "verify_standalone.py"))
    vs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vs)
    with open(path) as f:
        assert vs.verify_bundle(json.load(f)) is True
