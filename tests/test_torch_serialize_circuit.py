"""The circuit half of the port's ``prover/serialize.py`` and its
``prover/debug.py`` against the JAX package's: common data, the symbolic gate
expressions, the portable proof bundle (byte for byte, accepted by
``tools/verify_standalone.py``, the tampered bundles of
``tests/test_standalone_verifier.py`` rejected), cache keys, the circuit
cache's round trip (the same proof from the loaded circuit), and the
constraint checker's reports.  Every comparison is exact."""

import copy
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from eth_lc_plonky2_tpu.circuit import algebra as jalgebra
from eth_lc_plonky2_tpu_torch.circuit import algebra
from eth_lc_plonky2_tpu_torch.circuit import gates_poseidon as gp
from eth_lc_plonky2_tpu_torch.circuit import gates_sha256 as gsha
from eth_lc_plonky2_tpu_torch.circuit.gates import gate_from_spec
from torch_circuits import JAX, PORT, cfg, preprocess, same_circuit

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _standalone():
    spec = importlib.util.spec_from_file_location(
        "verify_standalone", os.path.join(REPO, "tools", "verify_standalone.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _circuit(pkg):
    """tests/test_standalone_verifier.py's circuit: generic gates, a range
    check and a Poseidon permutation row."""
    b = pkg.builder.CircuitBuilder(cfg(pkg, 142))
    x = b.add_virtual_target()
    acc = x
    for _ in range(40):
        acc = b.mul_add(acc, x, x)
    bits = b.split_le(x, 32)
    out = pkg.gp.add_poseidon_permutations(b, [[acc] + bits[:3] + [b.zero()] * 8])[0]
    b.register_public_input(acc)
    b.register_public_input(out[0])
    data = b.build()
    w = data.new_witness()
    w.set(x, 5)
    w.generate()
    return data, w, x


@pytest.fixture(scope="module")
def proved(tmp_path_factory):
    out = {}
    d = tmp_path_factory.mktemp("bundles")
    for pkg in (PORT, JAX):
        data, w, x = _circuit(pkg)
        pd, vk = preprocess(pkg, data)
        proof = pkg.pr.prove(pd, w)
        path = str(d / f"bundle_{pkg.port}.json")
        pkg.ser.export_proof_bundle(path, data, vk, proof)
        out[pkg.port] = (data, w, x, pd, vk, proof, path)
    return out[True], out[False]


def test_common_data_equals_the_jax_packages(proved):
    (data, *_), (jdata, *_) = proved
    same_circuit(data, jdata)
    d = PORT.ser.common_data_to_dict(data)
    assert d == JAX.ser.common_data_to_dict(jdata)
    back = PORT.ser.common_data_from_dict(json.loads(json.dumps(d)))
    assert PORT.ser.common_data_to_dict(back) == d
    assert back.selectors is None and back.generators == []


def test_bundle_equals_the_jax_packages_byte_for_byte(proved):
    (*_, proof, path), (*_, jproof, jpath) = proved
    assert PORT.ser.proof_to_dict(proof, True) == JAX.ser.proof_to_dict(jproof, True)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()


def test_standalone_verifier_accepts_the_ports_bundle(proved):
    (*_, path), _ = proved
    with open(path) as f:
        assert _standalone().verify_bundle(json.load(f)) is True


def _tamper(bundle, what, p):
    bad = copy.deepcopy(bundle)
    pr_ = bad["proof"]
    if what == "public_input":
        pr_["public_inputs"][0] = hex((int(pr_["public_inputs"][0], 16) + 1) % p)
    elif what == "cap":
        pr_["wires_cap"][0][0] = hex(int(pr_["wires_cap"][0][0], 16) ^ 1)
    elif what == "opening":
        key = sorted(pr_["openings"])[0]
        pr_["openings"][key][0][0] = hex((int(pr_["openings"][key][0][0], 16) + 1) % p)
    else:
        pr_["fri"]["final_poly"][0][0] = hex((int(pr_["fri"]["final_poly"][0][0], 16) + 1) % p)
    return bad


@pytest.mark.parametrize("what", ["public_input", "cap", "opening", "final_poly"])
def test_standalone_verifier_rejects_tampered_bundles(proved, what):
    (*_, path), _ = proved
    vs = _standalone()
    with open(path) as f:
        bundle = json.load(f)
    with pytest.raises(vs.VerificationError):
        vs.verify_bundle(_tamper(bundle, what, vs.P))


def test_circuit_cache_round_trip_gives_the_same_proof(proved, tmp_path):
    (data, _, x, pd, vk, proof, _), (jdata, _, _, jpd, *_) = proved
    d = str(tmp_path / "c")
    PORT.ser.save_circuit(d, data, pd, extras={"x": x})
    extras, data2, pd2, vk2 = PORT.ser.load_circuit(d, device="cpu")
    assert pd2.device.type == "cpu" and np.array_equal(vk2.pre_cap, vk.pre_cap)
    w = data2.new_witness()
    w.set(extras["x"], 5)
    w.generate()  # the generators survived the pickling
    again = PORT.pr.prove(pd2, w)
    assert PORT.ser.proof_to_dict(again, True) == PORT.ser.proof_to_dict(proof, True)
    # the preprocess arrays are the JAX package's cache's
    jd = str(tmp_path / "j")
    JAX.ser.save_circuit(jd, jdata, jpd)
    mine, theirs = np.load(os.path.join(d, "pre.npz")), np.load(os.path.join(jd, "pre.npz"))
    assert sorted(mine.files) == sorted(theirs.files)
    for key in theirs.files:
        assert np.array_equal(mine[key], theirs[key]), key


def test_cache_keys_and_dirs_equal_the_jax_packages(tmp_path):
    parts = [("lc_circuit", 8, None, cfg(pkg), None) for pkg in (PORT, JAX)]
    assert PORT.ser.cache_key(*parts[0]) == JAX.ser.cache_key(*parts[1])
    assert PORT.ser.cache_key(*parts[0]) != PORT.ser.cache_key("lc_circuit", 16, None, cfg(PORT))
    key = PORT.ser.cache_key(*parts[0])
    assert PORT.ser.cache_dir_for("r", key) == JAX.ser.cache_dir_for("r", key)
    assert not PORT.ser.has_cached_circuit(str(tmp_path), key)


@pytest.mark.parametrize("spec", [{"type": "arith", "num_ops": 20},
                                  {"type": "arith", "num_ops": 35},
                                  {"type": "basesum2", "num_bits": 32, "num_slots": 5},
                                  {"type": "const", "num_slots": 6}, {"type": "noop"},
                                  {"type": "sha256"}, {"type": "poseidon"}])
def test_gate_expressions_equal_the_jax_packages(spec):
    from eth_lc_plonky2_tpu.circuit.gates import gate_from_spec as jgate_from_spec

    got = algebra.gate_expression(gate_from_spec(spec))
    assert got == jalgebra.gate_expression(jgate_from_spec(spec))
    assert len(got["outputs"]) == gate_from_spec(spec).num_constraints
    assert gp.NUM_WIRES_REQUIRED == 142 and gsha.NUM_WIRES_REQUIRED <= 184


@pytest.mark.parametrize("value", [7, 1 << 40])
def test_constraint_checker_equals_the_jax_packages(value):
    """tests/test_debugger.py's circuits: clean, and a range check of a value
    that is not a u32."""
    got = []
    for pkg in (PORT, JAX):
        b = pkg.builder.CircuitBuilder(cfg(pkg, 96))
        x = b.add_virtual_target()
        y = b.mul(x, x)
        b.split_le(y, 32)
        b.register_public_input(y)
        data = b.build()
        w = data.new_witness()
        w.set(x, value)
        w.generate()
        pis = [w.get(t) for t in data.public_input_targets]
        got.append(pkg.debug.check_constraints(data, w.full_matrix(), pis))
        got.append(pkg.debug.check_constraints(data, w.full_matrix(), [p + 1 for p in pis]))
    assert got[:2] == got[2:]
    assert (got[0] == []) == (value == 7)
    assert any(kind == "public_input" for kind, _, _ in got[1])
