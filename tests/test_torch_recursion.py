"""The port's in-circuit verifier (``circuit/recursion.py``) against the JAX
package's, on ``tests/test_recursion.py``'s circuits: the inner proof is
byte-identical, the outer circuit's tables and its witness for that proof
equal the JAX package's, and a tampered public input, cap, opening or
verifier key leaves the outer circuit unsatisfiable in both packages.  The
outer proof is byte-identical too, in a ``heavy`` test (about 3 minutes of
both CPU provers)."""

import dataclasses as dc

import numpy as np
import pytest
import torch

from torch_circuits import JAX, PORT, cfg, preprocess, same_circuit, same_witness, violations

torch.set_num_threads(1)

P = (1 << 64) - (1 << 32) + 1


def _inner(pkg):
    b = pkg.builder.CircuitBuilder(pkg.config.CircuitConfig(
        fri=pkg.config.FriConfig(proof_of_work_bits=4, num_query_rounds=4)))
    x = b.add_virtual_target()
    acc = x
    for _ in range(20):
        acc = b.mul_add(acc, x, x)
    b.register_public_input(acc)
    data = b.build()
    pd, vk = preprocess(pkg, data)
    w = data.new_witness()
    w.set(x, 3)
    w.generate()
    return data, vk, pkg.pr.prove(pd, w)


def _outer(pkg, inner_data):
    ob = pkg.builder.CircuitBuilder(cfg(pkg, 142))
    pt = pkg.rec.add_virtual_proof_with_pis(ob, inner_data)
    vd = pkg.rec.add_virtual_verifier_data(ob, inner_data)
    pkg.rec.verify_proof_circuit(ob, pt, vd, inner_data)
    ob.register_public_inputs(pt.public_inputs)
    return ob.build(), pt, vd


def _witness(pkg, outer_data, pt, vd, proof, vk):
    ow = outer_data.new_witness()
    pkg.rec.set_proof_with_pis_target(ow, pt, proof)
    pkg.rec.set_verifier_data_target(ow, vd, vk)
    ow.generate()
    return ow


@pytest.fixture(scope="module")
def both():
    out = {}
    for pkg in (PORT, JAX):
        inner_data, vk, proof = _inner(pkg)
        out[pkg.port] = (inner_data, vk, proof, *_outer(pkg, inner_data))
    return out[True], out[False]


def test_inner_proof_equals_the_jax_packages(both):
    (data, vk, proof, *_), (jdata, jvk, jproof, *_) = both
    same_circuit(data, jdata)
    assert np.array_equal(vk.pre_cap, jvk.pre_cap)
    assert PORT.ser.proof_to_dict(proof, True) == JAX.ser.proof_to_dict(jproof, True)
    PORT.verify.verify(data, vk, proof)


def test_outer_circuit_and_witness_equal_the_jax_packages(both):
    (_, vk, proof, od, pt, vd), (_, jvk, jproof, jod, jpt, jvd) = both
    same_circuit(od, jod)
    assert (od.num_rows_used, od.log_n) == (1135, 11)
    ow = _witness(PORT, od, pt, vd, proof, vk)
    same_witness(ow, _witness(JAX, jod, jpt, jvd, jproof, jvk))
    assert violations(PORT, od, ow) == []
    # the inner public inputs surface as the outer ones
    assert [ow.get(t) for t in od.public_input_targets] == [int(v) for v in proof.public_inputs]


def test_the_port_absorbs_a_jax_made_inner_proof(both):
    """The JAX package's inner proof and key, carried over by ``convert``, give
    the port's outer circuit the same witness as the port's own proof."""
    from eth_lc_plonky2_tpu_torch import convert

    (_, vk, proof, od, pt, vd), (_, jvk, jproof, *_) = both
    carried = _witness(PORT, od, pt, vd, convert.proof_from_jax(jproof),
                       convert.verifier_key_from_jax(jvk))
    same_witness(carried, _witness(PORT, od, pt, vd, proof, vk))


def _tampered(what, proof, vk):
    if what == "public_input":
        return dc.replace(proof, public_inputs=np.array(
            [(int(proof.public_inputs[0]) + 1) % P], dtype=np.uint64)), vk
    if what == "cap":
        caps = np.array(proof.wires_cap, dtype=np.uint64).copy()
        caps[0, 0] = int(caps[0, 0]) ^ 1
        return dc.replace(proof, wires_cap=caps), vk
    if what == "opening":
        vals = dict(proof.openings.values)
        rows = np.array(vals[("W", 0)], dtype=np.uint64).copy()
        rows[0, 0] = (int(rows[0, 0]) + 1) % P
        vals[("W", 0)] = rows
        return dc.replace(proof, openings=dc.replace(proof.openings, values=vals)), vk
    caps = np.array(vk.pre_cap, dtype=np.uint64).copy()
    caps[0, 0] = int(caps[0, 0]) ^ 1
    return proof, dc.replace(vk, pre_cap=caps)


def _rejected(pkg, od, pt, vd, proof, vk):
    """How the tampered proof fails the outer circuit: at generation (a copy
    constraint conflict) or by the violations check_constraints lists."""
    try:
        ow = _witness(pkg, od, pt, vd, proof, vk)
    except ValueError:
        return "conflict"
    return violations(pkg, od, ow)


@pytest.mark.parametrize("what", ["public_input", "cap", "opening", "verifier_data"])
def test_tampered_inner_proofs_are_rejected_by_both_packages(both, what):
    (_, vk, proof, od, pt, vd), (_, jvk, jproof, jod, jpt, jvd) = both
    got = _rejected(PORT, od, pt, vd, *_tampered(what, proof, vk))
    want = _rejected(JAX, jod, jpt, jvd, *_tampered(what, jproof, jvk))
    assert got == want
    assert got, f"a tampered {what} satisfies the outer circuit"


@pytest.mark.heavy
def test_outer_proof_equals_the_jax_packages(both):
    (_, vk, proof, od, pt, vd), (_, jvk, jproof, jod, jpt, jvd) = both
    opd, ovk = preprocess(PORT, od)
    jopd, jovk = preprocess(JAX, jod)
    assert np.array_equal(ovk.pre_cap, jovk.pre_cap)
    outer = PORT.pr.prove(opd, _witness(PORT, od, pt, vd, proof, vk))
    jouter = JAX.pr.prove(jopd, _witness(JAX, jod, jpt, jvd, jproof, jvk))
    assert PORT.ser.proof_to_dict(outer, True) == JAX.ser.proof_to_dict(jouter, True)
    PORT.verify.verify(od, ovk, outer)
