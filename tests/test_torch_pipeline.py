"""The port's streaming prover (``prover/pipeline.py:prove_stream``) against
sequential ``prove`` calls and the JAX package's ``prove_stream``, on the CPU:
the proofs come out in input order and equal sequential proofs and the JAX
package's byte for byte; the witness of the next item is made by the worker
thread while the caller's thread proves the current one; a worker error is
raised in the consumer, after the proofs of the items before it."""

import threading
import types

import pytest
import torch

import torch_circuits
from eth_lc_plonky2_tpu.prover import pipeline as jpipe
from eth_lc_plonky2_tpu_torch.prover import pipeline
from torch_circuits import cfg, preprocess

# each package's modules, with its streaming prover
JAX = types.SimpleNamespace(**vars(torch_circuits.JAX), pipe=jpipe)
PORT = types.SimpleNamespace(**vars(torch_circuits.PORT), pipe=pipeline)

torch.set_num_threads(1)

INPUTS = [3, 5, 7, 11]


def _circuit(pkg):
    b = pkg.builder.CircuitBuilder(cfg(pkg, num_wires=pkg.config.CircuitConfig().num_wires))
    x = b.add_virtual_target()
    acc = x
    for _ in range(60):
        acc = b.mul_add(acc, x, x)
    b.register_public_input(acc)
    return b.build(), x


@pytest.fixture(scope="module")
def both():
    out = {}
    for pkg in (PORT, JAX):
        data, x = _circuit(pkg)
        pd, vk = preprocess(pkg, data)
        out[pkg.port] = (data, x, pd, vk)
    return out


def _maker(x, made: list | None = None):
    def make_witness(data, val):
        w = data.new_witness()
        w.set(x, val)
        w.generate()
        if made is not None:
            made.append((val, threading.get_ident()))
        return w
    return make_witness


@pytest.mark.parametrize("prefetch", [1, 2])
def test_stream_equals_sequential_and_the_jax_packages(both, prefetch):
    data, x, pd, vk = both[True]
    made: list = []
    proofs = list(PORT.pipe.prove_stream(pd, INPUTS, _maker(x, made), prefetch=prefetch))
    assert [val for val, _ in made] == INPUTS
    assert threading.get_ident() not in {ident for _, ident in made}  # the worker made them
    seq = [PORT.pr.prove(pd, _maker(x)(data, val)) for val in INPUTS]
    jdata, jx, jpd, _ = both[False]
    jproofs = list(JAX.pipe.prove_stream(jpd, INPUTS, _maker(jx), prefetch=prefetch))
    assert len(proofs) == len(INPUTS)
    for val, proof, s, jp in zip(INPUTS, proofs, seq, jproofs):
        want = PORT.ser.proof_to_dict(s, True)
        assert PORT.ser.proof_to_dict(proof, True) == want
        assert JAX.ser.proof_to_dict(jp, True) == want
        PORT.verify.verify(data, vk, proof)
        assert int(proof.public_inputs[0]) == _maker(x)(data, val).get(data.public_input_targets[0])


def test_the_next_witness_is_made_while_the_current_one_is_proved(both, monkeypatch):
    """Each prove but the last waits, inside ``prove``, for the worker to finish
    the next item's witness: the stream overlaps the two."""
    data, x, pd, _ = both[True]
    ready = {val: threading.Event() for val in INPUTS}
    make = _maker(x)

    def make_witness(d, val):
        w = make(d, val)
        ready[val].set()
        return w

    prove = PORT.pr.prove
    overlapped = []

    def waiting_prove(pd_, w):
        val = w.get(x)
        i = INPUTS.index(val)
        if i + 1 < len(INPUTS):
            overlapped.append(ready[INPUTS[i + 1]].wait(timeout=30))
        return prove(pd_, w)

    monkeypatch.setattr(PORT.pr, "prove", waiting_prove)
    proofs = list(PORT.pipe.prove_stream(pd, INPUTS, make_witness, prefetch=1))
    assert overlapped == [True] * (len(INPUTS) - 1)
    assert len(proofs) == len(INPUTS)


@pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
def test_stream_propagates_witness_errors(both, pkg):
    data, x, pd, _ = both[pkg.port]
    make = _maker(x)

    def make_witness(d, val):
        if val == 5:
            raise ValueError("bad update")
        return make(d, val)

    got = []
    with pytest.raises(ValueError, match="bad update"):
        for proof in pkg.pipe.prove_stream(pd, [3, 5, 7], make_witness):
            got.append(proof)
    assert len(got) == 1  # the proof of the item before the error came out first
