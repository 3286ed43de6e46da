"""Shared by the port's circuit-level tests (``tests/test_torch_*.py``): the
same module names of either package, so that one circuit-building script
serves both, and the exact comparisons of what the two builders give."""

import types

import numpy as np

from eth_lc_plonky2_tpu.circuit import builder as jbuilder
from eth_lc_plonky2_tpu.circuit import gadgets_biguint as jgb
from eth_lc_plonky2_tpu.circuit import gadgets_ext as jgx
from eth_lc_plonky2_tpu.circuit import gadgets_merkle as jgm
from eth_lc_plonky2_tpu.circuit import gadgets_sha256 as jgs
from eth_lc_plonky2_tpu.circuit import gates_poseidon as jgp
from eth_lc_plonky2_tpu.circuit import recursion as jrec
from eth_lc_plonky2_tpu.eth import synthetic as jsyn
from eth_lc_plonky2_tpu.models import bls as jbls
from eth_lc_plonky2_tpu.models import lc_circuit as jlc
from eth_lc_plonky2_tpu.prover import config as jconfig
from eth_lc_plonky2_tpu.prover import debug as jdebug
from eth_lc_plonky2_tpu.prover import prove as jpr
from eth_lc_plonky2_tpu.prover import serialize as jser
from eth_lc_plonky2_tpu.prover import verify as jverify
from eth_lc_plonky2_tpu_torch import convert
from eth_lc_plonky2_tpu_torch.circuit import builder
from eth_lc_plonky2_tpu_torch.circuit import gadgets_biguint as gb
from eth_lc_plonky2_tpu_torch.circuit import gadgets_ext as gx
from eth_lc_plonky2_tpu_torch.circuit import gadgets_merkle as gm
from eth_lc_plonky2_tpu_torch.circuit import gadgets_sha256 as gs
from eth_lc_plonky2_tpu_torch.circuit import gates_poseidon as gp
from eth_lc_plonky2_tpu_torch.circuit import recursion as rec
from eth_lc_plonky2_tpu_torch.eth import synthetic as syn
from eth_lc_plonky2_tpu_torch.models import bls
from eth_lc_plonky2_tpu_torch.models import lc_circuit as lc
from eth_lc_plonky2_tpu_torch.prover import config
from eth_lc_plonky2_tpu_torch.prover import debug
from eth_lc_plonky2_tpu_torch.prover import prove as pr
from eth_lc_plonky2_tpu_torch.prover import serialize as ser
from eth_lc_plonky2_tpu_torch.prover import verify as pverify


def _pkg(**mods):
    return types.SimpleNamespace(**mods)


JAX = _pkg(builder=jbuilder, gb=jgb, gx=jgx, gm=jgm, gs=jgs, gp=jgp, rec=jrec, syn=jsyn,
           bls=jbls, lc=jlc, config=jconfig, debug=jdebug, pr=jpr, ser=jser, verify=jverify,
           port=False)
PORT = _pkg(builder=builder, gb=gb, gx=gx, gm=gm, gs=gs, gp=gp, rec=rec, syn=syn, bls=bls, lc=lc,
            config=config, debug=debug, pr=pr, ser=ser, verify=pverify, port=True)

TABLES = ("selectors", "constants", "sigma", "rep", "k_shifts")


def cfg(pkg, num_wires=184, pow_bits=4, queries=4, **kw):
    """A CircuitConfig of ``pkg`` with a reduced FRI (the gadgets under test
    do not depend on the soundness parameters)."""
    return pkg.config.CircuitConfig(
        num_wires=num_wires,
        fri=pkg.config.FriConfig(proof_of_work_bits=pow_bits, num_query_rounds=queries), **kw)


def preprocess(pkg, data):
    return pkg.pr.preprocess(data, device="cpu") if pkg.port else pkg.pr.preprocess(data)


def same_circuit(data, jdata) -> None:
    """The port's CircuitData equals the JAX package's: the JAX one carried
    over by ``convert.circuit_data_from_jax`` has the port's tables, gates and
    public-input rows."""
    carried = convert.circuit_data_from_jax(jdata)
    assert (data.log_n, data.num_rows_used, data.gate_names) == (
        carried.log_n, carried.num_rows_used, carried.gate_names)
    assert data.config == carried.config
    for key in TABLES:
        assert np.array_equal(getattr(data, key), getattr(carried, key)), key
    assert [tuple(t) for t in data.public_input_targets] == [
        tuple(t) for t in carried.public_input_targets]
    assert ser.common_data_to_dict(data) == ser.common_data_to_dict(carried)
    assert [type(g) for g in data.gates] == [type(g) for g in carried.gates]


def same_witness(w, jw) -> None:
    assert np.array_equal(w.full_matrix(), np.asarray(jw.full_matrix(), dtype=np.uint64))


def violations(pkg, data, w) -> list:
    """check_constraints over the witness with its own public-input values."""
    return pkg.debug.check_constraints(
        data, w.full_matrix(), [w.get(t) for t in data.public_input_targets])
