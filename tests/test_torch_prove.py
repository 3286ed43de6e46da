"""The port's ``prove()`` against the JAX package (numpy backend), module by
module and as a whole: ``_prefix_mul`` and ``_perm_core`` at (80, 2^8), the
quotient's chunks, ``_open_core``, the domain tables, the proof's JSON form;
the dryrun circuit's proof against ``assets/dryrun/ref_proof.json``; and for
each circuit of ``tests/test_prover_e2e.py`` the port's proof against the JAX
package's, which the JAX verifier accepts, and rejects once tampered with.
Same numpy-seeded inputs through both; every comparison is exact."""

import copy
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from eth_lc_plonky2_tpu.circuit import builder as jbuilder
from eth_lc_plonky2_tpu.ops import goldilocks as jgl
from eth_lc_plonky2_tpu.prover import config as jconfig
from eth_lc_plonky2_tpu.prover import prove as jpr
from eth_lc_plonky2_tpu.prover import serialize as jserialize
from eth_lc_plonky2_tpu.prover.verify import VerificationError, verify
from eth_lc_plonky2_tpu_torch import convert
from eth_lc_plonky2_tpu_torch.circuit import builder
from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.prover import config
from eth_lc_plonky2_tpu_torch.prover import profiler
from eth_lc_plonky2_tpu_torch.prover import prove as pr
from eth_lc_plonky2_tpu_torch.prover import serialize

torch.set_num_threads(1)

P = gl.P
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _same(torch_field, jax_field):
    return np.array_equal(gl.to_u64(torch_field), jgl.to_u64(jax_field))


def _jscalar(v):
    return jgl.from_u64(np.uint64(v))


# ---------------------------------------------------------------------------
# Module by module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 48, 64, 256, 1024])
def test_prefix_mul(n):
    ratio = _rand((n,), n)
    assert _same(pr._prefix_mul(gl.from_u64(ratio), n), jpr._prefix_mul(jgl.from_u64(ratio), n))


@pytest.mark.parametrize("nr,n,cs", [(80, 256, 8), (16, 32, 2), (8, 16, 8)])
def test_perm_core(nr, n, cs):
    wires, sigma = _rand((nr, n), 1), _rand((nr, n), 2)
    omega_pows, k_shifts = _rand((n,), 3), _rand((nr,), 4)
    beta, gamma = int(_rand((), 5)), int(_rand((), 6))
    got = pr._perm_core(gl.from_u64(wires), gl.from_u64(sigma), gl.from_u64(omega_pows),
                        gl.from_u64(k_shifts), pr.scalar_f(beta, "cpu"), pr.scalar_f(gamma, "cpu"), cs)
    want = jpr._perm_core(jgl.from_u64(wires), jgl.from_u64(sigma), jgl.from_u64(omega_pows),
                          jgl.from_u64(k_shifts), _jscalar(beta), _jscalar(gamma), chunk_size=cs)
    assert got.shape == (nr // cs, n) and _same(got, want)


@pytest.mark.parametrize("batch,n,k", [(5, 64, 1), (20, 32, 2), (1, 1, 3)])
def test_open_core(batch, n, k):
    coeffs, z_re, z_im = _rand((batch, n), 7), _rand((k,), 8), _rand((k,), 9)
    got = pr._open_core(gl.from_u64(coeffs), gl.from_u64(z_re), gl.from_u64(z_im))
    want = jpr._open_core(jgl.from_u64(coeffs), jgl.from_u64(z_re), jgl.from_u64(z_im))
    assert got[0].shape == (k, batch)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    zs = [(int(a), int(b)) for a, b in zip(z_re, z_im)]
    many = pr.eval_poly_ext_many(gl.from_u64(coeffs), zs)
    assert torch.equal(many[0], got[0]) and torch.equal(many[1], got[1])


@pytest.mark.parametrize("log_n,rate", [(2, 3), (5, 3), (4, 1)])
def test_domain_tables(log_n, rate):
    assert np.array_equal(pr._lde_domain_u64(log_n, rate), jpr._lde_domain_u64(log_n, rate))
    assert np.array_equal(pr._zh_on_lde(log_n, rate), jpr._zh_on_lde(log_n, rate))


def test_scalar_helpers():
    assert _same(pr.scalar_f(P + 5, "cpu"), jpr.scalar_f(P + 5))
    assert pr.scalar_f(5, "cpu").shape == ()
    assert _same(pr.scalars_f([1, P - 1, P + 2], "cpu"), jpr.scalars_f([1, P - 1, P + 2]))
    assert pr.scalars_f([], "cpu").shape == (0,)


# ---------------------------------------------------------------------------
# Circuits through both packages
# ---------------------------------------------------------------------------


def _circuit(mod, cfg_mod, which):
    """One circuit of tests/test_prover_e2e.py (its TEST_CONFIG, 96 wires), or
    a narrow one with row offsets of its own, on one package's builder."""
    cfg = cfg_mod.CircuitConfig(fri=cfg_mod.FriConfig(proof_of_work_bits=8, num_query_rounds=12))
    b = mod.CircuitBuilder(cfg)
    if which == "mul_add":
        x, y = b.add_virtual_target(), b.add_virtual_target()
        out = b.add_const(b.add(b.mul(x, y), x), 7)
        b.register_public_input(out)
        values = {x: 5, y: 11}
    elif which == "bool":
        t = b.add_virtual_target()
        b.assert_bool(t)
        b.register_public_input(b.mul_const(3, t))
        values = {t: 1}
    elif which == "split_select":
        v = b.add_virtual_target()
        b.assert_equal(b.le_sum(b.split_le(v, 32)), v)
        flag = b.add_virtual_bool_target()
        b.register_public_input(b.select(flag, v, b.constant(999)))
        values = {v: 0xDEADBEEF, flag: 1}
    elif which == "is_equal":
        u, v = b.add_virtual_target(), b.add_virtual_target()
        b.register_public_input(b.is_equal(u, v))
        values = {u: 42, v: 42}
    else:  # "chain": enough rows that FRI folds twice
        x = b.add_virtual_target()
        acc = x
        while len(b.rows) < 120:
            acc = b.mul_add(acc, x, x)
        b.register_public_input(acc)
        values = {x: 3}
    data = b.build()
    w = data.new_witness()
    for t, v in values.items():
        w.set(t, v)
    w.generate()
    return data, w


CIRCUITS = ["mul_add", "bool", "split_select", "is_equal", "chain"]
_proved = {}


def _both(which):
    """(JAX data, JAX vk, JAX proof dict, port data, port vk, port proof), proved once."""
    if which not in _proved:
        jdata, jw = _circuit(jbuilder, jconfig, which)
        jpd, jvk = jpr.preprocess(jdata)
        jproof = jpr.prove(jpd, jw)
        data, w = _circuit(builder, config, which)
        pd, vk = pr.preprocess(data, device="cpu")
        _proved[which] = (jdata, jvk, jserialize.proof_to_dict(jproof, include_indices=True),
                          data, vk, pr.prove(pd, w), pd, w)
    return _proved[which]


@pytest.mark.parametrize("which", CIRCUITS)
def test_proof_equals_the_jax_packages(which):
    _, jvk, jdict, data, vk, proof, _, _ = _both(which)
    assert np.array_equal(vk.pre_cap, jvk.pre_cap)
    got = serialize.proof_to_dict(proof, include_indices=True)
    assert chip_smoke.first_difference(got, jdict) is None
    assert json.dumps(got) == json.dumps(jdict)  # byte for byte
    assert proof.fri_proof.query_proofs[0].batch_leaves["W"].shape == (data.config.num_wires,)


@pytest.mark.parametrize("which", CIRCUITS)
def test_jax_verifier_accepts_the_ports_proof(which):
    jdata, jvk, _, _, vk, proof, _, _ = _both(which)
    verify(jdata, jvk, convert.proof_to_jax(proof))  # must not raise
    verify(jdata, jpr.VerifierKey(pre_cap=vk.pre_cap), convert.proof_to_jax(proof))


def _tamper_opening(p):
    p.openings.values[("W", 0)][3, 0] ^= np.uint64(1)


def _tamper_cap(p):
    p.zs_cap[5, 2] ^= np.uint64(1)


def _tamper_pow(p):
    p.fri_proof.pow_witness += 1


def _tamper_public_input(p):
    p.public_inputs[0] ^= np.uint64(1)


def _tamper_path(p):
    p.fri_proof.query_proofs[0].batch_paths["W"][0][1] ^= np.uint64(1)


def _tamper_final_poly(p):
    p.fri_proof.final_poly[0, 0] ^= np.uint64(1)


TAMPERS = {"opening": _tamper_opening, "cap word": _tamper_cap, "pow witness": _tamper_pow,
           "public input": _tamper_public_input, "batch path": _tamper_path,
           "final poly": _tamper_final_poly}


@pytest.mark.parametrize("what", sorted(TAMPERS))
@pytest.mark.parametrize("which", ["mul_add", "chain"])
def test_jax_verifier_rejects_a_tampered_proof(which, what):
    jdata, jvk, _, _, _, proof, _, _ = _both(which)
    bad = convert.proof_to_jax(proof)  # a deep copy
    TAMPERS[what](bad)
    with pytest.raises(VerificationError):
        verify(jdata, jvk, bad)
    verify(jdata, jvk, convert.proof_to_jax(proof))  # the original is untouched


@pytest.mark.parametrize("which", ["split_select", "chain"])
def test_quotient_chunks(which):
    """The quotient closure of both packages on the same seeded inputs (no
    witness: the chunks are a function of the LDEs and the challenges)."""
    jdata, _, _, data, _, _, pd, _ = _both(which)
    jpd, _ = jpr.preprocess(jdata)
    cfg = data.config
    n_lde = data.n << cfg.rate_bits
    num_z = cfg.num_challenges * cfg.num_permutation_chunks
    wires, zs = _rand((cfg.num_wires, n_lde), 11), _rand((num_z, n_lde), 12)
    pis = _rand((len(data.public_input_targets),), 13)
    betas, gammas, alphas = (_rand((cfg.num_challenges,), s) for s in (14, 15, 16))
    got = pr.make_quotient_kernel(pd)(
        gl.from_u64(wires), gl.from_u64(zs), pd.pre_batch.lde, gl.from_u64(pis),
        gl.from_u64(betas), gl.from_u64(gammas), [int(a) for a in alphas])
    want = jpr.make_quotient_kernel(jpd)(
        jgl.from_u64(wires), jgl.from_u64(zs), jpd.pre_batch.lde, jgl.from_u64(pis),
        jgl.from_u64(betas), jgl.from_u64(gammas), jgl.from_u64(alphas))
    assert got.shape == (cfg.num_challenges << cfg.rate_bits, data.n) and _same(got, want)


def test_permutation_polys_of_a_real_witness():
    jdata, _, _, data, _, _, pd, w = _both("chain")
    jpd, _ = jpr.preprocess(jdata)
    wires = w.full_matrix()
    beta, gamma = int(_rand((), 17)), int(_rand((), 18))
    got = pr.compute_permutation_polys(pd, gl.from_u64(wires), beta, gamma)
    assert _same(got, jpr.compute_permutation_polys(jpd, jgl.from_u64(wires), beta, gamma))
    z = gl.to_u64(got[0])
    assert z[0] == 1  # and the grand product closes on a satisfying witness:
    last = pr._perm_core(gl.from_u64(wires[:80]), pd.dev["sigma"], pd.dev["omega_pows"],
                         pd.dev["k_shifts"], pr.scalar_f(beta, "cpu"), pr.scalar_f(gamma, "cpu"), 80)
    assert last.shape == (1, data.n) and torch.equal(last[0], got[0])


def test_opening_specs_and_kernel_cache():
    jdata, _, _, data, _, _, pd, _ = _both("mul_add")
    assert pr.opening_point_specs(data) == jpr.opening_point_specs(jdata)
    assert pr.wire_offsets_used(data) == jpr.wire_offsets_used(jdata)
    assert set(pd.kernels) == {"quotient", "fri_g"}  # made once a circuit, kept for the next proof
    made = pd.kernels["quotient"]
    assert pr._get_kernel(pd, "quotient", lambda: None) is made


# ---------------------------------------------------------------------------
# The committed oracle, the JSON form, the device rule, the profiler
# ---------------------------------------------------------------------------


def test_dryrun_proof_equals_the_committed_reference():
    data, w = chip_smoke.dryrun_circuit()
    pd, vk = pr.preprocess(data, device="cpu")
    z = np.load(os.path.join(REPO, "assets", "dryrun", "pre.npz"))
    assert np.array_equal(vk.pre_cap, z[f"level_{int(z['num_levels'][0]) - 1}"])
    prof = profiler.Profiler(enabled=True)
    got = serialize.proof_to_dict(pr.prove(pd, w, prof=prof), include_indices=True)
    with open(os.path.join(REPO, "assets", "dryrun", "ref_proof.json")) as f:
        text = f.read()
    assert chip_smoke.first_difference(got, json.loads(text)) is None
    assert json.dumps(got) == text  # byte for byte
    phases = set(prof.times)
    assert {"witness_matrix", "witness_upload", "commit_wires", "perm_polys", "commit_zs", "quotient",
            "commit_quotient", "openings", "fri_g_setup", "fri_g_kernel", "fri_folds",
            "fri_final_poly", "fri_pow", "fri_queries"} <= phases
    assert prof._name is None and all(t >= 0.0 for t in prof.times.values())  # prove() ended the last phase


def test_proof_json_round_trip(tmp_path):
    _, _, jdict, _, _, proof, _, _ = _both("chain")
    path = tmp_path / "proof.json"
    serialize.save_proof(str(path), proof)
    back = serialize.load_proof(str(path))
    assert serialize.proof_to_dict(back, include_indices=True) == jdict
    assert "query_indices" not in serialize.proof_to_dict(proof)["fri"]
    jback = jserialize.proof_from_dict(json.loads(path.read_text()))
    carried = convert.proof_from_jax(jback)
    assert serialize.proof_to_dict(carried, include_indices=True) == jdict
    assert isinstance(carried, pr.Proof) and carried.fri_proof.pow_witness == proof.fri_proof.pow_witness


def test_preprocess_names_the_card_by_default():
    data = _both("bool")[3]
    if torch.cuda.is_available():
        pytest.skip("this test is for a machine without a card")
    with pytest.raises((RuntimeError, AssertionError)):
        pr.preprocess(data)  # device="cuda": raises where there is no card
    pd, _ = pr.preprocess(data, device="cpu")
    assert pd.device.type == "cpu" and pd.dev["sigma"].device.type == "cpu"


def test_unsatisfied_witness_fails_the_identity_at_zeta():
    """A witness that breaks a gate still yields a proof (the quotient is
    interpolated over the whole LDE domain), and the identity at zeta, the
    check chip_smoke.py runs at full width, catches it."""
    _, _, _, data, vk, proof, pd, w = _both("mul_add")
    chip_smoke.check_proof(data, vk, proof, w, "good witness")
    forged = copy.deepcopy(w)
    row, col = data.public_input_targets[0]
    forged.values[data.rep[row * data.config.num_wires + col]] += np.uint64(1)
    with pytest.raises(RuntimeError, match="identity"):
        chip_smoke.check_proof(data, vk, pr.prove(pd, forged), forged, "forged witness")
