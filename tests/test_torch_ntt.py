"""The port's NTT functions (plain path on the CPU) against the JAX package's
``ops/ntt.py`` on its numpy backend, at log n 1..12, batch 3.  Exact."""

import numpy as np
import pytest
import torch

from eth_lc_plonky2_tpu.ops import goldilocks as jgl
from eth_lc_plonky2_tpu.ops import ntt as jntt
from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.ops import kernels, ntt

# The suite runs in parallel worker processes: one intra-op thread each keeps
# torch from oversubscribing the cores (a test ran 15x slower without it).
torch.set_num_threads(1)

LOGS = list(range(1, 13))


def _values(log_n: int) -> np.ndarray:
    rng = np.random.default_rng(100 + log_n)
    x = rng.integers(0, gl.P, size=(3, 1 << log_n), dtype=np.uint64)
    x[0, 0] = gl.P - 1
    x[1, :] = gl.P - 1
    return x


CASES = {
    "ntt": (lambda t: ntt.ntt(t), lambda f: jntt.ntt(f)),
    "intt": (lambda t: ntt.intt(t), lambda f: jntt.intt(f)),
    "coset_lde": (lambda t: ntt.coset_lde(t, 3), lambda f: jntt.coset_lde(f, 3)),
    "coset_intt": (lambda t: ntt.coset_intt(t, 3), lambda f: jntt.coset_intt(f, 3)),
}


@pytest.mark.parametrize("log_n", LOGS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_package(name, log_n):
    ours, ref = CASES[name]
    x = _values(log_n)
    got = gl.to_u64(ours(gl.from_u64(x)))
    assert np.array_equal(got, jgl.to_u64(ref(jgl.from_u64(x))))


@pytest.mark.parametrize("log_n", [1, 6, 12])
def test_round_trips_and_out_argument(log_n):
    x = gl.from_u64(_values(log_n))
    assert torch.equal(ntt.intt(ntt.ntt(x)), x)
    assert torch.equal(ntt.coset_intt(ntt.coset_lde(x, 0), 0), x)
    out = torch.empty_like(x)
    assert ntt.ntt(x, out=out) is out and torch.equal(out, ntt.ntt(x))
    big = torch.empty(x.shape[0], x.shape[1] << 3, dtype=torch.int64)
    assert torch.equal(ntt.coset_lde(x, 3, out=big), ntt.coset_lde(x, 3))


def test_batch_axes_and_length_one():
    x = gl.from_u64(np.random.default_rng(1).integers(0, gl.P, size=(2, 3, 16), dtype=np.uint64))
    assert torch.equal(ntt.ntt(x)[1, 2], ntt.ntt(x[1, 2]))
    one = gl.from_u64(np.array([[5], [gl.P - 1]], dtype=np.uint64))
    assert torch.equal(ntt.ntt(one), one)
    with pytest.raises(ValueError):
        ntt.ntt(torch.zeros(3, 12, dtype=torch.int64))


def test_launcher_refuses_cpu_tensors():
    x = torch.zeros(2, 8, dtype=torch.int64)
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        kernels.ntt_pass(x, x, total=2, K=1, in_strides=(8, 0, 1), out_strides=(8, 0, 1),
                         tw=x[0], log_m=3)
    assert kernels.launches == before


def _planned(x, out, **kw):
    """Run the launches ``ops/ntt.py`` plans for the card through the plain
    version of one launch: the same strides, tables and padding counts."""
    ntt._ntt_kernel(x, out, launch=ntt.ntt_pass_plain, **kw)
    return out


@pytest.mark.parametrize("log_n", list(range(3, 15)))
def test_fused_padding_plan_matches_coset_lde_plain(log_n):
    """The LDE as the card runs it: the first pass reads only the n
    coefficients (scaled by shift^i), skips the stages the zero padding turns
    into copies, and nothing is zero filled or copied."""
    x = gl.from_u64(_values(log_n))
    n = 1 << log_n
    out = torch.full((3, n << 3), -1, dtype=torch.int64)
    passes = ntt._passes(x, out, False, in_tab=ntt._powers_on(7, n, "cpu"), log_pad=3)
    assert len(passes) == (1 if log_n + 3 <= 11 else 2)
    assert passes[0][0] is x and passes[0][2]["log_pad"] == 3
    assert passes[0][2]["in_strides"][0] == n  # rows of n words, not 8n
    got = _planned(x, out, inverse=False, in_tab=ntt._powers_on(7, n, "cpu"), log_pad=3)
    assert torch.equal(got, ntt.coset_lde_plain(x, 3, 7))


@pytest.mark.parametrize("log_n", [1, 5, 11, 12, 13, 14])
@pytest.mark.parametrize("name", ["ntt", "intt", "coset_intt", "coset_lde_rate1"])
def test_planned_passes_match_plain(name, log_n):
    x = gl.from_u64(_values(log_n))
    n = 1 << log_n
    if name == "ntt":
        got, want = _planned(x, torch.empty_like(x), inverse=False), ntt.ntt_plain(x)
    elif name == "intt":
        got, want = _planned(x, torch.empty_like(x), inverse=True), ntt.ntt_plain(x, inverse=True)
    elif name == "coset_intt":
        got = _planned(x, torch.empty_like(x), inverse=True,
                       out_tab=ntt._powers_on(gl.h_inv(7), n, "cpu"))
        want = ntt.coset_intt_plain(x, 7)
    else:
        got = _planned(x, torch.empty((3, 2 * n), dtype=torch.int64), inverse=False,
                       in_tab=ntt._powers_on(7, n, "cpu"), log_pad=1)
        want = ntt.coset_lde_plain(x, 1, 7)
    assert torch.equal(got, want)


def test_plan_refuses_what_two_passes_cannot_pad():
    x = torch.zeros(1, 2, dtype=torch.int64)
    with pytest.raises(ValueError):
        ntt._passes(x, torch.zeros(1, 1 << 13, dtype=torch.int64), False, log_pad=12)
