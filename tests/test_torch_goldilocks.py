"""The port's plain Goldilocks ops against the JAX package's host_field and its
numpy-backend ``gl``, on edge values and seeded random values.  Exact."""

import numpy as np
import pytest
import torch

from eth_lc_plonky2_tpu.ops import goldilocks as jgl
from eth_lc_plonky2_tpu.ops import host_field as hf
from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl

# The suite runs in parallel worker processes: one intra-op thread each keeps
# torch from oversubscribing the cores (a test ran 15x slower without it).
torch.set_num_threads(1)

P = gl.P
EDGE = np.array([0, 1, 2, P - 1, P - 2, 1 << 32, (1 << 32) - 1, 1 << 63, (1 << 63) + 12345,
                 (1 << 64) - (1 << 33), 0x7FFF_FFFF_FFFF_FFFF, 0xDEAD_BEEF_0000_0001],
                dtype=np.uint64)


def _operands():
    rng = np.random.default_rng(7)
    rand = rng.integers(0, P, size=500, dtype=np.uint64)
    vals = np.concatenate([EDGE, rand])
    a = np.concatenate([np.repeat(EDGE, len(EDGE)), rand, rng.permutation(vals)])
    b = np.concatenate([np.tile(EDGE, len(EDGE)), rng.permutation(rand), vals])
    return a, b


A, B = _operands()

BINARY = {
    "add": (gl.add, hf.add, jgl.add),
    "sub": (gl.sub, hf.sub, jgl.sub),
    "mul": (gl.mul, hf.mul, jgl.mul),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_ops_match_host_field_and_numpy_backend(name):
    ours, host, limbs = BINARY[name]
    got = gl.to_u64(ours(gl.from_u64(A), gl.from_u64(B)))
    assert np.array_equal(got, host(A, B))
    assert np.array_equal(got, jgl.to_u64(limbs(jgl.from_u64(A), jgl.from_u64(B))))
    assert (got < np.uint64(P)).all()


@pytest.mark.parametrize("name", ["neg", "square"])
def test_unary_ops_match(name):
    ours = getattr(gl, name)
    want = {"neg": hf.neg(A), "square": hf.mul(A, A)}[name]
    assert np.array_equal(gl.to_u64(ours(gl.from_u64(A))), want)
    assert np.array_equal(want, jgl.to_u64(getattr(jgl, name)(jgl.from_u64(A))))


def test_edge_products_match_python_ints():
    a, b = np.repeat(EDGE, len(EDGE)), np.tile(EDGE, len(EDGE))
    got = gl.to_u64(gl.mul(gl.from_u64(a), gl.from_u64(b)))
    assert [int(v) for v in got] == [(int(x) % P) * (int(y) % P) % P for x, y in zip(a, b)]


def test_inv_and_pow_const():
    nz = A[A % np.uint64(P) != 0][:64]
    inv = gl.to_u64(gl.inv(gl.from_u64(nz)))
    assert np.array_equal(inv, hf.inv(nz))
    assert np.array_equal(hf.mul(inv, nz % np.uint64(P)), np.ones_like(nz))
    for e in (0, 1, 2, 7, 12345, P - 2):
        assert np.array_equal(gl.to_u64(gl.pow_const(gl.from_u64(A[:40]), e)),
                              hf.pow_const(A[:40] % np.uint64(P), e))


def test_conversion_round_trip_and_representation():
    t = gl.from_u64(A)
    assert t.dtype == torch.int64
    assert np.array_equal(gl.to_u64(t), A % np.uint64(P))
    assert gl.from_u64(P - 1).item() == (P - 1) - (1 << 64)  # u64 bits read as int64
    assert gl.from_u64(3).shape == ()


def test_host_scalars_and_powers():
    for log_n in (0, 1, 5, 21, 32):
        assert gl.primitive_root_of_unity(log_n) == jgl.primitive_root_of_unity(log_n)
    for v in (1, 2, 7, P - 1):
        assert gl.h_inv(v) == jgl.h_inv(v)
    for base, n in ((7, 1), (7, 2), (7, 1000), (gl.primitive_root_of_unity(10), 1024)):
        assert np.array_equal(gl.to_u64(gl.powers(base, n, "cpu")), hf.powers(base, n))
