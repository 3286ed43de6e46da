"""The rest of the port's field layer against the JAX package (numpy backend):
``mul_small / eq / select`` and the constructors, every ``goldilocks_ext``
function, ``powers_device / roll_lde / sum_field / prod_field / eval_poly``,
the host hash mirrors, the port's copy of ``host_field``, and the addressing
plan of the field kernel's launcher.  Same numpy-seeded inputs through both;
every comparison is exact."""

import numpy as np
import pytest
import torch

from eth_lc_plonky2_tpu.ops import goldilocks as jgl
from eth_lc_plonky2_tpu.ops import goldilocks_ext as jge
from eth_lc_plonky2_tpu.ops import host_field as jhf
from eth_lc_plonky2_tpu.ops import ntt as jntt
from eth_lc_plonky2_tpu.ops import poseidon as jpos
from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.ops import goldilocks_ext as ge
from eth_lc_plonky2_tpu_torch.ops import host_field as hf
from eth_lc_plonky2_tpu_torch.ops import kernels
from eth_lc_plonky2_tpu_torch.ops import ntt
from eth_lc_plonky2_tpu_torch.ops import poseidon as pos

torch.set_num_threads(1)

P = gl.P
EDGE = np.array([0, 1, 2, P - 1, P - 2, 1 << 32, (1 << 32) - 1, 1 << 63, 0xFFFF_FFFF_0000_0000],
                dtype=np.uint64)


def _rand(shape, seed):
    x = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    flat = x.reshape(-1)
    flat[: min(len(EDGE), flat.size)] = EDGE[: flat.size]
    return x


def _t(a):
    return gl.from_u64(a)


def _same(torch_field, jax_field):
    return np.array_equal(gl.to_u64(torch_field), jgl.to_u64(jax_field))


def _ext_same(torch_ext, jax_ext):
    return _same(torch_ext[0], jax_ext[0]) and _same(torch_ext[1], jax_ext[1])


# ---------------------------------------------------------------------------
# goldilocks: the rest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [0, 1, 2, 7, 255, 65535])
def test_mul_small(k):
    a = _rand((300,), 1)
    assert _same(gl.mul_small(_t(a), k), jgl.mul_small(jgl.from_u64(a), k))


def test_mul_small_rejects_large_constants():
    with pytest.raises(ValueError):
        gl.mul_small(_t(_rand((4,), 1)), 1 << 16)


def test_eq_and_select():
    a, b = _rand((200,), 2), _rand((200,), 3)
    b[::3] = a[::3]
    cond = np.asarray(jgl.eq(jgl.from_u64(a), jgl.from_u64(b)))
    got = gl.eq(_t(a), _t(b))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), cond)
    assert _same(gl.select(got, _t(a), _t(b)),
                 jgl.select(cond, jgl.from_u64(a), jgl.from_u64(b)))


@pytest.mark.parametrize("value", [0, 1, 7, P - 1, P, (1 << 63) + 5])
def test_constructors(value):
    assert _same(gl.zeros((3, 2), "cpu"), jgl.zeros((3, 2)))
    assert _same(gl.ones((3, 2), "cpu"), jgl.ones((3, 2)))
    assert _same(gl.full((3, 2), value, "cpu"), jgl.full((3, 2), value))
    assert gl.full((2,), value, "cpu").device.type == "cpu"


def test_host_scalars():
    for a, b in ((3, 5), (P - 1, P - 1), (1 << 63, 12345)):
        assert gl.h_mul(a, b) == jgl.h_mul(a, b)
        assert gl.h_add(a, b) == jgl.h_add(a, b)
        assert gl.h_pow(a, b) == jgl.h_pow(a, b)


@pytest.mark.parametrize("base,n", [(7, 1), (7, 2), (7, 1000), (3, 1024), (P - 1, 5)])
def test_powers_takes_a_device(base, n):
    got = gl.powers(base, n, "cpu")
    assert got.device.type == "cpu" and np.array_equal(gl.to_u64(got), jhf.powers(base, n))
    assert ntt._powers_on(base, n, "cpu") is ntt._powers_on(base, n, "cpu")  # the one cache


def test_plain_ops_are_what_a_cpu_tensor_runs():
    a, b = _t(_rand((64,), 4)), _t(_rand((64,), 5))
    before = dict(kernels.launches)
    for op, plain in ((gl.add, gl.add_plain), (gl.sub, gl.sub_plain), (gl.mul, gl.mul_plain)):
        assert torch.equal(op(a, b), plain(a, b))
    assert torch.equal(gl.inv(a), gl.inv_plain(a))
    assert torch.equal(gl.neg(a), gl.sub_plain(torch.zeros_like(a), a))
    assert kernels.launches == before  # no kernel for a CPU tensor


@pytest.mark.parametrize("name", ["add", "sub", "mul", "inv", "pow_const", "powers"])
def test_host_field_copy_matches_original(name):
    a, b = _rand((100,), 6), _rand((100,), 7)
    if name in ("add", "sub", "mul"):
        assert np.array_equal(getattr(hf, name)(a, b), getattr(jhf, name)(a, b))
    elif name == "inv":
        assert np.array_equal(hf.inv(a[10:]), jhf.inv(a[10:]))
        assert np.array_equal(hf.batch_inv(a[10:30]), jhf.batch_inv(a[10:30]))
    elif name == "pow_const":
        assert np.array_equal(hf.pow_const(a, 12345), jhf.pow_const(a, 12345))
    else:
        assert np.array_equal(hf.powers(7, 777), jhf.powers(7, 777))


# ---------------------------------------------------------------------------
# The field kernel's addressing plan, rehearsed on the CPU
# ---------------------------------------------------------------------------


def _run_plan(a, b, plain):
    """What one launch of field_binary_kernel computes, from the launcher's
    plan: out[r, c] = op(a_words[r * a_r + c * a_c], b_words[r * b_r + c * b_c])."""
    shape, ea, eb, rows, cols, a_r, a_c, b_r, b_c = kernels.field_binary_plan(a, b)
    av = torch.as_strided(ea, (rows, cols), (a_r, a_c), ea.storage_offset())
    bv = torch.as_strided(eb, (rows, cols), (b_r, b_c), eb.storage_offset())
    return plain(av, bv).reshape(shape)


FORMS = {
    "same shape": lambda a, b: (a, b),
    "scalar": lambda a, b: (a, b[2, 0]),
    "scalar first": lambda a, b: (a[0, 0], b),
    "row": lambda a, b: (a, b[:1]),
    "column": lambda a, b: (a, b[:, :1]),
    "row against column": lambda a, b: (a[:1], b[:, :1]),
    "1-D row": lambda a, b: (a, b[3]),
    "strided columns": lambda a, b: (a[:, ::2], b[:, 1::2]),
    "strided rows": lambda a, b: (a[::2], b[1::2]),
    "3-D by column": lambda a, b: (a.reshape(2, 3, -1), b[:3, :1]),
    "3-D slice across two axes": lambda a, b: (a.reshape(2, 3, -1)[:, :2], b.reshape(2, 3, -1)[:, 1:]),
    "column of a narrow array": lambda a, b: (a.T[:, :1], b.T[:, 1:2]),
    "narrow last axis": lambda a, b: (a.T.contiguous(), b.T.contiguous()),
    "0-d": lambda a, b: (a[1, 1], b[2, 2]),
    "odd word offset": lambda a, b: (a.reshape(-1)[1:], b.reshape(-1)[1:]),
    "one operand at an odd offset": lambda a, b: (a.reshape(-1)[:-1], b.reshape(-1)[1:]),
    "odd offset against one word": lambda a, b: (a.reshape(-1)[3:], b[1, 0]),
    "odd length": lambda a, b: (a.reshape(-1)[:-1], b.reshape(-1)[:-1]),
    "one word broadcast by expand": lambda a, b: (a.reshape(-1), b[2, 3:4].expand(60)),
    "strided 1-D": lambda a, b: (a.reshape(-1)[::3], b.reshape(-1)[1::3]),
    "column at an odd offset": lambda a, b: (a.T[1:, :1], b.T[1:, 1:2]),
    "empty": lambda a, b: (a[:0], b[:0]),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_field_launcher_plan_addresses_every_broadcast_form(form):
    a, b = _t(_rand((6, 10), 8)), _t(_rand((6, 10), 9))
    u, v = FORMS[form](a, b)
    for plain in (gl.add_plain, gl.sub_plain, gl.mul_plain):
        assert torch.equal(_run_plan(u, v, plain), plain(u, v))
    shape, _, _, rows, cols, *strides = kernels.field_binary_plan(u, v)
    assert rows * cols == int(np.prod(shape)) and min(strides) >= 0


def test_fermat_chain_of_the_inverse_kernel():
    """csrc/field.cu's addition chain, on Python integers: the exponent is p - 2."""
    sq = lambda e, k: e << k  # noqa: E731  (exponent after k squarings)
    t2 = sq(1, 1) + 1
    t3 = sq(t2, 1) + 1
    t6 = sq(t3, 3) + t3
    t12 = sq(t6, 6) + t6
    t24 = sq(t12, 12) + t12
    t30 = sq(t24, 6) + t6
    t31 = sq(t30, 1) + 1
    t63 = sq(t31, 32) + t31
    assert sq(t63, 1) + 1 == P - 2


# ---------------------------------------------------------------------------
# goldilocks_ext
# ---------------------------------------------------------------------------


def _ext_pair(seed, shape=(50,)):
    a0, a1 = _rand(shape, seed), _rand(shape, seed + 100)
    return ge.from_u64_pair(a0, a1), jge.from_u64_pair(a0, a1)


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_ext_binary(name):
    (x, jx), (y, jy) = _ext_pair(1), _ext_pair(2)
    assert _ext_same(getattr(ge, name)(x, y), getattr(jge, name)(jx, jy))


@pytest.mark.parametrize("name", ["neg", "square", "inv"])
def test_ext_unary(name):
    x, jx = _ext_pair(3)
    assert _ext_same(getattr(ge, name)(x), getattr(jge, name)(jx))


def test_ext_inverse_is_an_inverse():
    x, _ = _ext_pair(4)
    prod = ge.mul(x, ge.inv(x))
    assert ge.eq(prod, ge.ones((50,), "cpu"))[1:].all()  # element 0 is the zero of the edge words


def test_ext_mul_base_pow_eq_select_and_embeddings():
    (x, jx), (y, jy) = _ext_pair(5), _ext_pair(6)
    s = _rand((50,), 7)
    assert _ext_same(ge.mul_base(x, _t(s)), jge.mul_base(jx, jgl.from_u64(s)))
    for e in (0, 1, 5, 1000):
        assert _ext_same(ge.pow_const(x, e), jge.pow_const(jx, e))
    cond = np.arange(50) % 3 == 0
    assert _ext_same(ge.select(torch.from_numpy(cond), x, y), jge.select(cond, jx, jy))
    mixed = ge.select(torch.from_numpy(cond), x, y)
    assert np.array_equal(ge.eq(mixed, x).numpy(), np.asarray(jge.eq(jge.select(cond, jx, jy), jx)))
    assert _ext_same(ge.from_base(_t(s)), jge.from_base(jgl.from_u64(s)))
    assert _ext_same(ge.zeros((4,), "cpu"), jge.zeros((4,)))
    assert _ext_same(ge.ones((4,), "cpu"), jge.ones((4,)))
    assert all(np.array_equal(a, b) for a, b in zip(ge.to_u64_pair(x), jge.to_u64_pair(jx)))
    assert ge.W == jge.W


@pytest.mark.parametrize("n", [1, 2, 3, 64, 100])
def test_ext_powers_device(n):
    z = (123456789, P - 5)
    got = ge.powers_device((gl.from_u64(z[0]), gl.from_u64(z[1])), n)
    want = jge.powers_device((jgl.from_u64(np.uint64(z[0])), jgl.from_u64(np.uint64(z[1]))), n)
    assert got[0].shape == (n,) and _ext_same(got, want)


def test_ext_host_scalars():
    x, y = (3, P - 2), (1 << 40, 7)
    assert ge.h_mul(x, y) == jge.h_mul(x, y)
    assert ge.h_add(x, y) == jge.h_add(x, y)
    assert ge.h_sub(x, y) == jge.h_sub(x, y)
    assert ge.h_inv(x) == jge.h_inv(x) and ge.h_mul(x, ge.h_inv(x)) == (1, 0)
    assert ge.h_pow(x, 1234) == jge.h_pow(x, 1234)


# ---------------------------------------------------------------------------
# ntt: powers, rolls, reductions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 5, 128])
def test_powers_device(n):
    x = P - 12345
    assert _same(ntt.powers_device(gl.from_u64(x), n),
                 jntt.powers_device(jgl.from_u64(np.uint64(x)), n))


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_roll_lde(offset):
    a = _rand((3, 64), 11)
    assert _same(ntt.roll_lde(_t(a), offset, 3), jntt.roll_lde(jgl.from_u64(a), offset, 3))


@pytest.mark.parametrize("shape,axis", [((7, 16), 0), ((7, 16), -1), ((5, 1), 1), ((3, 4, 9), 1),
                                        ((16,), 0)])
def test_sum_field(shape, axis):
    a = _rand(shape, 12)
    assert _same(ntt.sum_field(_t(a), axis), jntt.sum_field(jgl.from_u64(a), axis))


@pytest.mark.parametrize("shape,axis", [((8, 16), 0), ((3, 8, 5), 1), ((4, 2), -1), ((1, 6), 0)])
def test_prod_field(shape, axis):
    a = _rand(shape, 13)
    assert _same(ntt.prod_field(_t(a), axis), jntt.prod_field(jgl.from_u64(a), axis))


def test_eval_poly():
    coeffs, x = _rand((4, 33), 14), 0xDEAD_BEEF_1234
    assert _same(ntt.eval_poly(_t(coeffs), gl.from_u64(x)),
                 jntt.eval_poly(jgl.from_u64(coeffs), jgl.from_u64(np.uint64(x))))


# ---------------------------------------------------------------------------
# poseidon: host mirrors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_permute_host(seed):
    state = [int(v) for v in _rand((12,), 20 + seed)]
    assert pos.permute_host(state) == jpos.permute_host(state)
    on_tensors = gl.to_u64(pos.permute(gl.from_u64(np.array(state, dtype=np.uint64))))
    assert pos.permute_host(state) == [int(v) for v in on_tensors]


@pytest.mark.parametrize("length", [1, 2, 8, 9, 20])
def test_hash_and_compress_host(length):
    xs = [int(v) for v in _rand((length,), 30 + length)]
    assert pos.hash_no_pad_host(xs) == jpos.hash_no_pad_host(xs)
    left, right = xs[:4] + [0] * (4 - len(xs[:4])), [5, 6, 7, P - 1]
    assert pos.compress_host(left, right) == jpos.compress_host(left, right)
