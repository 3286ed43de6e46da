"""The port's Poseidon (plain path on the CPU) against the JAX package's
``ops/poseidon.py`` host references.  Exact."""

import numpy as np
import pytest
import torch

from eth_lc_plonky2_tpu.ops import poseidon as jpos
from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.ops import kernels, poseidon as pos

# The suite runs in parallel worker processes: one intra-op thread each keeps
# torch from oversubscribing the cores (a test ran 15x slower without it).
torch.set_num_threads(1)

P = gl.P


def _rand(shape, seed):
    x = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    x.reshape(-1)[0] = P - 1
    return x


def test_constants_match():
    assert np.array_equal(pos.round_constants(), jpos.round_constants())
    assert pos.MDS_CIRC == jpos.MDS_CIRC and pos.MDS_DIAG == jpos.MDS_DIAG
    assert (pos.WIDTH, pos.N_FULL_ROUNDS, pos.N_PARTIAL_ROUNDS, pos.SPONGE_RATE) == (
        jpos.WIDTH, jpos.N_FULL_ROUNDS, jpos.N_PARTIAL_ROUNDS, jpos.SPONGE_RATE)
    # the kernel's constant image: 8 x 12 full-round constants, the sparse
    # tables (12 + 11 x 11 + 22 + 22 x 12 + 22 x 11 words), then 6 + 6 + 2 32-bit words
    assert len(pos.kernel_constants()) == (96 + 12 + 121 + 22 + 264 + 242) * 8 + (6 + 6 + 2) * 4


def _edge_states():
    """Seeded states whose first rows are all 0, all 1, all p - 1, all 2^32 - 1,
    and one row mixing those words."""
    st = _rand((24, 12), 21)
    for row, word in enumerate((0, 1, P - 1, 2**32 - 1)):
        st[row] = word
    st[4] = [0, 1, P - 1, 2**32 - 1] * 3
    return st


def test_sparse_tables_shape_and_range():
    sp = pos.sparse_partial_rounds()
    assert len(sp.first_constants) == 12 and len(sp.scalars) == 22 and sp.scalars[-1] == 0
    assert len(sp.init_matrix) == 11 and all(len(r) == 11 for r in sp.init_matrix)
    assert len(sp.w_hat) == len(sp.v) == 22 and all(len(r) == 11 for r in sp.w_hat + sp.v)
    assert sp.m00 == pos.MDS_CIRC[0] + pos.MDS_DIAG[0]
    words = [sp.m00, *sp.first_constants, *sp.scalars,
             *(x for rows in (sp.init_matrix, sp.w_hat, sp.v) for r in rows for x in r)]
    assert all(0 <= x < P for x in words)
    # the last round's column is the MDS matrix's own first column
    assert list(sp.v[-1]) == [row[0] for row in pos.mds_matrix()[1:]]


def test_split_linear_layer_matches_the_matrix():
    """The kernel's linear layer: two length-6 correlations of sums and
    differences on 16-bit limbs, with the constants of the kernel's image,
    give the dense matrix's rows exactly, and every intermediate fits 32 bits."""
    image = pos.kernel_constants()
    tail = np.frombuffer(image[-56:], dtype=np.int32)
    c_sum, c_diff, diag0 = tail[:6].tolist(), tail[6:12].tolist(), int(tail[12])
    m = pos.mds_matrix()
    for row in _edge_states().tolist() + [[2**64 - 1] * 12]:
        want = [sum(m[r][i] * row[i] for i in range(12)) for r in range(12)]
        got = [0] * 12
        for limb in range(4):
            part = [(x >> (16 * limb)) & 0xFFFF for x in row]
            a = [part[j] + part[j + 6] for j in range(6)]
            b = [part[j] - part[j + 6] for j in range(6)]
            for r in range(6):
                p = sum(c_sum[i] * a[(r + i) % 6] for i in range(6))
                q = sum((1 if r + i < 6 else -1) * c_diff[i] * b[(r + i) % 6] for i in range(6))
                assert abs(p) < 2**31 and abs(q) < 2**31 and (p + q) % 2 == 0
                lo, hi = (p + q) // 2 + (diag0 * part[0] if r == 0 else 0), (p - q) // 2
                assert 0 <= lo < 2**27 and 0 <= hi < 2**27
                got[r] += lo << (16 * limb)
                got[r + 6] += hi << (16 * limb)
        assert got == want


@pytest.mark.parametrize("case", ["dense", "jax"])
def test_sparse_permute_matches(case):
    """The sparse partial rounds (the CUDA kernel's arithmetic) are the same
    permutation as the dense plain version and the JAX package's."""
    st = _edge_states()
    got = gl.to_u64(pos.permute(gl.from_u64(st), sparse=True))
    if case == "dense":
        assert np.array_equal(got, gl.to_u64(pos.permute(gl.from_u64(st))))
    else:
        assert np.array_equal(got, jpos.permute_np(st))


@pytest.mark.parametrize("length", [4, 8, 20, 184])
def test_sparse_hash_no_pad_matches(length):
    rows = _rand((9, length), 40 + length)
    rows[1] = P - 1
    got = gl.to_u64(pos._hash_plain(gl.from_u64(rows), pos._permute_sparse_cf))
    assert np.array_equal(got, jpos.hash_no_pad_np(rows))
    assert np.array_equal(got, gl.to_u64(pos.hash_no_pad(gl.from_u64(rows))))


@pytest.mark.parametrize("n,cap_height", [(16, 0), (32, 4), (1024, 0), (2048, 4)])
def test_compress_tail_matches_level_by_level(n, cap_height):
    """The one-launch tail of a tree is, on the CPU, the same levels one by one."""
    level = gl.from_u64(_rand((n, 4), n))
    num = (n.bit_length() - 1) - cap_height
    tail = pos.compress_tail(level, num)
    assert [t.shape[0] for t in tail] == [n >> (k + 1) for k in range(num)]
    cur = level
    for t in tail:
        cur = pos.compress_level(cur)
        assert torch.equal(t, cur)


def test_permute_matches_permute_np():
    st = _rand((64, 12), 1)
    st[1] = 0
    st[2] = P - 1
    assert np.array_equal(gl.to_u64(pos.permute(gl.from_u64(st))), jpos.permute_np(st))
    assert [int(v) for v in gl.to_u64(pos.permute(gl.from_u64(st[3])))] == jpos.permute_host(
        [int(v) for v in st[3]])


@pytest.mark.parametrize("length", [4, 8, 16, 20, 96, 184])
def test_hash_no_pad_matches(length):
    rows = _rand((37, length), 10 + length)
    got = gl.to_u64(pos.hash_no_pad(gl.from_u64(rows)))
    assert np.array_equal(got, jpos.hash_no_pad_np(rows))
    # channel-first input read through a transposed view, as a commitment does
    cf = gl.from_u64(np.ascontiguousarray(rows.T))
    assert np.array_equal(gl.to_u64(pos.hash_no_pad(cf.T)), got)


def test_hash_batch_axes():
    x = gl.from_u64(_rand((2, 3, 20), 5))
    assert torch.equal(pos.hash_no_pad(x)[1, 2], pos.hash_no_pad(x[1, 2]))


def test_compress_and_level_compression_match():
    left, right = _rand((33, 4), 2), _rand((33, 4), 3)
    want = jpos.compress_np(left, right)
    assert np.array_equal(gl.to_u64(pos.compress(gl.from_u64(left), gl.from_u64(right))), want)
    level = np.empty((66, 4), dtype=np.uint64)
    level[0::2], level[1::2] = left, right
    assert np.array_equal(gl.to_u64(pos.compress_level(gl.from_u64(level))), want)


def test_launcher_refuses_cpu_tensors():
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        kernels.poseidon_sponge(torch.zeros(4, 8, dtype=torch.int64), pos.kernel_constants())
    with pytest.raises(ValueError):
        kernels.merkle_tail(torch.zeros(8, 4, dtype=torch.int64), 2, pos.kernel_constants())
    assert kernels.launches == before
