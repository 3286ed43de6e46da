"""The port's batched SHA-256 (``ops/sha256.py`` compress and two_to_one, on
the CPU through their plain versions) against the JAX package's jitted device
functions run as ``tests/test_sha256.py`` runs them, and against hashlib.
Exact: u32 arithmetic has no tolerance.  Also csrc/sha256.cu's algorithm
walked on Python integers with the kernel's own indices and constant image,
and the wrappers' refusals."""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from eth_lc_plonky2_tpu.ops import sha256 as jsha
from eth_lc_plonky2_tpu_torch.eth import ssz
from eth_lc_plonky2_tpu_torch.ops import kernels, sha256 as sha

# The suite runs in parallel worker processes: one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

MASK = 0xFFFFFFFF
EDGE = np.array([0, MASK, 0x80000000], dtype=np.uint32)
FUNCTIONS = {"compress": (sha.compress, jsha.compress, (8, 16)),
             "two_to_one": (sha.two_to_one, jsha.two_to_one, (8, 8))}


def _words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _port(fn, a, b) -> np.ndarray:
    out = fn(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.uint32 and out.device.type == "cpu"
    return out.numpy()


@pytest.mark.parametrize("lead", [(1,), (7,), (1000,), (3, 5)])
@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_matches_the_jax_packages(name, lead):
    port, jax_fn, widths = FUNCTIONS[name]
    rng = np.random.default_rng(sum(lead) + len(name))
    a, b = (_words(rng, (*lead, w)) for w in widths)
    want = np.asarray(jax_fn(a, b))
    assert want.shape == (*lead, 8)
    np.testing.assert_array_equal(_port(port, a, b), want)


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_edge_words_match_the_jax_packages(name):
    """Every pair of the edge words 0, 0xFFFFFFFF and 0x80000000 filling the
    two inputs, and each edge word alone at every place of a seeded input."""
    port, jax_fn, widths = FUNCTIONS[name]
    rng = np.random.default_rng(7)
    rows = [(np.full(widths[0], x, np.uint32), np.full(widths[1], y, np.uint32))
            for x in EDGE for y in EDGE]
    for x in EDGE:
        for at in range(sum(widths)):
            row = _words(rng, (sum(widths),))
            row[at] = x
            rows.append((row[:widths[0]], row[widths[0]:]))
    a = np.stack([r[0] for r in rows])
    b = np.stack([r[1] for r in rows])
    np.testing.assert_array_equal(_port(port, a, b), np.asarray(jax_fn(a, b)))


def test_matches_hashlib():
    """two_to_one of 32 + 32 bytes, and compress from the IV then over the
    padding block, are SHA-256 of the 64 bytes."""
    rng = np.random.default_rng(3)
    msgs = rng.integers(0, 256, size=(9, 64), dtype=np.uint8)
    words = np.stack([sha.words_from_bytes(m.tobytes()) for m in msgs])
    pair = sha.two_to_one(words[:, :8], words[:, 8:]).numpy()
    h1 = sha.compress(np.broadcast_to(sha.IV, (9, 8)), words)
    two = sha.compress(h1, torch.from_numpy(np.broadcast_to(sha.PAD_BLOCK_64B, (9, 16)).copy()))
    for i in range(9):
        want = hashlib.sha256(msgs[i].tobytes()).digest()
        assert sha.bytes_from_words(pair[i]) == want
        assert sha.bytes_from_words(two.numpy()[i]) == want


@pytest.mark.parametrize("height", [1, 2, 3, 4])
def test_zero_leaf_merkle_roots(height):
    """The roots of all-zero leaf trees (upstream's merkle_tree_gadget.rs
    vectors), level by level with two_to_one, as the JAX package's test."""
    layer = [b"\x00" * 32] * (1 << height)
    while len(layer) > 1:
        layer = [hashlib.sha256(layer[i] + layer[i + 1]).digest() for i in range(0, len(layer), 2)]
    words = torch.zeros((1 << height, 8), dtype=torch.uint32)
    jwords = np.zeros((1 << height, 8), dtype=np.uint32)
    while words.shape[0] > 1:
        words = sha.two_to_one(words[0::2], words[1::2])
        jwords = np.asarray(jsha.two_to_one(jwords[0::2], jwords[1::2]))
        np.testing.assert_array_equal(words.numpy(), jwords)
    assert sha.bytes_from_words(words.numpy()[0]) == layer[0]


def test_sync_committee_root_level_by_level():
    """chip_smoke's committee root (two_to_one level by level over the 1,024
    half-key chunks of a seeded 512-key committee, then the aggregate key's
    root and the container) on the CPU equals eth/ssz.sync_committee_root, and
    the JAX package's two_to_one gives every level the same words."""
    rng = np.random.default_rng(11)
    keys = [rng.bytes(48) for _ in range(512)]
    aggregate = rng.bytes(48)
    root = chip_smoke.sha256_committee_root(keys, aggregate, "cpu")
    assert root == ssz.sync_committee_root(keys, aggregate)
    level = np.stack([sha.words_from_bytes(half) for pk in keys for half in ssz.pubkey_leaves(pk)])
    assert level.shape == (1024, 8)
    levels = 0
    while level.shape[0] > 1:
        port = sha.two_to_one(level[0::2], level[1::2]).numpy()
        level = np.asarray(jsha.two_to_one(level[0::2], level[1::2]))
        np.testing.assert_array_equal(port, level)
        levels += 1
    assert levels == 10
    assert sha.bytes_from_words(level[0]) == ssz.merkleize(
        [half for pk in keys for half in ssz.pubkey_leaves(pk)])


def test_kernel_constants_image():
    """csrc/sha256.cu's Sha256Consts: K, K[t] + W[t] of the padding block's
    schedule, the IV; 136 little-endian words."""
    image = np.frombuffer(sha.kernel_constants(), dtype="<u4")
    assert image.shape == (136,)
    np.testing.assert_array_equal(image[:64], jsha.K)
    pad_w = jsha.message_schedule_np(jsha.PAD_BLOCK_64B[None])[0].astype(np.uint64)
    np.testing.assert_array_equal(image[64:128], (jsha.K.astype(np.uint64) + pad_w) & MASK)
    np.testing.assert_array_equal(image[128:], jsha.IV)


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & MASK


def _walk_round(v: list, r: int, kw: int) -> None:
    """csrc/sha256.cu's sha_round on Python integers, with its indices."""
    a, b, c = v[(0 - r) & 7], v[(1 - r) & 7], v[(2 - r) & 7]
    e, f, g = v[(4 - r) & 7], v[(5 - r) & 7], v[(6 - r) & 7]
    choose = g ^ (e & (f ^ g))
    majority = (a & b) | (c & (a | b))
    t1 = (v[(7 - r) & 7] + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) + choose + kw) & MASK
    v[(3 - r) & 7] = (v[(3 - r) & 7] + t1) & MASK
    v[(7 - r) & 7] = (t1 + (_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) + majority) & MASK


def _walk_compress(s: list, w: list, k: list) -> list:
    """csrc/sha256.cu's compress: 16 rounds on the block, then bodies of 16
    rounds that overwrite the rolling window in place."""
    v, w = list(s), list(w)
    for i in range(16):
        _walk_round(v, i, (k[i] + w[i]) & MASK)
    for t in range(16, 64, 16):
        for i in range(16):
            x, y = w[(i + 1) & 15], w[(i + 14) & 15]
            s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)
            s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10)
            w[i] = (w[i] + s1 + w[(i + 9) & 15] + s0) & MASK
            _walk_round(v, i, (k[t + i] + w[i]) & MASK)
    return [(s[i] + v[i]) & MASK for i in range(8)]


def _walk_padding(s: list, pad_kw: list) -> list:
    """csrc/sha256.cu's compress_padding: the rounds on the table alone."""
    v = list(s)
    for t in range(0, 64, 16):
        for i in range(16):
            _walk_round(v, i, pad_kw[t + i])
    return [(s[i] + v[i]) & MASK for i in range(8)]


def test_kernel_walk_equals_the_jax_packages():
    """The kernels' algorithm, walked on Python integers with their indices
    and their constant image, on seeded and edge rows: compress equals the
    JAX package's compress, two_to_one its two_to_one."""
    image = [int(x) for x in np.frombuffer(sha.kernel_constants(), dtype="<u4")]
    k, pad_kw, iv = image[:64], image[64:128], image[128:]
    rng = np.random.default_rng(5)
    state, block, left, right = (_words(rng, (6, w)) for w in (8, 16, 8, 8))
    for arr in (state, block, left, right):
        arr[:3] = EDGE[:, None]
    want_c = np.asarray(jsha.compress(state, block))
    want_t = np.asarray(jsha.two_to_one(left, right))
    for i in range(6):
        assert _walk_compress(state[i].tolist(), block[i].tolist(), k) == want_c[i].tolist()
        h1 = _walk_compress(iv, left[i].tolist() + right[i].tolist(), k)
        assert _walk_padding(h1, pad_kw) == want_t[i].tolist()


def test_int32_and_numpy_inputs_and_no_launch_on_the_cpu():
    """torch.int32 words are read as u32; numpy input gives a CPU result, as
    the JAX function takes it; a CPU tensor never reaches a kernel."""
    rng = np.random.default_rng(9)
    left, right = _words(rng, (33, 8)), _words(rng, (33, 8))
    before = dict(kernels.launches)
    want = sha.two_to_one_plain(torch.from_numpy(left), torch.from_numpy(right))
    as_int32 = sha.two_to_one(torch.from_numpy(left.view(np.int32)),
                              torch.from_numpy(right.view(np.int32)))
    from_numpy = sha.two_to_one(left, right.tolist())
    for got in (as_int32, from_numpy):
        assert got.dtype == torch.uint32 and got.device.type == "cpu"
        assert torch.equal(got, want)
    assert kernels.launches == before


def _u32(shape, offset: int = 0) -> torch.Tensor:
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.uint32)[offset:].view(shape)


# each case: the two arguments given the second one's width, and the refusal
REFUSED = {
    "int64 words": (lambda w: (_u32((4, 8)).to(torch.int64), _u32((4, w))), "torch.int64"),
    "one word short": (lambda w: (_u32((4, 8)), _u32((4, w - 1))), r"shape \(\.\.\., "),
    "other leading shapes": (lambda w: (_u32((4, 8)), _u32((5, w))), "rows of one batch"),
    "a strided view": (lambda w: (_u32((4, 16))[:, ::2], _u32((4, w))), "contiguous"),
    "a start 4 bytes off": (lambda w: (_u32((4, 8), offset=1), _u32((4, w))), "16-byte"),
    "CPU tensors": (lambda w: (_u32((4, 8)), _u32((4, w))), "CUDA tensors"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_kernel_wrappers_refuse(case):
    """The wrappers check dtype, shape, contiguity and alignment before the
    device, so each refusal shows here on the CPU; nothing is launched."""
    make, match = REFUSED[case]
    before = kernels.launches["sha256"]
    for wrapper, width in ((kernels.sha256_compress, 16), (kernels.sha256_two_to_one, 8)):
        with pytest.raises(ValueError, match=match):
            wrapper(*make(width))
    assert kernels.launches["sha256"] == before


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_plain_versions_refuse_wrong_words(name):
    port, _, widths = FUNCTIONS[name]
    good = (_u32((3, widths[0])), _u32((3, widths[1])))
    for a, b in ((good[0].to(torch.int64), good[1]), (good[0], good[1][:, 1:]),
                 (good[0][:2], good[1])):
        with pytest.raises(ValueError):
            port(a, b)
