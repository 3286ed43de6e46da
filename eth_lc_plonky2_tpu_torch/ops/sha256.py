"""Batched SHA-256: the host (numpy) functions and the device compression.

The port of ``eth_lc_plonky2_tpu/ops/sha256.py`` (it keeps its own copy of
the constants).  Three roles:
  1. plain hashing on the host (SSZ tree roots, Merkle expected values);
  2. the witness-generation pass for the in-circuit SHA-256 gate: one
     batched trace over ALL compressions at once (``compress_trace_np``);
  3. batched hashing on the card: ``compress`` and ``two_to_one``, the JAX
     package's jitted device functions.  A CUDA tensor runs
     ``csrc/sha256.cu`` (``kernels.sha256_compress`` /
     ``kernels.sha256_two_to_one``, one thread a message) or raises; a CPU
     tensor, or numpy input, runs the plain PyTorch versions
     ``compress_plain`` / ``two_to_one_plain`` on the CPU.  No prove calls
     them: the witness takes the numpy half.

All functions operate on big-endian u32 words (the layout the circuit
gadget uses: a Hash256 is 8 u32 words).  On the torch side a word is
``torch.uint32`` (``torch.int32`` is read as such); the plain versions hold
each word in int64 and mask it to 32 bits after every add and shift, since
the CPU's ``torch.uint32`` has no arithmetic.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import kernels

# fmt: off
K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208, 0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

IV = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a, 0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)
# fmt: on

# The constant second block of a two-to-one hash: 64-byte message is one full
# block; block 2 is 0x80 padding + bit-length 512.
PAD_BLOCK_64B = np.array([0x80000000] + [0] * 14 + [512], dtype=np.uint32)


def _rotr_np(x, n):
    return ((x >> np.uint32(n)) | (x << np.uint32(32 - n))).astype(np.uint32)


def _shr_np(x, n):
    return (x >> np.uint32(n)).astype(np.uint32)


def message_schedule_np(block: np.ndarray) -> np.ndarray:
    """Expand (N, 16) block words to the full (N, 64) schedule W."""
    block = np.asarray(block, dtype=np.uint32)
    n = block.shape[0]
    w = np.zeros((n, 64), dtype=np.uint32)
    w[:, :16] = block
    for t in range(16, 64):
        s0 = _rotr_np(w[:, t - 15], 7) ^ _rotr_np(w[:, t - 15], 18) ^ _shr_np(w[:, t - 15], 3)
        s1 = _rotr_np(w[:, t - 2], 17) ^ _rotr_np(w[:, t - 2], 19) ^ _shr_np(w[:, t - 2], 10)
        w[:, t] = w[:, t - 16] + s0 + w[:, t - 7] + s1
    return w


def compress_np(state: np.ndarray, block: np.ndarray) -> np.ndarray:
    """Batched compression: state (N,8), block (N,16) -> new state (N,8)."""
    state = np.asarray(state, dtype=np.uint32)
    w = message_schedule_np(block)
    a, b, c, d, e, f, g, h = (state[:, i].copy() for i in range(8))
    for t in range(64):
        s1 = _rotr_np(e, 6) ^ _rotr_np(e, 11) ^ _rotr_np(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + K[t] + w[:, t]
        s0 = _rotr_np(a, 2) ^ _rotr_np(a, 13) ^ _rotr_np(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        h, g, f, e, d, c, b, a = g, f, e, (d + t1).astype(np.uint32), c, b, a, (t1 + t2).astype(np.uint32)
    out = np.stack([a, b, c, d, e, f, g, h], axis=1) + state
    return out.astype(np.uint32)


def two_to_one_np(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """SHA-256 of the 64-byte concatenation of two 32-byte hashes.

    left/right: (N, 8) u32 big-endian words: the semantics of the
    `two_to_one_sha256` gadget.
    """
    left = np.asarray(left, dtype=np.uint32)
    right = np.asarray(right, dtype=np.uint32)
    n = left.shape[0]
    block1 = np.concatenate([left, right], axis=1)
    h1 = compress_np(np.broadcast_to(IV, (n, 8)), block1)
    return compress_np(h1, np.broadcast_to(PAD_BLOCK_64B, (n, 16)))


def compress_trace_np(state: np.ndarray, block: np.ndarray):
    """Full round trace for witness generation.

    Returns a dict of u32 arrays:
      w:        (N, 64)  schedule words
      a:        (N, 64)  working `a` AFTER each round
      e:        (N, 64)  working `e` AFTER each round
      carry_w:  (N, 64)  schedule carry: (w16 + s0 + w7 + s1 - w) / 2^32  (0 for t<16)
      carry_a:  (N, 64)  (T1 + T2 - new_a) / 2^32
      carry_e:  (N, 64)  (d + T1 - new_e) / 2^32
      out:      (N, 8)   feed-forward digest
      carry_o:  (N, 8)   feed-forward carries
    """
    state = np.asarray(state, dtype=np.uint32)
    block = np.asarray(block, dtype=np.uint32)
    n = state.shape[0]
    w64 = np.zeros((n, 64), dtype=np.uint64)
    w = np.zeros((n, 64), dtype=np.uint32)
    w[:, :16] = block
    carry_w = np.zeros((n, 64), dtype=np.uint32)
    for t in range(16, 64):
        s0 = _rotr_np(w[:, t - 15], 7) ^ _rotr_np(w[:, t - 15], 18) ^ _shr_np(w[:, t - 15], 3)
        s1 = _rotr_np(w[:, t - 2], 17) ^ _rotr_np(w[:, t - 2], 19) ^ _shr_np(w[:, t - 2], 10)
        full = (
            w[:, t - 16].astype(np.uint64)
            + s0.astype(np.uint64)
            + w[:, t - 7].astype(np.uint64)
            + s1.astype(np.uint64)
        )
        w[:, t] = (full & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        carry_w[:, t] = (full >> np.uint64(32)).astype(np.uint32)
        w64[:, t] = full
    a_tr = np.zeros((n, 64), dtype=np.uint32)
    e_tr = np.zeros((n, 64), dtype=np.uint32)
    carry_a = np.zeros((n, 64), dtype=np.uint32)
    carry_e = np.zeros((n, 64), dtype=np.uint32)
    a, b, c, d, e, f, g, h = (state[:, i].copy() for i in range(8))
    for t in range(64):
        s1 = _rotr_np(e, 6) ^ _rotr_np(e, 11) ^ _rotr_np(e, 25)
        ch = (e & f) ^ (~e & g)
        t1_full = (
            h.astype(np.uint64) + s1.astype(np.uint64) + ch.astype(np.uint64) + np.uint64(int(K[t])) + w[:, t].astype(np.uint64)
        )
        s0 = _rotr_np(a, 2) ^ _rotr_np(a, 13) ^ _rotr_np(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2_full = s0.astype(np.uint64) + maj.astype(np.uint64)
        new_a_full = t1_full + t2_full
        new_e_full = d.astype(np.uint64) + t1_full
        new_a = (new_a_full & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        new_e = (new_e_full & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        carry_a[:, t] = (new_a_full >> np.uint64(32)).astype(np.uint32)
        carry_e[:, t] = (new_e_full >> np.uint64(32)).astype(np.uint32)
        a_tr[:, t] = new_a
        e_tr[:, t] = new_e
        h, g, f, e, d, c, b, a = g, f, e, new_e, c, b, a, new_a
    final = np.stack([a, b, c, d, e, f, g, h], axis=1)
    out_full = final.astype(np.uint64) + state.astype(np.uint64)
    out = (out_full & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    carry_o = (out_full >> np.uint64(32)).astype(np.uint32)
    return {
        "w": w, "a": a_tr, "e": e_tr,
        "carry_w": carry_w, "carry_a": carry_a, "carry_e": carry_e,
        "out": out, "carry_o": carry_o,
    }


# ---------------------------------------------------------------------------
# Batched compression on torch tensors: csrc/sha256.cu on the card, the plain
# versions on the CPU
# ---------------------------------------------------------------------------

_MASK = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def kernel_constants() -> bytes:
    """The image of ``csrc/sha256.cu``'s __constant__ table (``Sha256Consts``):
    K, then K[t] + W[t] for the schedule W of the padding block of a 64-byte
    message, then the IV; 136 little-endian u32 words."""
    pad_w = message_schedule_np(PAD_BLOCK_64B[None])[0]
    pad_kw = ((K.astype(np.uint64) + pad_w) & np.uint64(_MASK)).astype(np.uint32)
    return np.concatenate([K, pad_kw, IV]).astype("<u4").tobytes()


def _as_words(x) -> torch.Tensor:
    """A tensor as it is; anything else as the JAX function takes it
    (``asarray(x, uint32)``), a torch.uint32 tensor on the CPU."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np.uint32)))


def _int64_words(t: torch.Tensor, name: str, width: int) -> torch.Tensor:
    """(..., width) u32 words (torch.uint32 or torch.int32) as int64 in [0, 2^32)."""
    if t.dtype not in (torch.uint32, torch.int32):
        raise ValueError(f"sha256 {name}: expected torch.uint32 or torch.int32 words, got {t.dtype}")
    if t.dim() < 1 or t.shape[-1] != width:
        raise ValueError(f"sha256 {name}: expected a shape (..., {width}), got {tuple(t.shape)}")
    return t.view(torch.int32).to(torch.int64) & _MASK


def _same_batch(a: torch.Tensor, b: torch.Tensor, names: tuple) -> None:
    if a.shape[:-1] != b.shape[:-1] or a.device != b.device:
        raise ValueError(f"sha256: {names[0]} {tuple(a.shape)} on {a.device} and {names[1]} "
                         f"{tuple(b.shape)} on {b.device} are not rows of one batch")


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _MASK


def _compress_int64(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """The compression on int64 words in [0, 2^32): state (..., 8), block
    (..., 16) -> (..., 8), each word masked after every add and shift."""
    w = list(block.unbind(-1))
    for t in range(16, 64):
        x, y = w[t - 15], w[t - 2]
        s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)
        s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _MASK)
    a, b, c, d, e, f, g, h = state.unbind(-1)
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + int(K[t]) + w[t]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _MASK, c, b, a, (t1 + s0 + maj) & _MASK
    return (torch.stack([a, b, c, d, e, f, g, h], dim=-1) + state) & _MASK


def _uint32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).view(torch.uint32)


def compress_plain(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """The plain version of ``compress`` (PyTorch ops, where the tensors lie):
    state (..., 8), block (..., 16) -> (..., 8) torch.uint32."""
    _same_batch(state, block, ("state", "block"))
    return _uint32(_compress_int64(_int64_words(state, "state", 8), _int64_words(block, "block", 16)))


def two_to_one_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """The plain version of ``two_to_one``: the IV compressed with left ||
    right, then with the padding block -> (..., 8) torch.uint32."""
    _same_batch(left, right, ("left", "right"))
    block = torch.cat([_int64_words(left, "left", 8), _int64_words(right, "right", 8)], dim=-1)
    lead = block.shape[:-1]
    iv = torch.from_numpy(IV.astype(np.int64)).to(block.device).expand(*lead, 8)
    pad = torch.from_numpy(PAD_BLOCK_64B.astype(np.int64)).to(block.device).expand(*lead, 16)
    return _uint32(_compress_int64(_compress_int64(iv, block), pad))


def compress(state, block) -> torch.Tensor:
    """Batched compression: state (..., 8), block (..., 16) u32 words -> (..., 8)
    torch.uint32.  A CUDA tensor launches ``csrc/sha256.cu`` (contiguous,
    16-byte aligned rows, or it raises); a CPU tensor or numpy input runs
    ``compress_plain`` on the CPU."""
    state, block = _as_words(state), _as_words(block)
    if kernels.on_card(state):
        return kernels.sha256_compress(state, block)
    return compress_plain(state, block)


def two_to_one(left, right) -> torch.Tensor:
    """SHA-256 of the 64-byte concatenation of two 32-byte hashes: (..., 8) +
    (..., 8) u32 words -> (..., 8) torch.uint32, on the card or on the CPU as
    ``compress``."""
    left, right = _as_words(left), _as_words(right)
    if kernels.on_card(left):
        return kernels.sha256_two_to_one(left, right)
    return two_to_one_plain(left, right)


# ---------------------------------------------------------------------------
# Byte-level helpers (host)
# ---------------------------------------------------------------------------


def words_from_bytes(b: bytes) -> np.ndarray:
    """32-byte digest -> 8 big-endian u32 words."""
    assert len(b) % 4 == 0
    return np.frombuffer(b, dtype=">u4").astype(np.uint32)


def bytes_from_words(w: np.ndarray) -> bytes:
    return np.asarray(w, dtype=np.uint32).astype(">u4").tobytes()
