"""Hash256 targets and the two-to-one SHA-256 gadget.

Copy of ``eth_lc_plonky2_tpu/circuit/gadgets_sha256.py`` (the port keeps
its own; host-only builder code).  The counterpart of plonky2_crypto's
`Hash256Target` (8 big-endian u32 words) and
`builder.two_to_one_sha256(left, right)`.

A 64-byte message is two compression calls: the data block and the
constant padding block (0x80... length=512).  Batched variants hash
whole lists of pairs with ONE SHA trace pass per compression level, so
a Merkle level's witness is one vectorized numpy pass.

Values connected into a SHA segment are automatically range-checked to
32 bits by the segment's word/bit-consistency constraints.
"""

from __future__ import annotations

from ..ops import sha256 as shaops
from .builder import CircuitBuilder, Target
from .gates_sha256 import add_sha256_compressions

Hash256 = list  # list of 8 u32 word targets, big-endian word order


def add_virtual_hash256(b: CircuitBuilder) -> Hash256:
    return b.add_virtual_targets(8)


def connect_hash256(b: CircuitBuilder, x: Hash256, y: Hash256):
    for a, c in zip(x, y):
        b.connect(a, c)


def constant_hash256(b: CircuitBuilder, digest32: bytes) -> Hash256:
    words = shaops.words_from_bytes(digest32)
    return [b.constant(int(w)) for w in words]


def set_hash256(w, target: Hash256, digest32: bytes):
    words = shaops.words_from_bytes(digest32)
    for t, v in zip(target, words):
        w.set(t, int(v))


def _iv_targets(b: CircuitBuilder) -> list[Target]:
    return [b.constant(int(v)) for v in shaops.IV]


def _pad_targets(b: CircuitBuilder) -> list[Target]:
    return [b.constant(int(v)) for v in shaops.PAD_BLOCK_64B]


def two_to_one_sha256_batch(b: CircuitBuilder, pairs) -> list[Hash256]:
    """SHA-256 of left||right for a list of (left, right) Hash256 pairs.

    Two batched compression levels (data block, then padding block).
    """
    iv = _iv_targets(b)
    pad = _pad_targets(b)
    inst1 = [(iv, list(l) + list(r)) for l, r in pairs]
    h1 = add_sha256_compressions(b, inst1)
    inst2 = [(h, pad) for h in h1]
    return add_sha256_compressions(b, inst2)


def two_to_one_sha256(b: CircuitBuilder, left: Hash256, right: Hash256) -> Hash256:
    return two_to_one_sha256_batch(b, [(left, right)])[0]
