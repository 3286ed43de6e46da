#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's prover on one GPU, and check it.

    python3 chip_smoke.py [--seed N]

Phases (any mismatch or exception exits non-zero without the ok line):
  0. device facts: card name and power limit, torch, nvcc, GPU count;
  1. build the four kernel sources of eth_lc_plonky2_tpu_torch/csrc with
     nvcc (sm_90a), side by side;
  2. each kernel against its plain PyTorch version on the card, bit for bit:
     the NTT (forward, inverse, coset; the LDE reads its coefficients without
     padding them) at log n in 1..14, 16, 18, 21, the Poseidon sponge at L in
     {2, 4, 8, 16, 20, 184}, N in {1, 511, 512, 2049, 4097}, Merkle levels, and
     whole trees of 2^4, 2^5, 2^11 and 2^12 leaves at cap heights 0 and 4
     (the one-launch tail of a tree); the shapes that only a whole proof has
     (the grind's sponge of (2^19, 2) and its first witness, FRI's layer tree
     of 2^20 pair leaves, coset_intt of (2, 2^21) and (2, 2^8)); the field kernel's add, sub, mul and inv
     in every broadcast form at sizes 1, 1023 and 2^21 (views at an odd word
     offset and of odd length among them), on edge and seeded words, and
     inv(x) * x == 1; the batched inverse at lengths around its runs of 16
     words and tiles of 4,096 (1 to 12,345, at an odd offset, one shorter)
     with zeros at every place of a run;
  3. commit_values on assets/dryrun/pre.npz must reproduce its stored
     coefficients, LDE and every Merkle level;
  4. one proof's three commitments at the flagship width (CircuitConfig
     num_wires=184 on a 2^18 domain, rate 2^3, cap height 4): wires and Z
     from values, the quotient from coefficients, with seeded data; launch
     counts, subset checks against the plain versions, Merkle paths
     verified against the cap, timings, and a torch.profiler split by kernel
     name whose launch counts must be the plan's (leaves, levels, tail, NTT
     passes);
  5. the dryrun circuit (16 wires, 2^7 rows; gates arith, const, noop), built
     with the port's builder: preprocess on the card must give the cap stored
     in assets/dryrun/pre.npz, and prove() must give assets/dryrun/ref_proof.json
     key by key; the same proof on the plain versions on the card is equal;
  6. a whole proof at the flagship's width: CircuitConfig(num_wires=184) with
     the defaults (80 routed wires, 6 constants, 2 challenges, permutation
     chunk 8, rate 2^3, cap height 4, 16 PoW bits, 28 queries, final polynomial
     2^5), 2^18 rows of which 166,704 are used, gates arith (20 ops a row),
     basesum2, const and noop, public inputs, and copy constraints on 79 of
     the 80 routed columns.  The tables and a satisfying witness are written
     directly with numpy from --seed.  preprocess, a first prove (launch counts
     and peak memory), a warm-up, three timed proves, the phases' times, a
     torch.profiler split by kernel name with the idle share, and the port's
     verifier on the proof (every challenge re-derived, the constraint identity
     at zeta, all Merkle paths, FRI's folds, the final polynomial, the PoW).
     The same circuit at 2^12 rows is proved on the kernels and on the plain
     versions, both on the card, and the two proofs must be equal; the field
     kernel's (8, 2^21) product is timed as one call and ten back to back,
     and the inverse at (5, 2^21) beside its bound and its plain version;
  7. a light-client-shaped circuit built with the port's own CircuitBuilder at the
     same widths: the SHA-256 Merkle root of 1,024 seeded leaves (1,023
     two-to-one hashes, 139,128 SHA-256 segment rows and their feed-forward
     adds), the root as public inputs, and a chain of 16,000 Poseidon
     permutation rows: about 166,300 of 2^18 rows, neighbour-row offsets down
     to -16 and so 12 opening points.  Each gate kernel of csrc/gates.cu is
     held against the generic eval loop on the plain ops (random field words,
     edge words, n_lde 2^7, 2^12, 2^15) and, at (184, 2^21), against the
     generic loop on the plain ops and on csrc/field.cu, with its time and
     bound; the
     circuit family at 2^12 rows is proved on the kernels and on the plain
     versions; the 2^18-row proof is made, timed, traced and verified as in
     phase 6, its public inputs must be hashlib's root and the host's Poseidon
     chain, proofs from a forged SHA-256 bit wire and from a forged Poseidon
     s-box output must be rejected, the launches must be the plan's (three of
     csrc/gates.cu: the two gates and the generic gates with the public
     inputs; csrc/field.cu's fused kernels, one or two an opening batch, three
     for the permutation rows (perm_z_kernel, its scan and its fix-up, counted
     around their call too: no elementwise launch there), one for the
     permutation terms, one for FRI's G and one a FRI fold, also by name in
     the trace, and of the elementwise kernels only the quotient's product by
     1 / Z_H), and the proof is made in turns with the fused kernels and with
     the eager chains of field.cu ops they replaced (the proof must not
     change).  Last, the fused kernels against their plain
     versions at the main path's shapes: the four opening batches at 2^18
     coefficients (12 points), the permutation terms at (80, 2^21) with 2
     challenges and chunk 8, the generic gates and 12 public inputs at (184,
     2^21), G over the four batches at 2^21 with 5 and 12 specs (a zero norm
     among them) and the fold at every size 2^1 to 2^21, edge words included
     (and edge points at 2^12, a wrapping roll at 2^7, the small sizes), and
     the permutation rows of both challenges at (80, 2^18) with zero den
     chunks (then at 2^12 with one and two challenges, and at 2^4), each
     timed beside its bound, its plain version and the eager chain it replaced.
The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel with its launches on the main path, its error against the plain
version, and its time beside the plain version's and beside the least time
the card could take (bound_ms: the larger of bytes over 3.35 TB/s and 32-bit
integer multiply-adds, counted in the cheapest form known, over 16.75 T/s).
The launches are phase 7's first prove; the gates entry adds up its three
kernels (one launch each a proof) and the field entry its elementwise
product, its batched inverse and its five fused passes, and each lists them
under by_kernel.  No
PyTorch call computes any of these functions, so library_ms is null.

It needs a CUDA device, and no JAX: the port imports neither jax nor the JAX
package.
"""

from __future__ import annotations

import argparse
import importlib.metadata
import json
import os
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# The flagship circuit: CircuitConfig(num_wires=184), 166,704 rows on a 2^18
# domain (reports/full512_r5.md), rate_bits 3, cap_height 4, 80 routed wires,
# permutation chunk 8 and 2 challenges (eth_lc_plonky2_tpu/prover/config.py).
LOG_N = 18
RATE_BITS = 3
CAP_HEIGHT = 4
NUM_WIRES = 184
NUM_Z = 2 * (80 // 8)  # challenges x permutation chunks
NUM_QUOTIENT = 2 * (1 << RATE_BITS)  # challenges x quotient chunks

NTT_LOGS = list(range(1, 15)) + [16, 18, 21]
SPONGE_LS = (2, 4, 8, 16, 20, 184)
SPONGE_NS = (1, 511, 512, 2049, 4097)
TREE_LEAVES = (1 << 4, 1 << 5, 1 << 11, 1 << 12)
TREE_CAPS = (0, 4)
DEVICE = "cuda"
# csrc/field.cu launches of one steady prove of phase 6's circuit: one an eager
# field op that gives a non-empty result (mul_small by 0 or 1 launches none),
# two an opening batch (field_open_kernel and its sum over the slices: P, W, Z,
# Q), one for the permutation terms, one for FRI's G and one a FRI fold.  A
# change in the number of eager ops shows here.  Recounted from the code when
# the openings and the permutation terms were fused: the 3,189 eager
# launches less 276 an opening point at 2^18 (5 points) and 358 for the
# permutation terms, plus 8 + 1 (3,189 - 1,380 - 358 + 9 = 1,460); and when
# G and the folds were fused and the generic gates went to csrc/gates.cu:
# less the generic gates' and public inputs' 836 eager ops, G's 270 (its
# batched inversion among them) and 13 folds of 18, plus 1 + 13
# (1,460 - 836 - 270 - 234 + 14); and when Z and the partials were fused and
# the alpha powers came from the host: less the 84 eager ops and 2 inversions
# of the permutation rows and the 24 of the alpha powers' log-doubling, plus
# the 3 launches of perm_z_kernel, its scan and its fix-up (134 - 110 + 3).
# What is left: the quotient's product by 1 / Z_H, the permutation rows (3),
# the openings (4 + 4), the permutation terms, G and the 13 folds.
STEADY_FIELD_LAUNCHES = 27

# The card's peaks (NVIDIA H100 SXM data sheet): 3.35 TB/s of device memory,
# and 67 TFLOP/s of float32 = 33.5 T multiply-adds/s on 128 lanes an SM, of
# which 64 do 32-bit integer multiply-adds: 16.75 T/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_MADS_PER_S = 67e12 / 2 / 2
# 32 x 32 multiply-adds of one permutation in the cheapest form known: 118
# S-boxes of two squares (3 partial products of a 64 x 64 square) and two
# general products (4); 8 dense layers as two length-6 correlations on four
# 16-bit limbs (72 x 4 products, and 4 for the one non-zero diagonal entry);
# the 22 sparse partial rounds (an 11 x 11 matrix, then 23 products of
# 64 x 64 bits a round).
MADS_PER_PERMUTATION = 118 * (2 * 3 + 2 * 4) + 8 * (72 * 4 + 4) + (121 + 22 * 23) * 4


# The batched inverse per word, Montgomery's trick over a run of 16 words
# (ops/kernels.py FIELD_INV_RUN): one product into the running product, two
# on the way back, and a 16th of the Fermat power's 72.
INV_PRODUCTS_PER_WORD = 3 + 72 / 16


def bound_of(nbytes: int, mads: int) -> tuple:
    """The least time the card could take (each input read once, each output
    written once; the multiply-adds the algorithm needs): (ms, "bytes" or
    "operations", whichever bounds it)."""
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S * 1e3, mads / PEAK_INT32_MADS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def u64_err(a, b) -> float:
    """Largest |a - b| over the u64 values of two field tensors (0 when equal)."""
    x = a.detach().cpu().numpy().view(np.uint64)
    y = b.detach().cpu().numpy().view(np.uint64)
    if x.shape != y.shape:
        fail(f"shape mismatch {x.shape} vs {y.shape}")
    if x.size == 0:
        return 0.0
    return float(np.where(x > y, x - y, y - x).max())


class Checker:
    """Collects each kernel's largest error against its plain version."""

    def __init__(self):
        self.err = {"ntt": 0.0, "poseidon": 0.0, "field": 0.0, "gates": 0.0}

    def same(self, kernel: str, got, want, what: str) -> None:
        e = u64_err(got, want)
        self.err[kernel] = max(self.err[kernel], e)
        if e != 0.0:
            fail(f"{what}: kernel differs from the plain version (max |err| {e})")


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, timed with CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase0(torch) -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    card = card_line()
    log(f"[0] card: {card}")
    log(f"[0] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, GPUs {torch.cuda.device_count()}, "
        f"device 0 {torch.cuda.get_device_name(0)}")
    from eth_lc_plonky2_tpu_torch.ops import kernels

    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60)
    log("[0] nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "absent"
    log(f"[0] triton: {triton} (the port's kernels are CUDA C++)")
    return card


def phase1() -> None:
    from eth_lc_plonky2_tpu_torch.ops import kernels

    info = kernels.build()
    paths = ", ".join(os.path.relpath(p, REPO) for p in info["paths"])
    log(f"[1] kernels ready in {info['seconds']:.1f} s (built now: {info['built']}): {paths}")
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[1] ptxas: {line.strip()}")
    spilled = {k: v["spill_bytes"] for k, v in ptxas_info(info.get("ptxas", "")).items()
               if v["spill_bytes"]}
    if spilled:
        fail(f"kernels spill registers (bytes): {spilled}")


def phase2(torch, chk: Checker, rng) -> None:
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl, ntt, poseidon as pos

    dev = DEVICE
    for log_n in NTT_LOGS:
        n = 1 << log_n
        x = rng.integers(0, gl.P, size=(3, n), dtype=np.uint64)
        x[0, 0] = gl.P - 1
        x[1, :] = gl.P - 1
        t = gl.from_u64(x, dev)
        chk.same("ntt", ntt.ntt(t), ntt.ntt_plain(t), f"ntt 2^{log_n}")
        chk.same("ntt", ntt.intt(t), ntt.ntt_plain(t, inverse=True), f"intt 2^{log_n}")
        rate = min(RATE_BITS, log_n)
        c = t[:, : n >> rate].contiguous()
        chk.same("ntt", ntt.coset_lde(c, rate), ntt.coset_lde_plain(c, rate, 7),
                 f"coset_lde 2^{log_n - rate} -> 2^{log_n}")
        chk.same("ntt", ntt.coset_intt(t, rate), ntt.coset_intt_plain(t, 7),
                 f"coset_intt 2^{log_n}")
        torch.cuda.synchronize()
    log(f"[2] ntt == plain at log n {NTT_LOGS} (forward, inverse, coset_lde, coset_intt)")
    for length in SPONGE_LS:
        for n in SPONGE_NS:
            x = rng.integers(0, gl.P, size=(length, n), dtype=np.uint64)
            x[0, 0] = gl.P - 1
            t = gl.from_u64(x, dev)  # channel-first, as a commitment's LDE
            chk.same("poseidon", pos.hash_no_pad(t.T), pos._hash_plain(t.T),
                     f"sponge L={length} N={n}")
        torch.cuda.synchronize()
    for m in SPONGE_NS:
        level = gl.from_u64(rng.integers(0, gl.P, size=(2 * m, 4), dtype=np.uint64), dev)
        chk.same("poseidon", pos.compress_level(level),
                 pos._hash_plain(level.reshape(-1, 8)), f"level compress M={m}")
    torch.cuda.synchronize()
    log(f"[2] sponge == plain at L {SPONGE_LS} x N {SPONGE_NS}, and level compression")
    from eth_lc_plonky2_tpu_torch.prover import merkle

    for n in TREE_LEAVES:
        leaves = gl.from_u64(rng.integers(0, gl.P, size=(n, 5), dtype=np.uint64), dev)
        for cap in TREE_CAPS:
            tree = merkle.build_merkle(leaves, cap)
            want = pos._hash_plain(leaves)
            if len(tree.levels) != n.bit_length() - cap:
                fail(f"tree of {n} leaves, cap height {cap}: {len(tree.levels)} levels")
            for k, level in enumerate(tree.levels):
                chk.same("poseidon", level, want, f"tree of {n} leaves, cap {cap}, level {k}")
                if k + 1 < len(tree.levels):
                    want = pos._hash_plain(want.reshape(-1, 8))
    torch.cuda.synchronize()
    log(f"[2] trees of {TREE_LEAVES} leaves at cap heights {TREE_CAPS} == plain, level by level")
    check_proof_shapes(torch, chk, rng)
    check_field_kernel(torch, chk, rng)


def check_proof_shapes(torch, chk: Checker, rng) -> None:
    """The shapes that only a whole proof gives the two older kernels, each
    against its plain version: the grind's sponge (L = 2, 2^19 rows), FRI's
    first layer tree (leaves of L = 4 from 2^20 pairs, cap height 4), the
    quotient's coset_intt of (2, 2^21) and the final polynomial's of (2, 2^8)
    on its own coset."""
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl, ntt, poseidon as pos
    from eth_lc_plonky2_tpu_torch.prover import fri

    dev = DEVICE
    n_lde = 1 << (LOG_N + RATE_BITS)
    batch = 1 << 19  # grind: 1 << min(20, 16 PoW bits + 3)
    c_f = gl.from_u64(rng.integers(0, gl.P, dtype=np.uint64), dev)
    ws = torch.arange(batch, 2 * batch, dtype=torch.int64, device=dev)
    rows = torch.stack([c_f.expand(batch), ws], dim=1)
    digests = pos._hash_plain(rows)
    chk.same("poseidon", pos.hash_no_pad(rows), digests, f"grind sponge L=2 N={batch}")
    thr_hi = 1 << 22  # 10 bits: this batch holds hits, and the first must be found
    ok = ((digests[:, 0] >> 32) & 0xFFFF_FFFF) < thr_hi
    found, idx = fri._grind_core(c_f, ws, thr_hi)
    if not bool(found) or int(idx) != int(torch.nonzero(ok)[0, 0]):
        fail(f"grind: the kernel's first witness {int(idx)} is not the plain version's")
    g = gl.from_u64(rng.integers(0, gl.P, size=(2, n_lde), dtype=np.uint64), dev)
    leaves, levels = fri._layer_tree_core(g[0], g[1], fri.layer_cap_height(n_lde // 2))
    if leaves.shape != (n_lde // 2, 4) or len(levels) != LOG_N + RATE_BITS - 1 - 4 + 1:
        fail(f"layer tree: leaves {tuple(leaves.shape)}, {len(levels)} levels")
    want = pos._hash_plain(leaves)
    for k, level in enumerate(levels):
        chk.same("poseidon", level, want, f"layer tree of 2^{LOG_N + RATE_BITS - 1} pairs, level {k}")
        if k + 1 < len(levels):
            want = pos._hash_plain(want.reshape(-1, 8))
    del leaves, levels, want, digests, rows
    chk.same("ntt", ntt.coset_intt(g, RATE_BITS), ntt.coset_intt_plain(g, 7),
             f"coset_intt (2, 2^{LOG_N + RATE_BITS})")
    final_size = 1 << (5 + RATE_BITS)  # final polynomial 2^5 at rate 2^3
    shift = pow(7, n_lde // final_size, gl.P)  # the coset after the folds
    small = g[:, :final_size].contiguous()
    chk.same("ntt", ntt.coset_intt(small, 0, shift), ntt.coset_intt_plain(small, shift),
             f"coset_intt (2, 2^8) on the coset of 7^{n_lde // final_size}")
    torch.cuda.synchronize()
    log(f"[2] a proof's own shapes == plain: grind sponge (2^19, 2) and its first witness, "
        f"layer tree of 2^{LOG_N + RATE_BITS - 1} pairs ({LOG_N + RATE_BITS - 4} levels), "
        f"coset_intt (2, 2^{LOG_N + RATE_BITS}) and (2, 2^8)")


def phase3(torch) -> None:
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
    from eth_lc_plonky2_tpu_torch.prover import prove

    z = np.load(os.path.join(REPO, "assets", "dryrun", "pre.npz"))
    batch = prove.commit_values(z["pre_values"], RATE_BITS, 6, device=DEVICE)
    torch.cuda.synchronize()
    if not np.array_equal(gl.to_u64(batch.coeffs), z["pre_coeffs"]):
        fail("pre.npz: coefficients differ")
    if not np.array_equal(gl.to_u64(batch.lde), z["pre_lde"]):
        fail("pre.npz: LDE differs")
    num_levels = int(z["num_levels"][0])
    if len(batch.tree.levels) != num_levels:
        fail(f"pre.npz: {len(batch.tree.levels)} levels, stored {num_levels}")
    for i in range(num_levels):
        if not np.array_equal(gl.to_u64(batch.tree.levels[i]), z[f"level_{i}"]):
            fail(f"pre.npz: Merkle level {i} differs")
    log(f"[3] commit_values(pre.npz {z['pre_values'].shape}) == stored coeffs, LDE and "
        f"{num_levels} levels")


def flagship_inputs(rng) -> tuple:
    """Seeded wires and Z values and quotient coefficients on the card."""
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl

    n = 1 << LOG_N
    return tuple(gl.from_u64(rng.integers(0, gl.P, size=(rows, n), dtype=np.uint64), DEVICE)
                 for rows in (NUM_WIRES, NUM_Z, NUM_QUOTIENT))


def commit_all(inputs) -> tuple:
    """One proof's three commitments."""
    from eth_lc_plonky2_tpu_torch.prover import prove

    wires_vals, z_vals, q_coeffs = inputs
    return (prove.commit_field_values(wires_vals, RATE_BITS, CAP_HEIGHT),
            prove.commit_field_values(z_vals, RATE_BITS, CAP_HEIGHT),
            prove.commit_coeffs(q_coeffs, RATE_BITS, CAP_HEIGHT))


def measure(torch, chk: Checker, rng, card: str, inputs) -> dict:
    """The timings of phase 4: each commitment (host clock, median of 3), each
    kernel beside its plain version at one main-path shape (CUDA events), and
    the device time of one proof's commitments by kernel name (torch.profiler).

    It calls only what the package has had since its first version, so
    tools/torch_kernel_times.py can run it on an older checkout too.
    """
    from torch.profiler import ProfilerActivity, profile

    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl, ntt, poseidon as pos
    from eth_lc_plonky2_tpu_torch.prover import prove

    dev = DEVICE
    n, n_lde = 1 << LOG_N, 1 << (LOG_N + RATE_BITS)
    wires_vals, z_vals, q_coeffs = inputs
    out = {"card": card}
    caps = [b.cap for b in commit_all(inputs)]  # also the warm-up
    out["caps_xor"] = int(np.bitwise_xor.reduce(np.concatenate(caps).ravel()))
    times = {}
    for tag, fn in (("wires", lambda: prove.commit_field_values(wires_vals, RATE_BITS, CAP_HEIGHT)),
                    ("Z", lambda: prove.commit_field_values(z_vals, RATE_BITS, CAP_HEIGHT)),
                    ("quotient", lambda: prove.commit_coeffs(q_coeffs, RATE_BITS, CAP_HEIGHT))):
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        times[tag] = statistics.median(runs) * 1e3
        log(f"[4] commit {tag}: median {times[tag]:.2f} ms of {len(runs)} "
            f"({', '.join(f'{r * 1e3:.2f}' for r in runs)}) [{card}]")
    out["commit_ms"] = times
    out["commit_wall_ms"] = sum(times.values())
    log(f"[4] one proof's three commitments: {out['commit_wall_ms']:.2f} ms [{card}]")

    # Each kernel beside its plain version at one main-path shape.
    chunk = prove._COMMIT_CHUNK
    coeffs = gl.from_u64(rng.integers(0, gl.P, size=(chunk, n), dtype=np.uint64), dev)
    lde_out = torch.empty((chunk, n_lde), dtype=torch.int64, device=dev)
    out["ntt_ms"] = cuda_ms(lambda: ntt.coset_lde(coeffs, RATE_BITS, out=lde_out), 5)
    out["ntt_plain_ms"] = cuda_ms(lambda: ntt.coset_lde_plain(coeffs, RATE_BITS, 7), 3)
    chk.same("ntt", lde_out, ntt.coset_lde_plain(coeffs, RATE_BITS, 7), "timed coset_lde chunk")
    scratch = torch.empty_like(coeffs)
    out["intt_ms"] = cuda_ms(lambda: ntt.intt(coeffs, out=scratch), 5)
    log(f"[4] ntt: coset_lde ({chunk}, 2^{LOG_N}) -> 2^{LOG_N + RATE_BITS}: kernel "
        f"{out['ntt_ms']:.3f} ms, plain {out['ntt_plain_ms']:.3f} ms; intt ({chunk}, 2^{LOG_N}): "
        f"kernel {out['intt_ms']:.3f} ms [{card}]")
    del lde_out, scratch
    level = gl.from_u64(rng.integers(0, gl.P, size=(n << 1, 4), dtype=np.uint64), dev)
    out["level_ms"] = cuda_ms(lambda: pos.compress_level(level), 5)
    out["level_plain_ms"] = cuda_ms(lambda: pos._hash_plain(level.reshape(-1, 8)), 3)
    chk.same("poseidon", pos.compress_level(level), pos._hash_plain(level.reshape(-1, 8)),
             "timed level compression")
    log(f"[4] poseidon: Merkle level ({2 * n}, 4) -> ({n}, 4): kernel {out['level_ms']:.3f} ms, "
        f"plain {out['level_plain_ms']:.3f} ms [{card}]")
    wires_lde = torch.empty((NUM_WIRES, n_lde), dtype=torch.int64, device=dev)
    out["leaves_ms"] = cuda_ms(lambda: pos.hash_no_pad(wires_lde.T), 3)
    log(f"[4] poseidon: wires leaves ({NUM_WIRES}, 2^{LOG_N + RATE_BITS}): kernel "
        f"{out['leaves_ms']:.3f} ms [{card}]")
    del wires_lde, level

    # Device time per proof by kernel name, and the idle share of the window.
    for _ in range(2):  # the first profiled run pays for the tracer's start-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            commit_all(inputs)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type.name != "CPU" and ev.self_device_time_total > 0:
            own = re.search(r"\w+_kernel\b", ev.key)  # this repo's kernels, without their namespace
            by_name[own.group(0) if own else ev.key[:48]] = {
                "ms": ev.self_device_time_total / 1e3, "launches": ev.count}
    busy_ms = sum(v["ms"] for v in by_name.values())
    for name, v in sorted(by_name.items(), key=lambda kv: -kv[1]["ms"]):
        log(f"[4] profile, one proof's commitments: {name}: {v['ms']:.3f} ms in "
            f"{v['launches']} launches [{card}]")
    log(f"[4] profile: busy {busy_ms:.3f} ms of a {window_ms:.3f} ms window, idle share "
        f"{1 - busy_ms / window_ms:.3f} [{card}]")
    out["profile"] = {"by_kernel": by_name, "busy_ms": busy_ms, "window_ms": window_ms,
                      "idle_share": 1 - busy_ms / window_ms}
    return out


def phase4(torch, chk: Checker, rng, card: str) -> dict:
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl, kernels, ntt, poseidon as pos
    from eth_lc_plonky2_tpu_torch.prover import merkle, prove

    dev = DEVICE
    n = 1 << LOG_N
    t0 = time.perf_counter()
    inputs = flagship_inputs(rng)
    wires_vals, z_vals, q_coeffs = inputs
    torch.cuda.synchronize()
    log(f"[4] seeded data on the card in {time.perf_counter() - t0:.1f} s: wires "
        f"{tuple(wires_vals.shape)}, Z {tuple(z_vals.shape)}, quotient {tuple(q_coeffs.shape)}")

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    batches = commit_all(inputs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = dict(kernels.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[4] three commitments (first run) in {first_s:.3f} s, launches {launched}, "
        f"peak memory {peak_gb:.2f} GB")
    for name in ("ntt", "poseidon"):
        if launched[name] <= 0:
            fail(f"the commitments never launched the {name} kernel")

    wires, zs, quot = batches
    if not torch.equal(ntt.ntt_plain(wires.coeffs[:4]), wires_vals[:4]):
        fail("ntt(coeffs) != values on 4 wire columns")
    chk.same("ntt", wires.lde[:4], ntt.coset_lde_plain(wires.coeffs[:4], RATE_BITS, 7),
             "wires LDE, 4 columns")
    chk.same("ntt", quot.lde[-4:], ntt.coset_lde_plain(q_coeffs[-4:], RATE_BITS, 7),
             "quotient LDE, 4 columns")
    n_lde = n << RATE_BITS
    leaf_idx = torch.from_numpy(rng.choice(n_lde, size=4096, replace=False)).to(dev)
    for tag, b in (("wires", wires), ("Z", zs), ("quotient", quot)):
        chk.same("poseidon", b.tree.levels[0][leaf_idx],
                 pos._hash_plain(b.lde[:, leaf_idx].T), f"{tag} leaf digests, 4096 leaves")
        q_idx = rng.choice(n_lde, size=64, replace=False)
        rows, paths = merkle.gather_rows_and_paths(b.tree, q_idx)
        if rows.shape != (64, b.lde.shape[0]) or paths.shape != (64, LOG_N + RATE_BITS - CAP_HEIGHT, 4):
            fail(f"{tag}: gathered shapes {tuple(rows.shape)} {tuple(paths.shape)}")
        if not merkle.verify_merkle_batch(rows, q_idx, paths, b.cap):
            fail(f"{tag}: Merkle paths do not verify against the cap")
        if b.cap.shape != (1 << CAP_HEIGHT, 4) or not (b.cap < np.uint64(gl.P)).all():
            fail(f"{tag}: malformed cap")
    log("[4] checks: ntt(coeffs) == values; LDE and 4096 leaf digests == plain; "
        "64 gathered paths per tree verify against the cap")
    del batches, wires, zs, quot

    res = measure(torch, chk, rng, card, inputs)

    # The profile must show every kernel of the path as often as the plan says:
    # a tree is one leaf pass, one launch a level while a level has more than
    # TAIL_MAX_PAIRS pairs, and one launch for the levels below; a chunk of
    # polynomials is two NTT passes a transform.
    chunk = prove._COMMIT_CHUNK
    big_levels = sum(1 for k in range(CAP_HEIGHT, LOG_N + RATE_BITS) if (1 << k) > pos.TAIL_MAX_PAIRS)
    chunks = [-(-rows // chunk) for rows in (NUM_WIRES, NUM_Z, NUM_QUOTIENT)]
    expected = {"sponge_kernel": 3, "merkle_level_kernel": 3 * big_levels, "merkle_tail_kernel": 3,
                "ntt_pass_kernel": 2 * (2 * chunks[0] + 2 * chunks[1] + chunks[2])}
    seen = {name: res["profile"]["by_kernel"].get(name, {}).get("launches", 0) for name in expected}
    if seen != expected:
        fail(f"the profile shows launches {seen}, the plan is {expected}")
    if (launched["ntt"], launched["poseidon"]) != (
            expected["ntt_pass_kernel"], sum(expected.values()) - expected["ntt_pass_kernel"]):
        fail(f"the launch counts {launched} are not the plan's {expected}")
    log(f"[4] launches by kernel name as planned: {expected}")

    # The two passes of one chunk's LDE, each alone.
    coeffs = gl.from_u64(rng.integers(0, gl.P, size=(chunk, n), dtype=np.uint64), dev)
    lde_out = torch.empty((chunk, n_lde), dtype=torch.int64, device=dev)
    passes = ntt._passes(coeffs, lde_out, False, in_tab=ntt._powers_on(7, n, dev), log_pad=RATE_BITS)
    pass_ms = [cuda_ms(lambda: kernels.ntt_pass(src, dst, **args), 5) for src, dst, args in passes]
    log(f"[4] ntt: the passes of that coset_lde alone: columns {pass_ms[0]:.3f} ms, rows "
        f"{pass_ms[1]:.3f} ms [{card}]")
    del coeffs, lde_out, passes

    ntt_bound = bound_of((chunk * n + chunk * n_lde) * 8,
                         chunk * (n_lde // 2) * (LOG_N + RATE_BITS) * 4)  # butterflies x (64 x 64 product)
    level_bound = bound_of((2 * n * 4 + n * 4) * 8, n * MADS_PER_PERMUTATION)
    leaf_bound = bound_of(NUM_WIRES * n_lde * 8 + n_lde * 32,
                          n_lde * (NUM_WIRES // 8) * MADS_PER_PERMUTATION)
    # one proof: the leaves' permutations and one a pair of every level
    permutations = (n_lde * sum(-(-rows // 8) for rows in (NUM_WIRES, NUM_Z, NUM_QUOTIENT))
                    + 3 * (n_lde - (1 << CAP_HEIGHT)))
    proof_bound_ms = permutations * MADS_PER_PERMUTATION / PEAK_INT32_MADS_PER_S * 1e3
    sponge_ms = sum(v["ms"] for name, v in res["profile"]["by_kernel"].items()
                    if name != "ntt_pass_kernel" and name in expected)
    log(f"[4] bounds ({MADS_PER_PERMUTATION} multiply-adds a permutation): ntt chunk "
        f"{ntt_bound[0]:.4f} ms (by {ntt_bound[1]}), {ntt_bound[0] / res['ntt_ms']:.1%} of the "
        f"kernel's time; level {level_bound[0]:.4f} ms (by {level_bound[1]}), "
        f"{level_bound[0] / res['level_ms']:.1%}; wires leaves {leaf_bound[0]:.3f} ms (by "
        f"{leaf_bound[1]}), {leaf_bound[0] / res['leaves_ms']:.1%}; the sponge of one proof "
        f"({permutations} permutations) {proof_bound_ms:.3f} ms, "
        f"{proof_bound_ms / sponge_ms:.1%} of {sponge_ms:.3f} ms")
    return {
        "launches": launched,
        "ntt": (res["ntt_ms"], res["ntt_plain_ms"], *ntt_bound),
        "poseidon": (res["level_ms"], res["level_plain_ms"], *level_bound),
    }


# ---------------------------------------------------------------------------
# The field kernel against the plain ops (phase 2)
# ---------------------------------------------------------------------------

FIELD_SIZES = (1, 1023, 1 << 21)
# field_inv_kernel's runs (ops/kernels.py field_inv_plan: 16 words a thread at
# a stride of 256, 4,096 a block): within one run, one tile, past a tile
INV_LENGTHS = (1, 7, 8, 9, 15, 16, 17, 255, 1023, 4095, 4096, 4097, 12_345)


def inverse_words(rng, n: int) -> np.ndarray:
    """Seeded words with the edge words first and zeros at every seventh
    word, at the last word of every run of the first tile, at one word of a
    run in every tile and along a whole run of the second tile."""
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl, kernels

    plan = kernels.field_inv_plan(n)
    threads, tile = plan["threads"], plan["tile"]
    x = rng.integers(0, gl.P, size=n, dtype=np.uint64)
    edge = field_edge_words()
    x[: min(n, len(edge))] = edge[: min(n, len(edge))]
    x[3::7] = 0
    x[threads * (plan["run"] - 1) : threads * plan["run"]] = 0
    x[threads * 2 + 5 :: tile] = 0
    x[tile + 9 :: threads][: plan["run"]] = 0
    return x


def field_edge_words() -> np.ndarray:
    """Words at the edges of the arithmetic: 0, 1, p - 1, around 2^32, 2^63,
    and pairs whose sum or product wraps 2^64 or lands on p."""
    p = 0xFFFF_FFFF_0000_0001
    return np.array([0, 1, 2, p - 1, p - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, 1 << 63,
                     (1 << 63) - 1, (1 << 63) + 1, p >> 1, (p >> 1) + 1, 0xFFFF_FFFF_0000_0000,
                     0xFFFF_FFFE_FFFF_FFFF, 7], dtype=np.uint64)


def check_field_kernel(torch, chk: Checker, rng) -> None:
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl

    dev = DEVICE
    ops = (("add", gl.add, gl.add_plain), ("sub", gl.sub, gl.sub_plain),
           ("mul", gl.mul, gl.mul_plain))
    edge = field_edge_words()
    ea = gl.from_u64(np.repeat(edge, len(edge)), dev)
    eb = gl.from_u64(np.tile(edge, len(edge)), dev)
    for name, kernel, plain in ops:  # every pair of edge words
        chk.same("field", kernel(ea, eb), plain(ea, eb), f"field {name}, edge words")
    for n in FIELD_SIZES:
        rows = 8 if n > 1023 else 6
        x = rng.integers(0, gl.P, size=(rows, n), dtype=np.uint64)
        y = rng.integers(0, gl.P, size=(rows, n), dtype=np.uint64)
        x.reshape(-1)[: len(edge)] = edge[: x.size]
        y.reshape(-1)[: len(edge)] = edge[::-1][: y.size]
        a, b = gl.from_u64(x, dev), gl.from_u64(y, dev)
        forms = {
            "same shape": (a, b),
            "scalar": (a, b[0, 0]),
            "scalar first": (a[0, 0], b),
            "row (1, n)": (a, b[:1]),
            "column (r, 1)": (a, b[:, :1]),
            "row against column": (a[:1], b[:, :1]),
            "1-D row": (a, b[1]),
            "strided columns": (a[:, ::2], b[:, ::2]),
            "strided rows": (a[::2], b[1::2]),
            "3-D (2, r/2, n) by (r/2, 1)": (a[: rows & ~1].reshape(2, rows // 2, n), b[: rows // 2, :1]),
            "column (n, 1) of a narrow array": (a.T[:, :1], b.T[:, 1:2]),
            "odd word offset": (a.reshape(-1)[1:], b.reshape(-1)[1:]),
            "odd offset against one word": (a.reshape(-1)[3:], b[1, 0]),
            "odd length": (a.reshape(-1)[:-1], b.reshape(-1)[:-1]),
        }
        for name, kernel, plain in ops:
            for form, (u, v) in forms.items():
                chk.same("field", kernel(u, v), plain(u, v), f"field {name}, {form}, n={n}")
        chk.same("field", gl.square(a), gl.mul_plain(a, a), f"field square, n={n}")
        chk.same("field", gl.neg(a), gl.sub_plain(torch.zeros_like(a), a), f"field neg, n={n}")
        sub = a[:, : min(n, 1 << 14)]  # the plain inverse is 127 products of 35 passes
        inv = gl.inv(sub)
        chk.same("field", inv, gl.inv_plain(sub), f"field inv, n={n}")
        nonzero = sub != 0
        if not torch.equal(gl.mul(inv, sub), nonzero.to(torch.int64)):
            fail(f"field inv: inv(x) * x != 1, n={n}")
        full_inv = gl.inv(a)
        if not torch.equal(gl.mul_plain(full_inv, a), (a != 0).to(torch.int64)):
            fail(f"field inv: inv(x) * x != 1 over the whole ({rows}, {n}) array")
        torch.cuda.synchronize()
    for n in INV_LENGTHS:
        x = gl.from_u64(inverse_words(rng, n), dev)
        for form, t in (("contiguous", x), ("odd word offset", x[1:]), ("odd length", x[:-1])):
            if t.numel():
                inv = gl.inv(t)
                chk.same("field", inv, gl.inv_plain(t), f"field inv, {form}, {n} words")
                if not torch.equal(gl.mul_plain(inv, t), (t != 0).to(torch.int64)):
                    fail(f"field inv: inv(x) * x != 1, {form}, {n} words")
    torch.cuda.synchronize()
    log(f"[2] field add, sub, mul == plain on all pairs of {len(edge)} edge words and at sizes "
        f"{FIELD_SIZES} in {len(forms)} broadcast forms; "
        f"square, neg, inv == plain; inv(x) * x == 1; inv at {INV_LENGTHS} words (and at an odd "
        f"offset, one word shorter) with zeros at every place of a thread's run == plain")


# ---------------------------------------------------------------------------
# Circuits (phases 5 and 6)
# ---------------------------------------------------------------------------


def dryrun_circuit():
    """The dryrun circuit of the JAX package's multi-chip entry (16 wires, all
    routed, 2^7 rows; gates arith, const, noop; an inverse-trick gadget), built
    with the port's builder, and its witness for x = 3."""
    from eth_lc_plonky2_tpu_torch.circuit.builder import CircuitBuilder
    from eth_lc_plonky2_tpu_torch.prover.config import CircuitConfig, FriConfig

    cfg = CircuitConfig(
        num_wires=16, num_routed_wires=16, num_constants=2, permutation_chunk_size=2,
        fri=FriConfig(cap_height=6, proof_of_work_bits=8, num_query_rounds=8, final_poly_bits=6))
    b = CircuitBuilder(cfg)
    x = b.add_virtual_target()
    acc = x
    while len(b.rows) < 110:
        acc = b.mul_add(acc, x, x)
    eq = b.is_equal(acc, b.constant(12345))
    b.assert_zero(eq)
    b.register_public_input(acc)
    data = b.build()
    w = data.new_witness()
    w.set(x, 3)
    w.generate()
    return data, w


FLAGSHIP_ROWS_USED = 166_704  # of 2^18: the full light-client circuit's count


def flagship_circuit(log_n: int, seed: int):
    """A circuit of the flagship's shape and a witness that satisfies it, written
    directly as tables (3.3 M builder calls in Python would take minutes).

    CircuitConfig(num_wires=184) with its defaults; rows_used = 166,704 scaled
    to 2^log_n rows: one const row, two noop rows (public inputs), an eighth of
    the rest basesum2 rows (two 32-bit decompositions each), the others arith
    rows of 20 ops out = c0 * a * b + c1 * c with per-row constants.  Copy
    constraints, all classes of two slots: b of op k is a of op k + 1, out of
    op k is c of op k + 1 (same row), a of op 0 and b of op 19 are shared by
    each pair of neighbouring arith rows, two noop wires copy two const wires: sigma
    differs from the identity on 79 of the 80 routed columns.  Wires 80 to 183
    are free advice: seeded words.  Returns (CircuitData, Witness).
    """
    from eth_lc_plonky2_tpu_torch.circuit import gates as G
    from eth_lc_plonky2_tpu_torch.circuit.builder import CircuitData, Target
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl, host_field as hf
    from eth_lc_plonky2_tpu_torch.prover.config import CircuitConfig

    cfg = CircuitConfig(num_wires=NUM_WIRES)
    nw, nr, nc = cfg.num_wires, cfg.num_routed_wires, cfg.num_constants
    n = 1 << log_n
    used = (FLAGSHIP_ROWS_USED << log_n) >> LOG_N
    rng = np.random.default_rng(seed)
    num_ops = 20
    gates = [G.ArithmeticGate(num_ops), G.BaseSum2Gate(), G.ConstantGate(nc), G.NoopGate()]
    gate_names = [g.name for g in gates]  # sorted, as CircuitBuilder.build() orders them
    const_row, noop_rows = 0, np.array([1, 2])
    num_bs = (used - 3) // 8
    bs_rows = np.arange(3, 3 + num_bs)
    arith_rows = np.arange(3 + num_bs, used)
    arith_rows = arith_rows[: len(arith_rows) & ~1]  # whole pairs; a last odd row stays a pad row
    used = int(arith_rows[-1]) + 1

    selectors = np.zeros((len(gates), n), dtype=np.uint64)
    selectors[0, arith_rows] = 1
    selectors[1, bs_rows] = 1
    selectors[2, const_row] = 1
    selectors[3, noop_rows] = 1
    constants = np.zeros((nc, n), dtype=np.uint64)
    constants[:2, arith_rows] = rng.integers(0, gl.P, size=(2, len(arith_rows)), dtype=np.uint64)
    constants[:, const_row] = rng.integers(0, gl.P, size=nc, dtype=np.uint64)

    # the witness matrix, rows x wires
    wit = np.zeros((n, nw), dtype=np.uint64)
    wit[:used, nr:] = rng.integers(0, gl.P, size=(used, nw - nr), dtype=np.uint64)
    wit[const_row, :nc] = constants[:, const_row]
    wit[const_row, nc:nr] = rng.integers(0, gl.P, size=nr - nc, dtype=np.uint64)
    wit[noop_rows, :nr] = rng.integers(0, gl.P, size=(2, nr), dtype=np.uint64)
    wit[noop_rows, 2] = constants[:2, const_row]  # copies of const wires 0 and 1
    values = rng.integers(0, 1 << 32, size=(num_bs, 2), dtype=np.uint64)
    for slot in range(2):
        wit[bs_rows, 33 * slot] = values[:, slot]
        wit[bs_rows[:, None], 33 * slot + 1 + np.arange(32)[None, :]] = (
            (values[:, slot, None] >> np.arange(32, dtype=np.uint64)[None, :]) & np.uint64(1))
    wit[bs_rows, 66:nr] = rng.integers(0, gl.P, size=(num_bs, nr - 66), dtype=np.uint64)
    ra = len(arith_rows)
    a0 = np.repeat(rng.integers(0, gl.P, size=ra // 2, dtype=np.uint64), 2)
    b = rng.integers(0, gl.P, size=(ra, num_ops), dtype=np.uint64)
    b[:, -1] = np.repeat(b[0::2, -1], 2)
    c0, c1 = constants[0, arith_rows], constants[1, arith_rows]
    a, c = a0, rng.integers(0, gl.P, size=ra, dtype=np.uint64)
    for k in range(num_ops):
        out = hf.add(hf.mul(c0, hf.mul(a, b[:, k])), hf.mul(c1, c))
        wit[arith_rows, 4 * k : 4 * k + 4] = np.stack([a, b[:, k], c, out], axis=1)
        a, c = b[:, k], out

    # copy classes of two slots each: (row, col) <-> (row2, col2)
    pairs = []
    for k in range(num_ops - 1):
        pairs.append((arith_rows, 4 * k + 1, arith_rows, 4 * k + 4))  # b_k = a_{k+1}
        pairs.append((arith_rows, 4 * k + 3, arith_rows, 4 * k + 6))  # out_k = c_{k+1}
    for col in (0, 4 * num_ops - 3):  # a of op 0 and b of the last op, of a pair of rows
        pairs.append((arith_rows[0::2], col, arith_rows[1::2], col))
    for i in range(2):
        pairs.append((np.array([const_row]), i, noop_rows[i : i + 1], 2))
    omega_pows = hf.powers(gl.primitive_root_of_unity(log_n), n)
    k_shifts = hf.powers(gl.MULTIPLICATIVE_GENERATOR, nr)
    sigma = hf.mul(k_shifts[:, None], omega_pows[None, :])
    rep = np.arange(n * nw, dtype=np.int64)
    for r1, col1, r2, col2 in pairs:
        if not np.array_equal(wit[r1, col1], wit[r2, col2]):
            fail(f"flagship circuit: columns {col1} and {col2} do not hold equal copies")
        sigma[col1, r1] = hf.mul(k_shifts[col2], omega_pows[r2])
        sigma[col2, r2] = hf.mul(k_shifts[col1], omega_pows[r1])
        first, second = r1 * nw + col1, r2 * nw + col2
        rep[np.maximum(first, second)] = np.minimum(first, second)
    identity = hf.mul(k_shifts[:, None], omega_pows[None, :])
    moved = int((sigma != identity).any(axis=1).sum())
    if moved < nr - 1:
        fail(f"flagship circuit: sigma differs from the identity on {moved} columns only")

    data = CircuitData(
        config=cfg, log_n=log_n, num_rows_used=used, gate_names=gate_names, gates=gates,
        selectors=selectors, constants=constants, sigma=sigma, rep=rep, generators=[],
        public_input_targets=[Target(int(noop_rows[0]), 0), Target(int(noop_rows[1]), 1)],
        k_shifts=k_shifts)
    witness = data.new_witness()
    witness.values = wit.reshape(-1)
    witness.known[:] = True
    return data, witness


def proof_dict(proof) -> dict:
    from eth_lc_plonky2_tpu_torch.prover import serialize

    return serialize.proof_to_dict(proof, include_indices=True)


def first_difference(got, want, path="proof"):
    """The path of the first field in which two proof dicts differ, or None."""
    if type(got) is not type(want):
        return path
    if isinstance(want, dict):
        if list(got) != list(want):
            return f"{path} (keys)"
        for key in want:
            if (where := first_difference(got[key], want[key], f"{path}.{key}")):
                return where
        return None
    if isinstance(want, list):
        if len(got) != len(want):
            return f"{path} (length)"
        for i, (g, w) in enumerate(zip(got, want)):
            if (where := first_difference(g, w, f"{path}[{i}]")):
                return where
        return None
    return None if got == want else path


def prove_kernels_and_plain(torch, pd, witness, what: str, sources: tuple) -> dict:
    """Prove once on the kernels (each of ``sources`` must launch) and once on
    the plain versions, both on the card; the two proofs must be equal.
    Returns the proof's dict."""
    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import prove

    before = dict(kernels.launches)
    on_kernels = proof_dict(prove.prove(pd, witness))
    if min(kernels.launches[k] - before[k] for k in sources) <= 0:
        fail(f"{what}: the proof on the kernels missed a kernel: {kernels.launches} after {before}")
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    # The package takes a CUDA tensor to its kernels and nowhere else; only
    # here, for this comparison, is its test of the device replaced, so that
    # every wrapper runs its plain version on the card.
    with mock.patch.object(kernels, "on_card", lambda t: False):
        # the per-circuit tables too are made by the plain versions
        plain_pd = prove.ProverData(data=pd.data, pre_values=pd.pre_values,
                                    pre_batch=pd.pre_batch, dev=pd.dev)
        on_plain = proof_dict(prove.prove(plain_pd, witness))
    torch.cuda.synchronize()
    if kernels.launches != before:
        fail(f"{what}: the plain proof launched a kernel: {kernels.launches} after {before}")
    if (where := first_difference(on_kernels, on_plain)):
        fail(f"{what}: the proofs on the kernels and on the plain versions differ at {where}")
    log(f"{what}: the proof on the kernels == the proof on the plain versions on the card "
        f"(plain: {time.perf_counter() - t0:.1f} s)")
    return on_kernels


def phase5(torch) -> None:
    from eth_lc_plonky2_tpu_torch.prover import prove

    data, witness = dryrun_circuit()
    pd, vk = prove.preprocess(data)  # the card is the default
    z = np.load(os.path.join(REPO, "assets", "dryrun", "pre.npz"))
    if not np.array_equal(vk.pre_cap, z[f"level_{int(z['num_levels'][0]) - 1}"]):
        fail("dryrun circuit: the preprocessed cap differs from assets/dryrun/pre.npz")
    if pd.device.type != "cuda":
        fail(f"dryrun circuit: preprocess left its data on {pd.device}")
    got = prove_kernels_and_plain(torch, pd, witness, "[5] dryrun circuit",
                                  ("ntt", "poseidon", "field", "gates"))
    with open(os.path.join(REPO, "assets", "dryrun", "ref_proof.json")) as f:
        want = json.load(f)
    if (where := first_difference(got, want)):
        fail(f"dryrun circuit: the proof differs from assets/dryrun/ref_proof.json at {where}")
    from eth_lc_plonky2_tpu_torch.prover import serialize

    check_proof(data, vk, serialize.proof_from_dict(got), witness, "[5] dryrun circuit")
    log(f"[5] dryrun circuit ({data.config.num_wires} wires, 2^{data.log_n} rows): pre_cap == "
        "pre.npz, and the proof made on the card == assets/dryrun/ref_proof.json key by key")


def tree_launches(num_leaves: int, cap_height: int) -> int:
    """Sponge launches of one tree: the leaves, a launch a large level, and
    one for all the small levels."""
    from eth_lc_plonky2_tpu_torch.ops import poseidon as pos

    count, n = 1, num_leaves
    while n > (1 << cap_height):
        count += 1
        if n // 2 <= pos.TAIL_MAX_PAIRS:
            break
        n //= 2
    return count


def check_proof(data, vk, proof, witness, what: str) -> None:
    """The port's verifier must accept the proof (every challenge re-derived,
    the constraint identity at zeta, every query's Merkle paths, FRI's folds,
    the final polynomial, the PoW), and the public inputs must be the
    witness's."""
    from eth_lc_plonky2_tpu_torch.prover.verify import VerificationError, verify

    t0 = time.perf_counter()
    try:
        verify(data, vk, proof)
    except VerificationError as e:
        fail(f"{what}: the verifier rejects the proof: {e}")
    want_pi = [witness.get(t) for t in data.public_input_targets]
    if [int(v) for v in proof.public_inputs] != want_pi or not want_pi:
        fail(f"{what}: public inputs {proof.public_inputs} are not the witness's {want_pi}")
    fp = proof.fri_proof
    log(f"{what}: verify() accepts the proof in {time.perf_counter() - t0:.2f} s on the host "
        f"({len(fp.query_indices)} queries x (4 batch trees + {len(fp.layer_caps)} FRI layers), "
        f"{len(proof.openings.values)} opening points, PoW witness {fp.pow_witness}); public "
        f"inputs == the witness's")


BY_SOURCE = {"ntt_pass_kernel": "ntt", "sponge_kernel": "poseidon",
             "merkle_level_kernel": "poseidon", "merkle_tail_kernel": "poseidon",
             "field_binary_kernel": "field", "field_inv_kernel": "field",
             "field_open_kernel": "field", "field_open_sum_kernel": "field",
             "perm_quotient_kernel": "field", "fri_g_kernel": "field", "fri_fold_kernel": "field",
             "perm_z_kernel": "field", "perm_z_scan_kernel": "field", "perm_z_fixup_kernel": "field",
             "sha_gate_quotient_kernel": "gates", "poseidon_gate_quotient_kernel": "gates",
             "generic_gate_quotient_kernel": "gates"}


def launch_plan(data, pow_witness: int, field: int, gates: int) -> dict:
    """The launches of one steady prove at this script's widths (184 wires, 20 Z
    and 16 quotient polynomials): three commitments, the quotients' inverse
    transform (a four-step at 2^21) and the final polynomial's (one pass);
    three trees, a tree a FRI layer, a grind batch up to the witness; the
    circuit's eager field ops and its gates' own kernels."""
    from eth_lc_plonky2_tpu_torch.prover import prove

    cfg = data.config
    n_lde = data.n << cfg.rate_bits
    chunks = [-(-rows // prove._COMMIT_CHUNK) for rows in (NUM_WIRES, NUM_Z, NUM_QUOTIENT)]
    plan_ntt = 2 * (2 * chunks[0] + 2 * chunks[1] + chunks[2]) + 2 + 1
    grind_batch = 1 << min(20, cfg.fri.proof_of_work_bits + 3)
    layers = data.log_n - cfg.fri.final_poly_bits
    plan_sponge = (3 * tree_launches(n_lde, cfg.cap_height)
                   + sum(tree_launches(n_lde >> (k + 1), 4) for k in range(layers))
                   + pow_witness // grind_batch + 1)
    return {"ntt": plan_ntt, "poseidon": plan_sponge, "field": field, "gates": gates}


def profile_prove(torch, tag: str, pd, witness, first_proof, card: str, field_plan: int,
                  gates_plan: int) -> dict:
    """A warm-up, three timed proves with the phase marks, a steady prove whose
    launches must be the plan's, and a scheduled trace split by kernel name
    whose launches must be the wrappers' counts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import prove
    from eth_lc_plonky2_tpu_torch.prover.profiler import Profiler

    prove.prove(pd, witness)  # warm-up: every table is cached now
    runs, phases, proofs = [], [], []
    for _ in range(3):
        prof = Profiler(enabled=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proofs.append(prove.prove(pd, witness, prof=prof))
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        phases.append(prof.times)
    prove_ms = statistics.median(runs) * 1e3
    log(f"{tag} prove: median {prove_ms:.2f} ms of {len(runs)} "
        f"({', '.join(f'{r * 1e3:.2f}' for r in runs)}), each phase ending in a synchronize "
        f"[{card}]")
    want = proof_dict(first_proof)
    for p in proofs:
        if (where := first_difference(proof_dict(p), want)):
            fail(f"two proofs of one witness differ at {where}")
    phase_ms = {name: statistics.median(ph[name] for ph in phases) * 1e3 for name in phases[0]}
    for name, ms in sorted(phase_ms.items(), key=lambda kv: -kv[1]):
        log(f"{tag} phase {name}: {ms:.3f} ms (median of {len(phases)}) [{card}]")

    # a steady-state prove with the count of launches, and the peak memory;
    # the permutation rows' own launches are counted around their call
    perm_launches = []
    permutation_polys = prove.permutation_polys

    def counted(*args):
        before = dict(kernels.launches)
        out = permutation_polys(*args)
        perm_launches.append({k: v - before[k] for k, v in kernels.launches.items() if v != before[k]})
        return out

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with mock.patch.object(prove, "permutation_polys", counted):
        prove.prove(pd, witness)
    torch.cuda.synchronize()
    steady = dict(kernels.launches)
    steady_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plan = launch_plan(pd.data, first_proof.fri_proof.pow_witness, field_plan, gates_plan)
    if steady != plan:
        fail(f"{tag} a steady prove launched {steady}, the plan is {plan}")
    cfg = pd.data.config
    perm_plan = kernels.perm_z_plan(cfg.num_routed_wires, pd.data.n, cfg.permutation_chunk_size,
                                    cfg.num_challenges)
    if perm_launches != [{"field": perm_plan["launches"]}]:
        fail(f"{tag} the permutation rows launched {perm_launches}, the plan is one call of "
             f"csrc/field.cu's perm_z_kernel, its scan and its fix-up")
    log(f"{tag} a steady prove launches {steady} (as planned: three commitments, the quotient's "
        f"and the final polynomial's inverse transforms; three trees, "
        f"{pd.data.log_n - pd.data.config.fri.final_poly_bits} FRI layer trees, the grind; the eager "
        f"field ops of this circuit; a launch a gate that has its own kernel), peak memory "
        f"{steady_peak_gb:.2f} GB [{card}]")

    # Device time by kernel name, and the idle share of the window.  A trace
    # that starts cold can lose the first device records after a long host
    # phase (the witness upload and the first NTT passes went missing in one
    # trace of three), so each trace has a warm-up prove that is traced and
    # discarded before the active one.  A trace whose launches are not the
    # wrappers' counts is incomplete: it is taken again, at most three times,
    # and the profile's line says how many were discarded.
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as tprof:
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prove.prove(pd, witness, prof=Profiler(enabled=False))
                torch.cuda.synchronize()
                window_ms = (time.perf_counter() - t0) * 1e3
                tprof.step()
        by_name = {}
        for ev in tprof.key_averages():
            if (ev.device_type.name != "CPU" and ev.self_device_time_total > 0
                    and not ev.key.startswith("ProfilerStep")):  # the step's own span is no work
                own = re.search(r"\w+_kernel\b", ev.key)
                name = own.group(0) if own else ev.key[:48]
                entry = by_name.setdefault(name, {"ms": 0.0, "launches": 0})
                entry["ms"] += ev.self_device_time_total / 1e3
                entry["launches"] += ev.count
        seen = dict.fromkeys(steady, 0)
        for name, source in BY_SOURCE.items():
            seen[source] += by_name.get(name, {}).get("launches", 0)
        if seen == steady:
            break
        log(f"{tag} trace {attempt + 1} shows launches {seen}, the wrappers counted {steady}")
    else:
        fail(f"three traces in a row lost records: {seen} against {steady}")
    busy_ms = sum(v["ms"] for v in by_name.values())
    for name, v in sorted(by_name.items(), key=lambda kv: -kv[1]["ms"]):
        log(f"{tag} profile, one prove: {name}: {v['ms']:.3f} ms in {v['launches']} launches [{card}]")
    log(f"{tag} profile: busy {busy_ms:.3f} ms of a {window_ms:.3f} ms window, idle share "
        f"{1 - busy_ms / window_ms:.3f}, one trace's reading, {attempt} incomplete traces "
        f"discarded before it [{card}]")
    fused = fused_launch_plan(pd)
    seen = {name: by_name.get(name, {}).get("launches", 0) for name in fused}
    if seen != fused:
        fail(f"the profile shows field launches {seen}, the plan is {fused}")
    log(f"{tag} the profile's launches by kernel source == the wrappers' counts {steady}; "
        f"the field kernels by name {fused} as planned (the permutation rows: "
        f"{perm_launches[0]} launches, none of field_binary_kernel or field_inv_kernel)")
    return {"prove_ms": prove_ms, "phase_ms": phase_ms, "by_name": by_name}


def fused_launch_plan(pd) -> dict:
    """The launches of the fused kernels in one steady prove: per opening
    batch one field_open_kernel and, with more than one slice, one
    field_open_sum_kernel; one perm_quotient_kernel, one fri_g_kernel, one
    fri_fold_kernel a FRI layer; one generic_gate_quotient_kernel; one each of
    perm_z_kernel, perm_z_scan_kernel and perm_z_fixup_kernel; and of the
    elementwise kernels only the quotient's product by 1 / Z_H (the inverse
    runs in the first prove, for the circuit's tables)."""
    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import prove

    cfg = pd.data.config
    rows = {"P": pd.pre_values.shape[0], "W": cfg.num_wires,
            "Z": cfg.num_challenges * cfg.num_permutation_chunks,
            "Q": cfg.num_challenges << cfg.rate_bits}
    points = {}
    for tag, _ in prove.opening_point_specs(pd.data):
        points[tag] = points.get(tag, 0) + 1
    plans = [kernels.field_open_plan(rows[tag], pd.data.n, k) for tag, k in points.items()]
    return {"field_open_kernel": len(plans),
            "field_open_sum_kernel": sum(p["launches"] - 1 for p in plans),
            "perm_quotient_kernel": 1, "fri_g_kernel": 1,
            "fri_fold_kernel": pd.data.log_n - cfg.fri.final_poly_bits,
            "generic_gate_quotient_kernel": 1, "perm_z_kernel": 1, "perm_z_scan_kernel": 1,
            "perm_z_fixup_kernel": 1, "field_binary_kernel": 1, "field_inv_kernel": 0}


def first_prove(torch, tag: str, pd, witness, card: str, sources: tuple):
    """The main path: one proof, counts set to 0 just before and read just after."""
    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import prove

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    proof = prove.prove(pd, witness)
    torch.cuda.synchronize()
    launched = dict(kernels.launches)
    first_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag} first prove (makes the per-circuit tables) in {first_s:.3f} s, launches {launched}, "
        f"peak memory {peak_gb:.2f} GB [{card}]")
    for name in sources:
        if launched[name] <= 0:
            fail(f"{tag} the main path never launched the {name} kernel")
    return proof, launched


def phase6(torch, chk: Checker, rng, card: str, seed: int) -> dict:
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl, kernels
    from eth_lc_plonky2_tpu_torch.prover import prove

    # the same circuit at 2^12 rows: kernels against plain versions, whole proofs
    small, small_w = flagship_circuit(12, seed)
    small_pd, small_vk = prove.preprocess(small)
    prove_kernels_and_plain(torch, small_pd, small_w, "[6] flagship shape at 2^12 rows",
                            ("ntt", "poseidon", "field", "gates"))
    check_proof(small, small_vk, prove.prove(small_pd, small_w), small_w, "[6] 2^12 rows")
    del small_pd

    t0 = time.perf_counter()
    data, witness = flagship_circuit(LOG_N, seed)
    cfg = data.config
    log(f"[6] circuit tables and witness in {time.perf_counter() - t0:.1f} s: {cfg.num_wires} wires, "
        f"2^{data.log_n} rows, {data.num_rows_used} used, gates {data.gate_names}, "
        f"{len(data.public_input_targets)} public inputs")
    t0 = time.perf_counter()
    pd, vk = prove.preprocess(data)
    torch.cuda.synchronize()
    log(f"[6] preprocess ({pd.pre_values.shape[0]} polys) in {time.perf_counter() - t0:.3f} s")
    proof, launched = first_prove(torch, "[6]", pd, witness, card,
                                  ("ntt", "poseidon", "field", "gates"))
    if launched["gates"] != 1:
        fail(f"[6] a circuit of generic gates launched {launched['gates']} gate kernels, not 1")
    check_proof(data, vk, proof, witness, "[6] 2^18 rows")
    res = profile_prove(torch, "[6]", pd, witness, proof, card, STEADY_FIELD_LAUNCHES, 1)
    n_lde = data.n << cfg.rate_bits

    # the field kernel beside its plain version at a main-path shape: one
    # permutation chunk (8, 2^21) times another
    a = gl.from_u64(rng.integers(0, gl.P, size=(8, n_lde), dtype=np.uint64), DEVICE)
    b = gl.from_u64(rng.integers(0, gl.P, size=(8, n_lde), dtype=np.uint64), DEVICE)
    field_ms = cuda_ms(lambda: gl.mul(a, b), 9)
    field_plain_ms = cuda_ms(lambda: gl.mul_plain(a, b), 3)
    chk.same("field", gl.mul(a, b), gl.mul_plain(a, b), "timed field mul")
    # and ten launches back to back (no host time between them)
    back10_ms = cuda_ms(lambda: [gl.mul(a, b) for _ in range(10)], 5) / 10
    add_ms = cuda_ms(lambda: gl.add(a, b), 9)
    row_ms = cuda_ms(lambda: gl.mul(a, b[0]), 9)
    inv_in = a[:5]  # the table's shape since the inverse kernel came: (5, 2^21)
    inv_ms = cuda_ms(lambda: gl.inv(inv_in), 9)
    inv_plain_ms = cuda_ms(lambda: gl.inv_plain(inv_in), 1)
    chk.same("field", gl.inv(inv_in), gl.inv_plain(inv_in), "timed field inv")
    # a 64 x 64 product is 4 multiply-adds of 32 x 32 bits, its reduction one more
    field_bound = bound_of(3 * a.numel() * 8, a.numel() * 5)
    inv_bound = bound_of(2 * inv_in.numel() * 8, inv_in.numel() * INV_PRODUCTS_PER_WORD * 5)
    log(f"[6] field: mul (8, 2^21) x (8, 2^21): kernel {field_ms:.3f} ms, plain "
        f"{field_plain_ms:.3f} ms, bound {field_bound[0]:.4f} ms by {field_bound[1]} "
        f"({field_bound[0] / field_ms:.1%} of the kernel's time); ten launches back to back: "
        f"{back10_ms:.4f} ms a launch ({field_bound[0] / back10_ms:.1%} of its bound); add "
        f"{add_ms:.3f} ms; mul by a row (2^21,) {row_ms:.3f} ms [{card}]")
    log(f"[6] field inv (5, 2^21): field_inv_kernel {inv_ms:.4f} ms, plain {inv_plain_ms:.3f} ms, "
        f"bound {inv_bound[0]:.4f} ms by {inv_bound[1]} (16 bytes and {INV_PRODUCTS_PER_WORD} "
        f"products a word: {kernels.FIELD_INV_RUN} words a Fermat power; "
        f"{inv_bound[0] / inv_ms:.1%} of the kernel's time) [{card}]")
    return {"launches": launched, "prove_ms": res["prove_ms"], "phase_ms": res["phase_ms"],
            "field": (field_ms, field_plain_ms, *field_bound),
            "field_inv": (inv_ms, inv_plain_ms, *inv_bound),
            "field_back_to_back_ms": back10_ms}


# ---------------------------------------------------------------------------
# Phase 7: a light-client-shaped circuit of SHA-256 and Poseidon rows
# ---------------------------------------------------------------------------

MERKLE_HEIGHT = 10  # 1,024 leaves: 1,023 two-to-one hashes, 2,046 compressions
POSEIDON_CHAIN_ROWS = 16_000
# 2^8 is one tile of the SHA-256 gate's kernel (kernels.SHA_TILE columns a
# block), 2^9 the smallest domain where a block's w halo (15 trace rows, 120
# columns) lies in another block
GATE_SIZES = (1 << 7, 1 << 8, 1 << 9, 1 << 12, 1 << 15)
# csrc/field.cu launches of one steady prove of phase 7's circuit (12 opening
# points), counted as STEADY_FIELD_LAUNCHES: 5,187 - 12 x 276 - 358 + 9 =
# 1,526, then 1,526 - 896 (generic gates and 12 public inputs) - 272 (G) -
# 234 (folds) + 14, then 138 - 86 (the permutation rows) - 28 (the alpha
# powers) + 3: the same launches as phase 6's.
LC_STEADY_FIELD_LAUNCHES = 27

# 32 x 32 multiply-adds a column of each gate, two challenges, each polynomial
# in the cheapest form known (which is also csrc/gates.cu's): a field product
# is 4, its reduction one more; a multiply-accumulate into the 96-bit column
# sums is 4.
# SHA-256: a rotation xor3 is 2 products and an xor2 one, in the sign form
# (1 - XYZ) / 2 (S1, S0: 32 xor3 each; s1: 22 xor3 + 10 xor2; s0: 29 + 3),
# with the halving 3; ch = g + e (f - g) one x 32, maj = ab + c (a + b - 2 ab)
# 2 x 32, the booleanity squares 96, the carries' 2^32 3, the range products
# 15, the masks 6 and one a challenge, the selector one a challenge; 105
# multiply-accumulates a challenge, four sums reduced.
SHA_GATE_PRODUCTS = (2 * 32 * 2 + (22 * 2 + 10) + (29 * 2 + 3) + 3 + 32 + 2 * 32 + 96 + 3 + 15
                     + 6 + 2 + 2)
SHA_GATE_MADS = SHA_GATE_PRODUCTS * 5 + 2 * 105 * 4 + 4
# its distinct rows, each read once: 96 bit wires, 3 word and 3 carry wires, 4
# constant rows, the selector and the two accumulators, which are also written
SHA_GATE_ROWS = 3 * 32 + 6 + 4 + 1 + 2 + 2
# Poseidon: the permutation in the sponge's cheapest form (MADS_PER_PERMUTATION:
# the 22 partial rounds sparse), 130 multiply-accumulates a challenge and the
# selector's product a challenge.
POSEIDON_GATE_MADS = MADS_PER_PERMUTATION + 2 * 130 * 4 + 2 * 5


def light_client_circuit(height: int, chain_rows: int, seed: int):
    """A circuit of the light-client circuit's two row kinds, built with the
    port's own CircuitBuilder at CircuitConfig(num_wires=184): the SHA-256 Merkle root
    of 2^height 32-byte leaves (2^height - 1 two-to-one hashes of two 68-row
    compression segments each, and their feed-forward adds), the root as public
    inputs, then a chain of ``chain_rows`` Poseidon permutation rows whose last
    state's first four words are public inputs.  Leaves and the chain's first
    state come from ``seed``.  Returns (data, witness, leaves, first state)."""
    from eth_lc_plonky2_tpu_torch.circuit import gadgets_merkle as gm, gates_poseidon as gp
    from eth_lc_plonky2_tpu_torch.circuit.builder import CircuitBuilder
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
    from eth_lc_plonky2_tpu_torch.prover.config import CircuitConfig

    rng = np.random.default_rng(seed)
    b = CircuitBuilder(CircuitConfig(num_wires=NUM_WIRES))
    tree = gm.add_virtual_merkle_tree_sha256(b, height)
    b.register_public_inputs(tree.root)
    first = b.add_virtual_targets(12)
    state = first
    for _ in range(chain_rows):
        state = gp.add_poseidon_permutations(b, [state])[0]
    b.register_public_inputs(state[:4])
    data = b.build()
    witness = data.new_witness()
    leaves = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(1 << height)]
    gm.set_partial_merkle_tree_sha256_target(witness, leaves, tree)
    first_state = [int(v) for v in rng.integers(0, gl.P, size=12, dtype=np.uint64)]
    for t, v in zip(first, first_state):
        witness.set(t, v)
    witness.generate()
    return data, witness, leaves, first_state


def check_light_client_outputs(proof, leaves, first_state, chain_rows: int, what: str) -> None:
    """The public inputs are the leaves' SHA-256 Merkle root (hashlib) and the
    first four words of the Poseidon chain's last state (the host permutation)."""
    import hashlib

    from eth_lc_plonky2_tpu_torch.ops import poseidon as pos, sha256 as sha

    layer = list(leaves)
    while len(layer) > 1:
        layer = [hashlib.sha256(layer[i] + layer[i + 1]).digest() for i in range(0, len(layer), 2)]
    pis = [int(v) for v in proof.public_inputs]
    if sha.bytes_from_words(np.array(pis[:8], dtype=np.uint32)) != layer[0] or max(pis[:8]) >> 32:
        fail(f"{what}: the proof's root is not hashlib's SHA-256 Merkle root")
    state = list(first_state)
    for _ in range(chain_rows):
        state = pos.permute_host(state)
    if pis[8:] != state[:4]:
        fail(f"{what}: the Poseidon chain's public inputs are not the host permutation's")
    log(f"{what}: public inputs == hashlib's SHA-256 Merkle root of {len(leaves)} leaves and the "
        f"host's Poseidon chain of {chain_rows} permutations")


def device_rows(rng, count: int, n: int, edge=None, tail_from: int = 1, tail_step: int = 2):
    """(count, n) seeded field words made on the card (a host generator takes
    seconds for the 2^21-column inputs): two 32-bit halves a word from a
    generator seeded from ``rng``, reduced to canonical words; with ``edge``,
    its words in the first columns of every row and reversed in the last
    columns of every ``tail_step``-th row from row ``tail_from``."""
    import torch

    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl

    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(0, 1 << 62)))
    hi, lo = (torch.randint(0, 1 << 32, (count, n), generator=gen, dtype=torch.int64, device=DEVICE)
              for _ in range(2))
    rows = gl.add_plain((hi << 32) | lo, torch.zeros((), dtype=torch.int64, device=DEVICE))
    if edge is not None:
        k = min(n, len(edge))
        rows[:, :k] = gl.from_u64(edge[:k], DEVICE)
        rows[tail_from::tail_step, n - k:] = gl.from_u64(edge[::-1][:k].copy(), DEVICE)
    return rows


def gate_inputs(rng, n_lde: int, num_constraints: int) -> tuple:
    """Random field words for a gate's quotient share (not only bits), with the
    edge words 0, 1, p - 1, 2^32 - 1, 2^32 in the first and last columns:
    (wires (184, n_lde), constant rows (4, n_lde), selector, alpha rows,
    accumulators: two challenges), on the card."""
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl

    edge = np.array([0, 1, gl.P - 1, (1 << 32) - 1, 1 << 32], dtype=np.uint64)
    dev = lambda a: gl.from_u64(a, DEVICE)  # noqa: E731
    accs = device_rows(rng, 2, n_lde)
    return (device_rows(rng, NUM_WIRES, n_lde, edge, tail_from=0, tail_step=3), device_rows(rng, 4, n_lde),
            device_rows(rng, 1, n_lde)[0],
            [dev(rng.integers(0, gl.P, size=(num_constraints,), dtype=np.uint64)) for _ in range(2)],
            [accs[0], accs[1]])


def gate_generic(gate, inputs, rate_bits: int, plain: bool) -> list:
    """The generic loop over ``gate.eval`` on the card: on csrc/field.cu, or
    with ``plain`` on the plain ops (the package's test of the device replaced
    from outside, as for whole proofs)."""
    from eth_lc_plonky2_tpu_torch.circuit.algebra import DeviceBaseAlgebra
    from eth_lc_plonky2_tpu_torch.circuit.gates import absorb_quotient_generic
    from eth_lc_plonky2_tpu_torch.ops import ntt

    wires_lde, const_rows, sel, apow_rows, accs = inputs

    def run():
        return absorb_quotient_generic(
            gate, DeviceBaseAlgebra((wires_lde.shape[1],), DEVICE),
            lambda col, offset=0: ntt.roll_lde(wires_lde[col], offset, rate_bits),
            lambda i: const_rows[i], sel, apow_rows, accs)

    return on_plain(run) if plain else run()


def gate_kernel(gate, inputs, rate_bits: int, accs=None) -> list:
    """The gate's kernel on ``inputs``; it adds to the accumulators in place,
    so unless ``accs`` is given it works on copies of the inputs' own."""
    wires_lde, const_rows, sel, apow_rows, acc_in = inputs
    if accs is None:
        accs = [a.clone() for a in acc_in]
    return gate.absorb_quotient_device(wires_lde, lambda i: const_rows[i], sel, apow_rows, accs,
                                       rate_bits)


def check_gate_kernels(torch, chk: Checker, rng) -> None:
    """Each gate kernel against the generic loop on the plain ops, on random
    field words with the edge words among them, at rate 2^3 (offset -16 is 128
    columns back: at n_lde = 2^7 every column's neighbours wrap around the
    start of the domain)."""
    from eth_lc_plonky2_tpu_torch.circuit.gates_poseidon import PoseidonGate
    from eth_lc_plonky2_tpu_torch.circuit.gates_sha256 import Sha256RoundGate
    from eth_lc_plonky2_tpu_torch.ops import kernels

    for gate in (Sha256RoundGate(), PoseidonGate()):
        for n_lde in GATE_SIZES:
            inputs = gate_inputs(rng, n_lde, gate.num_constraints)
            before = kernels.launches["gates"]
            got = gate_kernel(gate, inputs, RATE_BITS)
            if kernels.launches["gates"] - before != 1:
                fail(f"gate {gate.name}: {kernels.launches['gates'] - before} launches")
            want = gate_generic(gate, inputs, RATE_BITS, plain=True)
            for j in range(2):
                chk.same("gates", got[j], want[j], f"gate {gate.name}, n_lde {n_lde}, challenge {j}")
        torch.cuda.synchronize()
    log(f"[7] gate kernels == the generic eval loop on the plain ops at n_lde {GATE_SIZES}, "
        f"rate 2^{RATE_BITS}, on random field words and the edge words")
    plan = kernels.sha_gate_plan(1 << (LOG_N + RATE_BITS), RATE_BITS)
    staged = 32 * (2 * (plan["tile"] + plan["halo_ae"]) + plan["tile"] + plan["halo_w"]) / plan["tile"]
    log(f"[7] the SHA-256 gate's tiles: {plan['tile']} columns a block, halos of "
        f"{plan['halo_ae']} (a, e) and {plan['halo_w']} (w) columns, {plan['shared_bytes']} bytes "
        f"of shared memory a block; {staged:.2f} bit rows staged a column for 96 distinct, so "
        f"the kernel moves {staged - 96 + SHA_GATE_ROWS:.2f} rows a column against the bound's "
        f"{SHA_GATE_ROWS}")


def ptxas_info(text: str) -> dict:
    """{kernel (mangled name): {"registers", "spill_bytes", "shared_bytes"}} from
    an ``-Xptxas -v`` report."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = out.setdefault(m.group(1), {"registers": None, "spill_bytes": None,
                                                  "shared_bytes": 0})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            current["shared_bytes"] = int(smem.group(1)) if smem else 0
    return out


def kernel_registers(name: str) -> dict:
    """ptxas's registers, spills and static shared memory of the kernel whose
    mangled name holds ``name``, from this process's build; None each where
    the library was built before (no report)."""
    from eth_lc_plonky2_tpu_torch.ops import kernels

    found = [v for k, v in ptxas_info(kernels.build()["ptxas"]).items() if name in k]
    return found[0] if len(found) == 1 else dict.fromkeys(("registers", "spill_bytes",
                                                           "shared_bytes"))


def measure_gate_kernels(torch, chk: Checker, rng, card: str) -> dict:
    """Each gate kernel at the main path's shape, (184, 2^21) wires and two
    challenges, against the generic loop on the plain ops and on csrc/field.cu
    (same words), with its time, the generic loop's on field.cu and on the
    plain ops, its registers and its bound."""
    from eth_lc_plonky2_tpu_torch.circuit.gates_poseidon import PoseidonGate
    from eth_lc_plonky2_tpu_torch.circuit.gates_sha256 import Sha256RoundGate
    from eth_lc_plonky2_tpu_torch.ops import kernels

    n_lde = 1 << (LOG_N + RATE_BITS)
    out = {}
    # distinct rows, each read once: the wires the gate reads, its constant
    # rows, the selector and the accumulators; the accumulators written once
    specs = ((Sha256RoundGate(), "sha_gate_quotient_kernel", SHA_GATE_ROWS, SHA_GATE_MADS),
             (PoseidonGate(), "poseidon_gate_quotient_kernel", 142 + 1 + 2 + 2, POSEIDON_GATE_MADS))
    for gate, name, rows, mads in specs:
        inputs = gate_inputs(rng, n_lde, gate.num_constraints)
        got = gate_kernel(gate, inputs, RATE_BITS)
        before = dict(kernels.launches)
        want = gate_generic(gate, inputs, RATE_BITS, plain=False)
        torch.cuda.synchronize()
        generic_launches = kernels.launches["field"] - before["field"]
        for j in range(2):
            chk.same("gates", got[j], want[j],
                     f"gate {gate.name} at n_lde 2^21 against field.cu, challenge {j}")
        del want
        scratch = [a.clone() for a in inputs[4]]  # the timed launches add into these
        ms = cuda_ms(lambda: gate_kernel(gate, inputs, RATE_BITS, scratch), 5)
        del scratch
        field_ms = cuda_ms(lambda: gate_generic(gate, inputs, RATE_BITS, plain=False), 1)
        plain = []  # the one timed run of the plain version is also the one compared
        plain_ms = cuda_ms(lambda: plain.append(gate_generic(gate, inputs, RATE_BITS, plain=True)), 1)
        for j in range(2):
            chk.same("gates", got[j], plain[-1][j],
                     f"gate {gate.name} at n_lde 2^21 against the plain ops, challenge {j}")
        del got, plain
        by_bytes = rows * n_lde * 8 / PEAK_BYTES_PER_S * 1e3
        by_ops = mads * n_lde / PEAK_INT32_MADS_PER_S * 1e3
        bound = (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations")
        regs = kernel_registers(name)
        log(f"[7] gate {gate.name} at (184, 2^21), 2 challenges: kernel {ms:.3f} ms, its words == "
            f"the generic eval loop's on the plain ops and on field.cu; the generic "
            f"eval loop on field.cu {field_ms:.3f} ms in {generic_launches} launches, on the plain "
            f"ops {plain_ms:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]} (bytes {by_bytes:.4f} ms "
            f"for {rows} rows, operations {by_ops:.4f} ms for {mads} multiply-adds a "
            f"column; {bound[0] / ms:.1%} of the kernel's time); {regs['registers']} registers, "
            f"{regs['spill_bytes']} bytes spilled, {regs['shared_bytes']} bytes of static shared "
            f"memory [{card}]")
        out[gate.name] = {"ms": ms, "plain_ms": plain_ms, "field_ms": field_ms,
                          "bound_ms": bound[0], "bound_by": bound[1],
                          "registers": regs["registers"]}
        del inputs
    return out


# ---------------------------------------------------------------------------
# The fused kernels of csrc/field.cu: the openings and the permutation terms
# ---------------------------------------------------------------------------

# Phase 7's opening batches: (tag, polynomials, row offsets of its points).
# The wire offsets are the SHA-256 gate's; 12 points in all.
OPEN_BATCHES = (("P", 92, (0,)), ("W", NUM_WIRES, (0, -1, -2, -3, -4, -7, -15, -16)),
                ("Z", NUM_Z, (0, 1)), ("Q", NUM_QUOTIENT, (0,)))
NUM_ROUTED = 80
PERM_CHUNK = 8


def on_plain(fn):
    """fn() with every wrapper on its plain version (the package's test of the
    device replaced from outside, as for whole proofs); fails if a kernel
    launches meanwhile."""
    from eth_lc_plonky2_tpu_torch.ops import kernels

    before = dict(kernels.launches)
    with mock.patch.object(kernels, "on_card", lambda t: False):
        out = fn()
    if kernels.launches != before:
        fail(f"a plain version launched a kernel: {kernels.launches} after {before}")
    return out


def opening_inputs(rng, log_n: int, zeta=None) -> list:
    """Phase 7's four opening batches at 2^log_n coefficients on the card:
    [(tag, (rows, n) coefficients, z_re, z_im)], the points zeta * omega^o of
    each batch's offsets, zeta seeded unless given; the edge words stand in
    the first and the last columns of the coefficients."""
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl, goldilocks_ext as ge

    n = 1 << log_n
    if zeta is None:
        zeta = tuple(int(v) for v in rng.integers(0, gl.P, size=2, dtype=np.uint64))
    omega = gl.primitive_root_of_unity(log_n)
    edge = field_edge_words()
    out = []
    for tag, rows, offsets in OPEN_BATCHES:
        c = rng.integers(0, gl.P, size=(rows, n), dtype=np.uint64)
        c[:, : min(n, len(edge))] = edge[: min(n, len(edge))]
        c[::3, -1] = edge[-1]
        points = [ge.h_mul(zeta, (pow(omega, o % n, gl.P), 0)) for o in offsets]
        out.append((tag, gl.from_u64(c, DEVICE), gl.from_u64([z[0] for z in points], DEVICE),
                    gl.from_u64([z[1] for z in points], DEVICE)))
    return out


def perm_inputs(rng, log_n_lde: int) -> tuple:
    """The permutation terms' arguments at 2^log_n_lde columns on the card,
    as the quotient passes them: the 80 routed rows of a (184, n_lde) wires
    LDE, the 80 sigma rows of a (92, n_lde) preprocessed LDE (from row 12),
    20 Z rows, the LDE coset x, a seeded l0, the k shifts, two betas and
    gammas, two alpha-power rows of 30; random words with the edge words in
    the first and last columns."""
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl, host_field as hf
    from eth_lc_plonky2_tpu_torch.prover import prove

    n_lde = 1 << log_n_lde
    edge = field_edge_words()
    dev = lambda a: gl.from_u64(a, DEVICE)  # noqa: E731
    wires, pre, zs = (device_rows(rng, rows, n_lde, edge) for rows in (NUM_WIRES, 92, NUM_Z))
    x = dev(prove._lde_domain_u64(log_n_lde - RATE_BITS, RATE_BITS))
    scalars = rng.integers(0, gl.P, size=(2, 2), dtype=np.uint64)
    scalars[1, 1] = gl.P - 1
    return (wires[:NUM_ROUTED], pre[12 : 12 + NUM_ROUTED], zs, x, device_rows(rng, 1, n_lde)[0],
            dev(hf.powers(gl.MULTIPLICATIVE_GENERATOR, NUM_ROUTED)), dev(scalars[0]),
            dev(scalars[1]), [dev(rng.integers(0, gl.P, size=30, dtype=np.uint64)) for _ in range(2)],
            PERM_CHUNK, RATE_BITS)


def open_all(batches, plain: bool = False) -> list:
    """``_open_core`` of each batch: the kernels, or the plain versions."""
    from eth_lc_plonky2_tpu_torch.prover import prove

    def run():
        return [prove._open_core(c, zr, zi) for _, c, zr, zi in batches]

    return on_plain(run) if plain else run()


def perm_terms(inputs, plain: bool = False):
    """The permutation terms: ``kernels.perm_quotient`` as (2, n_lde), or the
    plain version stacked the same way."""
    import torch

    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import prove

    if not plain:
        return kernels.perm_quotient(*inputs)
    return torch.stack(on_plain(lambda: prove.perm_quotient_terms_plain(*inputs)))


def generic_inputs(rng, n_lde: int) -> dict:
    """Phase 7's generic share of the quotient at n_lde columns on the card,
    as the quotient passes it: the gates in the light-client circuit's
    selector order (arith 20 ops, basesum2, const 6, noop, poseidon, sha256),
    a (184, n_lde) wires LDE, a (92, n_lde) preprocessed LDE (6 selectors, 6
    constant rows, 80 sigmas), 12 Lagrange rows, public inputs at seeded
    columns below 80, two alpha rows of 1 + 10 + 12 + 130 powers and two
    accumulators; random words with the edge words in the first and last
    columns."""
    from types import SimpleNamespace

    import torch

    from eth_lc_plonky2_tpu_torch.circuit import gates as G
    from eth_lc_plonky2_tpu_torch.circuit.gates_poseidon import PoseidonGate
    from eth_lc_plonky2_tpu_torch.circuit.gates_sha256 import Sha256RoundGate
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
    from eth_lc_plonky2_tpu_torch.prover import prove

    edge = field_edge_words()

    def rows(count):
        return device_rows(rng, count, n_lde, edge)

    gates = [G.ArithmeticGate(20), G.BaseSum2Gate(), G.ConstantGate(6), G.NoopGate(),
             PoseidonGate(), Sha256RoundGate()]
    num_pi = 12
    pi_cols = [int(c) for c in rng.integers(0, NUM_ROUTED, size=num_pi)]
    pi = rng.integers(0, gl.P, size=num_pi, dtype=np.uint64)
    pi[:5] = edge[:5]
    return {"generic": prove.split_gates(SimpleNamespace(gates=gates))[0], "wires": rows(NUM_WIRES),
            "pre": rows(92), "num_sel": len(gates), "num_con": 6, "lr": rows(num_pi),
            "pi": gl.from_u64(pi, DEVICE), "pi_cols_host": pi_cols,
            "pi_cols": torch.tensor(pi_cols, dtype=torch.int64, device=DEVICE),
            "apows": [gl.from_u64(rng.integers(0, gl.P, size=1 + 10 + num_pi + 130, dtype=np.uint64),
                                  DEVICE) for _ in range(2)],
            "accs": list(rows(2)), "pi0": 1 + 10, "k0": 1 + 10 + num_pi}


def generic_terms(inp, mode: str = "kernel"):
    """The accumulators after the generic share, (2, n_lde): ``mode`` "kernel"
    (kernels.generic_gate_quotient on copies of them), "plain" (the plain
    version on the plain ops) or "eager" (the plain version on field.cu)."""
    import torch

    from eth_lc_plonky2_tpu_torch.circuit.algebra import DeviceBaseAlgebra
    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import prove

    if mode == "kernel":
        accs = [a.clone() for a in inp["accs"]]
        kernels.generic_gate_quotient(inp["generic"], inp["wires"], inp["pre"], inp["num_sel"],
                                      inp["num_con"], inp["lr"], inp["pi"], inp["pi_cols"],
                                      inp["apows"], accs, inp["pi0"], inp["k0"])
        return torch.stack(accs)
    wires, pre = inp["wires"], inp["pre"]

    def run():
        return torch.stack(prove.generic_quotient_terms_plain(
            inp["generic"], DeviceBaseAlgebra((wires.shape[1],), DEVICE),
            lambda col, offset=0: wires[col], lambda i: pre[inp["num_sel"] + i], pre, inp["lr"],
            inp["pi"], inp["pi_cols_host"], inp["apows"], inp["accs"], inp["pi0"], inp["k0"]))

    return on_plain(run) if mode == "plain" else run()


G_SPEC_TAGS = {5: ("P", "W", "Z", "Z", "Q"), 12: ("P",) + ("W",) * 8 + ("Z", "Z", "Q")}
G_ROWS = {"P": 92, "W": NUM_WIRES, "Z": NUM_Z, "Q": NUM_QUOTIENT}  # phase 7's batches


def g_inputs(rng, log_n_lde: int, num_specs: int) -> dict:
    """FRI's G at 2^log_n_lde columns on the card: phase 7's four batches
    (92, 184, 20, 16 rows), the weights, values and points of ``num_specs``
    specs (phase 6's 5 or phase 7's 12 tags), the LDE coset; spec 1's point
    is the coset's point at column 3, so its norm is 0 there; edge words in
    the rows, the weights and the points."""
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
    from eth_lc_plonky2_tpu_torch.prover import fri

    edge = field_edge_words()
    dev = lambda a: gl.from_u64(a, DEVICE)  # noqa: E731
    ldes = [device_rows(rng, G_ROWS[tag], 1 << log_n_lde, edge) for tag in fri.TAGS]
    total = sum(G_ROWS.values())
    apow = rng.integers(0, gl.P, size=(2, total + num_specs), dtype=np.uint64)
    apow[:, :len(edge)] = edge
    y = rng.integers(0, gl.P, size=(2, num_specs), dtype=np.uint64)
    z = rng.integers(0, gl.P, size=(2, num_specs), dtype=np.uint64)
    x = fri._lde_x(log_n_lde - RATE_BITS, RATE_BITS)
    z[:, 0] = (gl.P - 1, 1 << 63)
    z[:, 1] = (x[3], 0)
    return {"ldes": ldes, "apow": (dev(apow[0]), dev(apow[1])), "y": (dev(y[0]), dev(y[1])),
            "z": (dev(z[0]), dev(z[1])), "x": dev(x), "tags": G_SPEC_TAGS[num_specs]}


def g_terms(inp, mode: str = "kernel"):
    """G as (2, n_lde): ``mode`` "kernel" (kernels.fri_g), "plain" or "eager"
    (fri.g_plain on the plain ops or on field.cu)."""
    import torch

    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import fri

    args = (inp["ldes"], inp["apow"], inp["y"], inp["z"], inp["x"])
    if mode == "kernel":
        return torch.stack(kernels.fri_g(*args, tuple(fri.TAGS.index(t) for t in inp["tags"])))

    def run():
        return torch.stack(fri.g_plain(*args, G_ROWS, inp["tags"]))

    return on_plain(run) if mode == "plain" else run()


def fold_inputs(rng, log_size: int) -> dict:
    """One FRI fold of a 2^log_size ext layer on the card, as fri_prove makes
    it: the layer (edge words first), the cached table of w^-i, the scale
    1 / (2 shift) of the layer's coset (7^(2^21 / size)) and a seeded beta."""
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl, ntt
    from eth_lc_plonky2_tpu_torch.prover import fri, prove

    size = 1 << log_size
    layer = rng.integers(0, gl.P, size=(2, size), dtype=np.uint64)
    layer[:, : min(size, 5)] = field_edge_words()[: min(size, 5)]
    shift = pow(gl.MULTIPLICATIVE_GENERATOR, (1 << (LOG_N + RATE_BITS)) // size, gl.P)
    w = gl.primitive_root_of_unity(log_size)
    beta = [int(v) for v in rng.integers(0, gl.P, size=2, dtype=np.uint64)]
    return {"re": gl.from_u64(layer[0], DEVICE), "im": gl.from_u64(layer[1], DEVICE),
            "w_inv": ntt._powers_on(gl.h_inv(w), size // 2, DEVICE),
            "scale": fri.INV2 * gl.h_inv(shift) % gl.P,
            "beta": (prove.scalar_f(beta[0], DEVICE), prove.scalar_f(beta[1], DEVICE))}


def fold_terms(inp, mode: str = "kernel"):
    """One fold as (2, h): ``mode`` "kernel" (kernels.fri_fold), "plain" or
    "eager" (fri.fold_plain on the plain ops or on field.cu)."""
    import torch

    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import fri

    args = (inp["re"], inp["im"], inp["w_inv"], inp["scale"])
    if mode == "kernel":
        return torch.stack(kernels.fri_fold(*args, fri.INV2, inp["beta"]))

    def run():
        return torch.stack(fri.fold_plain(*args, inp["beta"]))

    return on_plain(run) if mode == "plain" else run()


# 32 x 32 multiply-adds, in the cheapest form known (a 64 x 64 product is 4,
# its reduction one more, a multiply-accumulate into the column sums 4):
# the openings, per coefficient and point, two multiply-accumulates, and per
# column and point one ext product for z^c (four multiply-accumulates and two
# reductions); the permutation terms, per column and challenge, per chunk of
# 8 wires 8 + 8 products for the factors and 7 + 7 for the running products,
# 2 for the chain terms and 2 multiply-accumulates by alpha, and for term 0
# one product and 2 multiply-accumulates.
OPEN_MADS_PER_COEFF_POINT = 2 * 4
OPEN_MADS_PER_COLUMN_POINT = 4 * 4 + 2
PERM_MADS_PER_COLUMN = 2 * ((NUM_ROUTED // PERM_CHUNK) * ((2 * PERM_CHUNK + 2 * (PERM_CHUNK - 1) + 2) * 5
                                                          + 2 * 4) + 5 + 2 * 4)


def check_fused_field_kernels(torch, chk: Checker, rng, card: str) -> dict:
    """Both fused kernels of csrc/field.cu against their plain versions at the
    main path's shapes: phase 7's four opening batches at 2^18 coefficients
    (12 points) and the permutation terms at (80, 2^21) with 2 challenges and
    chunk 8, edge words included; then at 2^12 with edge points.  Each call
    must launch only its plan's launches (no field_binary_kernel); each is
    timed with CUDA events beside its bound, its plain version and the eager
    chain of field.cu ops it replaces."""
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl, kernels
    from eth_lc_plonky2_tpu_torch.prover import prove

    out = {}
    batches = opening_inputs(rng, LOG_N)
    plans = [kernels.field_open_plan(c.shape[0], c.shape[1], zr.shape[0]) for _, c, zr, _ in batches]
    before = kernels.launches["field"]
    got = open_all(batches)
    if kernels.launches["field"] - before != sum(p["launches"] for p in plans):
        fail(f"openings: {kernels.launches['field'] - before} field launches, the plans' are "
             f"{[p['launches'] for p in plans]}")
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(open_all(batches, plain=True)), 1)
    for (tag, *_), g, w in zip(batches, got, plain[-1]):
        chk.same("field", g[0], w[0], f"openings {tag}, real parts")
        chk.same("field", g[1], w[1], f"openings {tag}, imaginary parts")
    del plain, got
    ms = cuda_ms(lambda: open_all(batches), 9)
    before = kernels.launches["field"]
    # the plain version's field ops on CUDA tensors: one field_binary_kernel each
    chain_ms = cuda_ms(lambda: [prove._open_core_plain(c, zr, zi) for _, c, zr, zi in batches], 1)
    chain_launches = kernels.launches["field"] - before
    coeffs = sum(c.numel() for _, c, _, _ in batches)
    nbytes = coeffs * 8 + sum(2 * zr.numel() * c.shape[0] * 8 for _, c, zr, _ in batches)
    mads = sum(c.numel() * zr.numel() * OPEN_MADS_PER_COEFF_POINT
               + c.shape[1] * zr.numel() * OPEN_MADS_PER_COLUMN_POINT for _, c, zr, _ in batches)
    out["field_open_kernel"] = dict(ms=ms, plain_ms=plain_ms, chain_ms=chain_ms,
                                    chain_launches=chain_launches,
                                    launches=sum(p["launches"] for p in plans),
                                    **dict(zip(("bound_ms", "bound_by"), bound_of(nbytes, mads))))
    log(f"[7] openings, the four batches of phase 7 (92, 184, 20, 16 rows of 2^{LOG_N}; 12 points): "
        f"field_open_kernel {ms:.3f} ms in {out['field_open_kernel']['launches']} launches, its words "
        f"== the plain version's ({plain_ms:.3f} ms); the eager chain on field.cu it replaces "
        f"{chain_ms:.3f} ms in {chain_launches} launches; bound {out['field_open_kernel']['bound_ms']:.4f} "
        f"ms by {out['field_open_kernel']['bound_by']} ({nbytes} bytes, {mads} multiply-adds; "
        f"{out['field_open_kernel']['bound_ms'] / ms:.1%} of the kernel's time) [{card}]")
    for tag, c, zr, zi in batches:
        one = [(tag, c, zr, zi)]
        per = cuda_ms(lambda: open_all(one), 9)
        log(f"[7] openings {tag} ({c.shape[0]}, 2^{LOG_N}) at {zr.numel()} points: {per:.3f} ms, "
            f"plan {kernels.field_open_plan(c.shape[0], c.shape[1], zr.numel())} [{card}]")
    del batches
    # edge points at 2^12: zeta with words at the ends of the range
    for zeta in ((gl.P - 1, 1 << 63), (0, 1), (1 << 32, gl.P - 1)):
        small = opening_inputs(rng, 12, zeta)
        for (tag, *_), g, w in zip(small, open_all(small), open_all(small, plain=True)):
            chk.same("field", g[0], w[0], f"openings {tag} at 2^12, zeta {zeta}, real parts")
            chk.same("field", g[1], w[1], f"openings {tag} at 2^12, zeta {zeta}, imaginary parts")
    torch.cuda.synchronize()

    inputs = perm_inputs(rng, LOG_N + RATE_BITS)
    before = kernels.launches["field"]
    got = perm_terms(inputs)
    if kernels.launches["field"] - before != 1:
        fail(f"permutation terms: {kernels.launches['field'] - before} field launches, the plan is 1")
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(perm_terms(inputs, plain=True)), 1)
    chk.same("field", got, plain[-1], f"permutation terms at (80, 2^{LOG_N + RATE_BITS})")
    del plain
    ms = cuda_ms(lambda: perm_terms(inputs), 9)
    before = kernels.launches["field"]
    chain_ms = cuda_ms(lambda: prove.perm_quotient_terms_plain(*inputs), 1)
    chain_launches = kernels.launches["field"] - before
    n_lde = 1 << (LOG_N + RATE_BITS)
    rows_read = 2 * NUM_ROUTED + NUM_Z + 2  # wires, sigmas, Z rows, x, l0
    bound = bound_of((rows_read + 2) * n_lde * 8, PERM_MADS_PER_COLUMN * n_lde)
    out["perm_quotient_kernel"] = dict(ms=ms, plain_ms=plain_ms, chain_ms=chain_ms,
                                       chain_launches=chain_launches,
                                       **dict(zip(("bound_ms", "bound_by"), bound)))
    r = out["perm_quotient_kernel"]
    log(f"[7] permutation terms at (80, 2^{LOG_N + RATE_BITS}), 2 challenges, chunk 8: "
        f"perm_quotient_kernel {ms:.3f} ms in 1 launch, its words == the plain version's "
        f"({plain_ms:.3f} ms); the eager chain on field.cu it replaces {chain_ms:.3f} ms in "
        f"{chain_launches} launches; bound {r['bound_ms']:.4f} ms by {r['bound_by']} ({rows_read} "
        f"rows read, 2 written; {PERM_MADS_PER_COLUMN} multiply-adds a column; "
        f"{r['bound_ms'] / ms:.1%} of the kernel's time) [{card}]")
    del inputs, got
    for log_n_lde in (7, 12):  # every column's next row and the roll's wrap in a small domain
        small = perm_inputs(rng, log_n_lde)
        chk.same("field", perm_terms(small), perm_terms(small, plain=True),
                 f"permutation terms at (80, 2^{log_n_lde})")
    torch.cuda.synchronize()
    return out


# The generic share at phase 7's shapes, per column: 3 selectors, 6
# constant rows, the 80 wire columns the generic gates read (the public
# inputs' columns among them), 12 Lagrange rows and 2 accumulators read, 2
# written; 32 x 32 multiply-adds (a product 5, a multiply-accumulate 4): 20
# arith ops of 3 products and 2 multiply-accumulates, 64 bits of 1 product
# (the square) and 2 multiply-accumulates, 2 sum constraints and 6 constant
# constraints of 2 multiply-accumulates, 12 public inputs of 1 product and 2
# multiply-accumulates, 3 selectors of 2 products.
GENERIC_ROWS = 3 + 6 + NUM_ROUTED + 12 + 2 + 2
GENERIC_MADS_PER_COLUMN = (20 * (3 * 5 + 2 * 4) + 64 * (5 + 2 * 4) + (2 + 6) * 2 * 4
                           + 12 * (5 + 2 * 4) + 3 * 2 * 5)
# G per column: every row of the four batches times two weights (two
# multiply-accumulates), and per spec the norm's square, the three products of
# the batch trick, the two of the denominator, an ext product (four
# multiply-accumulates and two reductions) and the weight's four
# multiply-accumulates; one Fermat inversion of 72 products.
G_MADS_PER_SPEC = 5 + 3 * 5 + 2 * 5 + (4 * 4 + 2 * 5) + 4 * 4
G_MADS_FERMAT = 72 * 5
# A fold per output word: the point's product, two halves, two differences'
# products, an ext product by beta.
FOLD_MADS_PER_WORD = 5 + 2 * 5 + 2 * 5 + (4 * 4 + 2 * 5)


def timed_against_plain(torch, chk: Checker, source: str, run, what: str) -> tuple:
    """run("kernel") against run("plain") (timed once), the kernel timed over
    9 runs and the eager chain on field.cu run("eager") once with its field
    launches: (ms, plain_ms, chain_ms, chain_launches)."""
    from eth_lc_plonky2_tpu_torch.ops import kernels

    got = run("kernel")
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(run("plain")), 1)
    chk.same(source, got, plain[-1], what)
    del got, plain
    ms = cuda_ms(lambda: run("kernel"), 9)
    before = kernels.launches["field"]
    chain_ms = cuda_ms(lambda: run("eager"), 1)
    return ms, plain_ms, chain_ms, kernels.launches["field"] - before


def check_fused_quotient_fri_kernels(torch, chk: Checker, rng, card: str) -> dict:
    """generic_gate_quotient_kernel, fri_g_kernel and fri_fold_kernel against
    their plain versions: the generic share at n_lde 2^7, 2^12 and 2^21, G at
    2^12 and 2^21 with 5 and 12 specs (a zero norm among them), the fold at
    every layer size from 2^1 to 2^21; each launch is its source's one and no
    field_binary_kernel; at the main path's shapes each is timed beside its
    bound, its plain version and the eager chain it replaced."""
    from eth_lc_plonky2_tpu_torch.ops import kernels

    def launches_of(fn, want: dict, what: str):
        before = dict(kernels.launches)
        out = fn()
        delta = {k: kernels.launches[k] - before[k] for k in before}
        if {k: v for k, v in delta.items() if v} != want:
            fail(f"{what}: launches {delta}, the plan is {want}")
        return out

    out = {}
    n_lde = 1 << (LOG_N + RATE_BITS)
    for log_n_lde in (7, 12):
        inp = generic_inputs(rng, 1 << log_n_lde)
        got = launches_of(lambda: generic_terms(inp), {"gates": 1}, "generic gates")
        chk.same("gates", got, generic_terms(inp, "plain"), f"generic gates at n_lde 2^{log_n_lde}")
    inp = generic_inputs(rng, n_lde)
    launches_of(lambda: generic_terms(inp), {"gates": 1}, "generic gates at 2^21")
    ms, plain_ms, chain_ms, chain_launches = timed_against_plain(
        torch, chk, "gates", lambda mode: generic_terms(inp, mode),
        f"generic gates at (184, 2^{LOG_N + RATE_BITS})")
    scratch = [a.clone() for a in inp["accs"]]
    launch_ms = cuda_ms(lambda: kernels.generic_gate_quotient(
        inp["generic"], inp["wires"], inp["pre"], inp["num_sel"], inp["num_con"], inp["lr"],
        inp["pi"], inp["pi_cols"], inp["apows"], scratch, inp["pi0"], inp["k0"]), 9)
    del inp, scratch
    bound = bound_of(GENERIC_ROWS * n_lde * 8, GENERIC_MADS_PER_COLUMN * n_lde)
    out["generic_gate_quotient_kernel"] = dict(
        ms=launch_ms, with_copies_ms=ms, plain_ms=plain_ms, chain_ms=chain_ms,
        chain_launches=chain_launches, bound_ms=bound[0], bound_by=bound[1])
    log(f"[7] generic gates and 12 public inputs at (184, 2^{LOG_N + RATE_BITS}), 2 challenges: "
        f"generic_gate_quotient_kernel {launch_ms:.3f} ms in 1 launch ({ms:.3f} ms with the "
        f"accumulators' copies), its words == the plain version's ({plain_ms:.3f} ms); the eager "
        f"chain on field.cu it replaces {chain_ms:.3f} ms in {chain_launches} launches; bound "
        f"{bound[0]:.4f} ms by {bound[1]} ({GENERIC_ROWS} rows, {GENERIC_MADS_PER_COLUMN} "
        f"multiply-adds a column; {bound[0] / launch_ms:.1%} of the kernel's time) [{card}]")

    for num_specs in sorted(G_SPEC_TAGS):
        inp = g_inputs(rng, 12, num_specs)
        got = launches_of(lambda: g_terms(inp), {"field": 1}, "fri G")
        chk.same("field", got, g_terms(inp, "plain"), f"fri G at 2^12, {num_specs} specs")
    rows = sum(G_ROWS.values())
    for num_specs in sorted(G_SPEC_TAGS):
        inp = g_inputs(rng, LOG_N + RATE_BITS, num_specs)
        launches_of(lambda: g_terms(inp), {"field": 1}, "fri G at 2^21")
        ms, plain_ms, chain_ms, chain_launches = timed_against_plain(
            torch, chk, "field", lambda mode: g_terms(inp, mode),
            f"fri G at 2^{LOG_N + RATE_BITS}, {num_specs} specs")
        del inp
        bound = bound_of((rows + 1 + 2) * n_lde * 8,
                         (rows * 2 * 4 + num_specs * G_MADS_PER_SPEC + G_MADS_FERMAT) * n_lde)
        entry = dict(ms=ms, plain_ms=plain_ms, chain_ms=chain_ms, chain_launches=chain_launches,
                     bound_ms=bound[0], bound_by=bound[1])
        if num_specs == 12:
            out["fri_g_kernel"] = entry
        log(f"[7] fri G at 2^{LOG_N + RATE_BITS} over {rows} rows (92, 184, 20, 16), {num_specs} "
            f"specs: fri_g_kernel {ms:.3f} ms in 1 launch, its words == the plain version's "
            f"({plain_ms:.3f} ms); the eager chain on field.cu it replaces {chain_ms:.3f} ms in "
            f"{chain_launches} launches; bound {bound[0]:.4f} ms by {bound[1]} "
            f"({bound[0] / ms:.1%} of the kernel's time) [{card}]")

    for log_size in range(1, LOG_N + RATE_BITS + 1):
        inp = fold_inputs(rng, log_size)
        got = launches_of(lambda: fold_terms(inp), {"field": 1}, "fri fold")
        chk.same("field", got, fold_terms(inp, "plain"), f"fri fold of 2^{log_size}")
    ms, plain_ms, chain_ms, chain_launches = timed_against_plain(
        torch, chk, "field", lambda mode: fold_terms(inp, mode), "fri fold of 2^21")
    h = n_lde // 2
    bound = bound_of(7 * h * 8, FOLD_MADS_PER_WORD * h)
    out["fri_fold_kernel"] = dict(ms=ms, plain_ms=plain_ms, chain_ms=chain_ms,
                                  chain_launches=chain_launches, bound_ms=bound[0],
                                  bound_by=bound[1])
    log(f"[7] fri fold 2^{LOG_N + RATE_BITS} -> 2^{LOG_N + RATE_BITS - 1}: fri_fold_kernel "
        f"{ms:.4f} ms in 1 launch, its words == the "
        f"plain version's ({plain_ms:.3f} ms) at every size 2^1 to 2^{LOG_N + RATE_BITS}; the eager "
        f"chain on field.cu it replaces {chain_ms:.3f} ms in {chain_launches} launches; bound "
        f"{bound[0]:.4f} ms by {bound[1]} ({bound[0] / ms:.1%} of the kernel's time) [{card}]")
    torch.cuda.synchronize()
    return out


def perm_z_inputs(rng, log_n: int, zeros: tuple = ()) -> tuple:
    """The permutation rows' arguments at 2^log_n rows on the card, as prove
    passes them: the 80 routed rows of a (184, n) wires matrix (read through
    its row stride), 80 sigma rows, the subgroup's points, the k shifts, two
    betas and gammas, chunk 8; seeded words with the edge words in the first
    columns.  Each (challenge j, chunk k, column x) of ``zeros`` sets the
    wire x % 8 of chunk k at column x to -(beta_j sigma + gamma_j): chunk k's
    den is 0 there, so challenge j's Z is 0 from column x + 1 on."""
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl, host_field as hf

    n = 1 << log_n
    edge = field_edge_words()
    wires = rng.integers(0, gl.P, size=(NUM_WIRES, n), dtype=np.uint64)
    sigma = rng.integers(0, gl.P, size=(NUM_ROUTED, n), dtype=np.uint64)
    wires[:, : min(n, len(edge))] = edge[: min(n, len(edge))]
    sigma[::3, : min(n, len(edge))] = edge[::-1][: min(n, len(edge))]
    betas = rng.integers(0, gl.P, size=2, dtype=np.uint64)
    gammas = rng.integers(0, gl.P, size=2, dtype=np.uint64)
    for j, k, x in zeros:
        i = k * PERM_CHUNK + x % PERM_CHUNK
        wires[i, x] = (gl.P - (int(betas[j]) * int(sigma[i, x]) + int(gammas[j])) % gl.P) % gl.P
    dev = lambda a: gl.from_u64(a, DEVICE)  # noqa: E731
    return (dev(wires)[:NUM_ROUTED], dev(sigma), dev(hf.powers(gl.primitive_root_of_unity(log_n), n)),
            dev(hf.powers(gl.MULTIPLICATIVE_GENERATOR, NUM_ROUTED)), dev(betas), dev(gammas),
            PERM_CHUNK)


def perm_rows(inputs, mode: str = "kernel"):
    """The permutation rows of every challenge of ``inputs``: ``kernels.perm_z``,
    or the plain version stacked the same way (mode "plain": plain PyTorch
    ops on the card), or the eager chain of field.cu ops it replaced
    ("eager")."""
    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import prove

    if mode == "kernel":
        return kernels.perm_z(*inputs)
    if mode == "plain":
        return on_plain(lambda: prove.perm_rows_plain(*inputs))
    return prove.perm_rows_plain(*inputs)


# Z and the partials per column at (80, 2^18), two challenges, in the
# cheapest form known: per wire and challenge two multiply-adds (w + beta k_i
# omega + gamma, w + beta sigma + gamma) and two running products; per chunk
# and challenge the batch trick's four products (two in, two back) and one
# Fermat power (72) for all 20 chunks; per challenge m - 1 products for the
# running product over the chunks, m - 1 for the partials Z rat_pref[k] and
# one for the prefix product along the subgroup.
PERM_Z_CHUNKS = NUM_ROUTED // PERM_CHUNK
PERM_Z_PRODUCTS_PER_COLUMN = 2 * (NUM_ROUTED * 4 + PERM_Z_CHUNKS * 4 + 2 * (PERM_Z_CHUNKS - 1) + 1) + 72


def check_perm_z_kernel(torch, chk: Checker, rng, card: str) -> dict:
    """perm_z_kernel, its scan and its fix-up against the plain permutation
    rows and the eager chain of field.cu ops they replaced, both challenges at
    (80, 2^18) with zero den chunks near the end (challenge 0's chunk 3 at
    column n - 300, challenge 1's chunk 9 at n - 2), timed beside the bound,
    the plain version and the eager chain; then at 2^12 with zeros in the first
    block, one challenge, and at 2^4 (less than a block).  Each call launches
    the plan's 3 field kernels and nothing else."""
    from eth_lc_plonky2_tpu_torch.ops import kernels

    def launches_of(fn, what: str):
        before = dict(kernels.launches)
        out = fn()
        delta = {k: kernels.launches[k] - before[k] for k in before if kernels.launches[k] != before[k]}
        if delta != {"field": 3}:
            fail(f"{what}: launches {delta}, the plan is 3 of csrc/field.cu")
        return out

    n = 1 << LOG_N
    inputs = perm_z_inputs(rng, LOG_N, ((0, 3, n - 300), (1, 9, n - 2)))
    got = launches_of(lambda: perm_rows(inputs), f"permutation rows at (80, 2^{LOG_N})")
    chk.same("field", got, perm_rows(inputs, "eager"), f"permutation rows at (80, 2^{LOG_N}) against "
             f"the eager chain")
    zs = got.cpu().numpy().view(np.uint64)
    if zs[0, 0] != 1 or zs[0, -1] != 0 or zs[PERM_Z_CHUNKS, -1] != 0 or zs[PERM_Z_CHUNKS, n - 2] == 0:
        fail("permutation rows: the zero den chunks did not end the grand products where placed")
    del got, zs
    ms, plain_ms, chain_ms, chain_launches = timed_against_plain(
        torch, chk, "field", lambda mode: perm_rows(inputs, mode),
        f"permutation rows at (80, 2^{LOG_N}), 2 challenges")
    del inputs
    bound = bound_of((2 * NUM_ROUTED + 1 + NUM_Z) * n * 8, PERM_Z_PRODUCTS_PER_COLUMN * 5 * n)
    plan = kernels.perm_z_plan(NUM_ROUTED, n, PERM_CHUNK, 2)
    log(f"[7] permutation rows at (80, 2^{LOG_N}), 2 challenges, chunk 8, zero den chunks: "
        f"perm_z_kernel + scan + fix-up {ms:.4f} ms in 3 launches ({plan['blocks']} blocks of "
        f"{plan['threads']}, {plan['shared_bytes']} bytes of shared memory), its words == the plain "
        f"version's ({plain_ms:.3f} ms) and the eager chain's; the eager chain on field.cu it replaces "
        f"{chain_ms:.3f} ms in {chain_launches} launches; bound {bound[0]:.4f} ms by {bound[1]} "
        f"({2 * NUM_ROUTED + 1} rows read, {NUM_Z} written; {PERM_Z_PRODUCTS_PER_COLUMN} products a "
        f"column; {bound[0] / ms:.1%} of the kernels' time) [{card}]")
    small = perm_z_inputs(rng, 12, ((0, 0, 5), (1, 4, 300)))
    chk.same("field", launches_of(lambda: perm_rows(small), "permutation rows at 2^12"),
             perm_rows(small, "plain"), "permutation rows at (80, 2^12), zeros in the first block")
    one = small[:4] + (small[4][1:], small[5][1:], PERM_CHUNK)
    chk.same("field", launches_of(lambda: perm_rows(one), "one challenge's rows at 2^12"),
             perm_rows(one, "plain"), "permutation rows at (80, 2^12), one challenge")
    tiny = perm_z_inputs(rng, 4, ((0, 2, 3),))
    chk.same("field", launches_of(lambda: perm_rows(tiny), "permutation rows at 2^4"),
             perm_rows(tiny, "plain"), "permutation rows at (80, 2^4), less than a block")
    torch.cuda.synchronize()
    return {"perm_z_kernel": dict(ms=ms, plain_ms=plain_ms, chain_ms=chain_ms,
                                  chain_launches=chain_launches, bound_ms=bound[0],
                                  bound_by=bound[1])}


def measure_perm_polys(torch, rng, card: str) -> dict:
    """The permutation rows of both challenges at (80 of 184, 2^18), through
    ``prove.compute_permutation_polys`` a challenge and ``torch.cat``, as the
    prove of every checkout since the rows were ported called them (an entry
    both sides of a comparison have), timed with CUDA events; with the field
    launches of one call.  Where the package has ``prove.permutation_polys``,
    its one call for both challenges is timed too (``both_ms``)."""
    import types

    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import prove

    wires, sigma, omega, k_shifts, betas, gammas, chunk = perm_z_inputs(rng, LOG_N)
    cfg = types.SimpleNamespace(num_routed_wires=NUM_ROUTED, permutation_chunk_size=chunk)
    pd = types.SimpleNamespace(data=types.SimpleNamespace(config=cfg), dev={
        "sigma": sigma, "omega_pows": omega, "k_shifts": k_shifts})
    b, g = ([int(v) for v in t.cpu().numpy().view(np.uint64)] for t in (betas, gammas))

    def per_challenge():
        return torch.cat([prove.compute_permutation_polys(pd, wires, b[j], g[j]) for j in range(2)])

    before = kernels.launches["field"]
    want = per_challenge()
    launched = kernels.launches["field"] - before
    ms = cuda_ms(per_challenge, 9)
    res = {"perm_polys_ms": ms, "perm_polys_field_launches": launched, "both_ms": None}
    if hasattr(prove, "permutation_polys"):
        both = prove.permutation_polys(pd, wires, b, g)
        if not torch.equal(both, want):
            fail("permutation_polys of both challenges differs from one call a challenge")
        res["both_ms"] = cuda_ms(lambda: prove.permutation_polys(pd, wires, b, g), 9)
    log(f"[m] permutation rows (80, 2^{LOG_N}), 2 challenges: compute_permutation_polys a challenge "
        f"and a cat {ms:.4f} ms in {launched} field launches; both challenges in one call "
        f"{res['both_ms'] if res['both_ms'] is None else round(res['both_ms'], 4)} ms [{card}]")
    return res


def eager_chains():
    """A context in which the fused kernels' wrappers run the eager chains of
    field.cu ops that they replaced (a number for the record, not a path of
    prove): the openings, the permutation rows, the permutation terms, the
    generic gates with the public inputs (in place, as the kernel), G and the
    folds."""
    import torch

    from eth_lc_plonky2_tpu_torch.circuit.algebra import DeviceBaseAlgebra
    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import fri, prove

    def generic(gates, wires_lde, pre_lde, num_sel, num_constants, lr, pi_f, pi_cols, apows, accs,
                pi0, k0):
        new = prove.generic_quotient_terms_plain(
            gates, DeviceBaseAlgebra((wires_lde.shape[1],), wires_lde.device),
            lambda col, offset=0: wires_lde[col], lambda i: pre_lde[num_sel + i], pre_lde, lr, pi_f,
            pi_cols.tolist(), apows, accs, pi0, k0)
        for acc, value in zip(accs, new):
            acc.copy_(value)

    def g(ldes, apow, y, z, x, spec_batches):
        return fri.g_plain(ldes, apow, y, z, x, dict(zip(fri.TAGS, (t.shape[0] for t in ldes))),
                           tuple(fri.TAGS[i] for i in spec_batches))

    return mock.patch.multiple(
        kernels, field_open=prove._open_core_plain, perm_z=prove.perm_rows_plain,
        perm_quotient=lambda *args: torch.stack(prove.perm_quotient_terms_plain(*args)),
        generic_gate_quotient=generic, fri_g=g,
        fri_fold=lambda re, im, w_inv, scale, half, beta: fri.fold_plain(re, im, w_inv, scale, beta))


def fused_against_eager_chains(torch, pd, witness, proof, card: str) -> None:
    """Phase 7's prove with the fused kernels and with the eager chains they
    replaced, in turns (eager, fused, fused, eager) on one card: the phases'
    times, and the proofs must be equal."""
    import contextlib

    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import prove
    from eth_lc_plonky2_tpu_torch.prover.profiler import Profiler

    want = proof_dict(proof)
    for fused in (False, True, True, False):
        prof = Profiler(enabled=True)
        before, before_gates = kernels.launches["field"], kernels.launches["gates"]
        with contextlib.nullcontext() if fused else eager_chains():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = prove.prove(pd, witness, prof=prof)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        if (where := first_difference(proof_dict(got), want)):
            fail(f"[7] the proof on the {'fused kernels' if fused else 'eager chains'} differs at {where}")
        log(f"[7] prove with the {'fused kernels' if fused else 'eager chains on field.cu'}: "
            f"{wall:.2f} ms, perm_polys {prof.times['perm_polys'] * 1e3:.3f} ms, openings "
            f"{prof.times['openings'] * 1e3:.3f} ms, quotient "
            f"{prof.times['quotient'] * 1e3:.3f} ms, fri_g_kernel "
            f"{prof.times['fri_g_kernel'] * 1e3:.3f} ms, fri_folds "
            f"{prof.times['fri_folds'] * 1e3:.3f} ms, {kernels.launches['field'] - before} field "
            f"and {kernels.launches['gates'] - before_gates} gates launches; the proof is the "
            f"same [{card}]")


def forged_witness(data, witness, gate_name: str):
    """A copy of the witness with one wire of a ``gate_name`` row forged: a
    SHA-256 a-bit of a round row together with its word, so that the word-bit
    consistency still holds locally, or one Poseidon s-box output."""
    from eth_lc_plonky2_tpu_torch.circuit import gates_poseidon as gp, gates_sha256 as gsha
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl

    forged = data.new_witness()
    forged.values, forged.known = witness.values.copy(), witness.known.copy()
    nw = data.config.num_wires
    rows = np.flatnonzero(data.selectors[data.gate_names.index(gate_name)])
    if gate_name == "sha256":
        row = int(rows[gsha.PROLOGUE + 30])  # round 30 of the first compression
        sid_bit = int(data.rep[row * nw + gsha.A_BITS + 7])
        sid_word = int(data.rep[row * nw + gsha.COL_WA])
        bit = int(forged.values[sid_bit])
        forged.values[sid_bit] = 1 - bit
        forged.values[sid_word] = int(forged.values[sid_word]) + (128 if bit == 0 else -128)
    else:
        sid = int(data.rep[int(rows[len(rows) // 2]) * nw + gp.W_ADV + 3])
        forged.values[sid] = (int(forged.values[sid]) + 1) % gl.P
    return forged


def check_forged_rejected(data, vk, pd, witness, what: str) -> None:
    from eth_lc_plonky2_tpu_torch.prover import prove
    from eth_lc_plonky2_tpu_torch.prover.verify import VerificationError, verify

    for gate_name in ("sha256", "poseidon"):
        proof = prove.prove(pd, forged_witness(data, witness, gate_name))
        try:
            verify(data, vk, proof)
        except VerificationError as e:
            log(f"{what}: a proof from a witness with one forged {gate_name} wire is rejected: {e}")
        else:
            fail(f"{what}: the verifier accepts a proof from a forged {gate_name} witness")


def phase7(torch, chk: Checker, rng, card: str, seed: int) -> dict:
    from eth_lc_plonky2_tpu_torch.prover import prove, serialize

    sources = ("ntt", "poseidon", "field", "gates")
    check_gate_kernels(torch, chk, rng)

    # the same circuit family at 2^12 rows: kernels against plain versions, whole proofs
    small, small_w, leaves, first_state = light_client_circuit(4, 200, seed)
    if small.log_n != 12:
        fail(f"[7] the small circuit has 2^{small.log_n} rows")
    small_pd, small_vk = prove.preprocess(small)
    got = prove_kernels_and_plain(torch, small_pd, small_w, "[7] SHA-256 and Poseidon rows at 2^12 rows",
                                  sources)
    small_proof = serialize.proof_from_dict(got)
    check_proof(small, small_vk, small_proof, small_w, "[7] 2^12 rows")
    check_light_client_outputs(small_proof, leaves, first_state, 200, "[7] 2^12 rows")
    check_forged_rejected(small, small_vk, small_pd, small_w, "[7] 2^12 rows")
    del small_pd

    t0 = time.perf_counter()
    data, witness, leaves, first_state = light_client_circuit(MERKLE_HEIGHT, POSEIDON_CHAIN_ROWS, seed)
    cfg = data.config
    rows_of = {name: int(data.selectors[i].sum()) for i, name in enumerate(data.gate_names)}
    log(f"[7] circuit built and witness generated by the port's CircuitBuilder in "
        f"{time.perf_counter() - t0:.1f} s: {cfg.num_wires} wires, 2^{data.log_n} rows, "
        f"{data.num_rows_used} used, rows by gate {rows_of}, "
        f"{len(data.public_input_targets)} public inputs, "
        f"{len(prove.opening_point_specs(data))} opening points")
    if data.log_n != LOG_N or rows_of["sha256"] != 68 * 2 * ((1 << MERKLE_HEIGHT) - 1) \
            or rows_of["poseidon"] != POSEIDON_CHAIN_ROWS:
        fail(f"[7] the circuit is not the planned one: 2^{data.log_n} rows, {rows_of}")
    t0 = time.perf_counter()
    pd, vk = prove.preprocess(data)
    torch.cuda.synchronize()
    log(f"[7] preprocess ({pd.pre_values.shape[0]} polys) in {time.perf_counter() - t0:.3f} s")
    proof, launched = first_prove(torch, "[7]", pd, witness, card, sources)
    check_proof(data, vk, proof, witness, "[7] 2^18 rows")
    check_light_client_outputs(proof, leaves, first_state, POSEIDON_CHAIN_ROWS, "[7] 2^18 rows")
    res = profile_prove(torch, "[7]", pd, witness, proof, card, LC_STEADY_FIELD_LAUNCHES, 3)
    check_forged_rejected(data, vk, pd, witness, "[7] 2^18 rows")
    fused_against_eager_chains(torch, pd, witness, proof, card)
    del pd
    gates_res = measure_gate_kernels(torch, chk, rng, card)
    fused_res = check_fused_field_kernels(torch, chk, rng, card)
    fused_res.update(check_fused_quotient_fri_kernels(torch, chk, rng, card))
    fused_res.update(check_perm_z_kernel(torch, chk, rng, card))
    return {"launches": launched, "prove_ms": res["prove_ms"], "phase_ms": res["phase_ms"],
            "gates": gates_res, "fused": fused_res, "traced": res["by_name"]}


# the trace's kernel names that one entry of the kernels line stands for
TRACED_AS = {"field_open_kernel": ("field_open_kernel", "field_open_sum_kernel"),
             "perm_z_kernel": ("perm_z_kernel", "perm_z_scan_kernel", "perm_z_fixup_kernel")}


def summed(parts: dict) -> dict:
    """One source's kernels added up: times and bounds summed; bound by bytes
    only if every part is."""
    by = {p["bound_by"] for p in parts.values()}
    return {key: sum(p[key] for p in parts.values()) for key in ("ms", "plain_ms", "bound_ms")} | {
        "bound_by": by.pop() if len(by) == 1 else "operations"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    import eth_lc_plonky2_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    card = phase0(torch)
    rng = np.random.default_rng(args.seed)
    chk = Checker()

    def timed(k: int, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args)
        log(f"[{k}] phase {k} took {time.perf_counter() - t0:.1f} s")
        return out

    timed(1, phase1)
    timed(2, phase2, torch, chk, rng)
    timed(3, phase3, torch)
    res = timed(4, phase4, torch, chk, rng, card)
    timed(5, phase5, torch)
    whole = timed(6, phase6, torch, chk, rng, card, args.seed)
    lc = timed(7, phase7, torch, chk, rng, card, args.seed)
    # the launches are those of the newest main path, phase 7's first prove (it
    # runs every kernel source); phases 4 and 6 have held their own above
    launches = lc["launches"]
    sha_gate, poseidon_gate = lc["gates"]["sha256"], lc["gates"]["poseidon"]
    # field.cu: the elementwise kernels at their table shape ((8, 2^21) mul),
    # and the fused kernels at the main path's shapes; gates.cu: its three
    # kernels at (184, 2^21); each entry adds its kernels up
    binary = dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), whole["field"]))
    inverse = dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), whole["field_inv"]))
    fused = dict(lc["fused"])
    generic_gate = fused.pop("generic_gate_quotient_kernel")
    field_parts = {"field_binary_kernel": binary, "field_inv_kernel": inverse, **fused}
    gate_parts = {"sha_gate_quotient_kernel": sha_gate,
                  "poseidon_gate_quotient_kernel": poseidon_gate,
                  "generic_gate_quotient_kernel": generic_gate}
    # each kernel's launches are those of phase 7's traced steady prove (the
    # inverse's are 0 there: it runs in the first prove, for the circuit's
    # tables); the openings' entry times field_open_kernel with its
    # column-slice sums, the permutation rows' perm_z_kernel with its scan and
    # fix-up
    for name, part in {**field_parts, **gate_parts}.items():
        part["launches"] = sum(lc["traced"].get(k, {}).get("launches", 0)
                               for k in TRACED_AS.get(name, (name,)))
    kernels_line = {"kernels": [
        {"name": "ntt", "route": "cuda", "source": "eth_lc_plonky2_tpu_torch/csrc/ntt.cu",
         "replaces": "eth_lc_plonky2_tpu/ops/pallas/ntt_mxu.py:165",
         "launches": launches["ntt"], "max_abs_err": chk.err["ntt"],
         "ms": res["ntt"][0], "plain_ms": res["ntt"][1], "bound_ms": res["ntt"][2],
         "bound_by": res["ntt"][3], "library_ms": None},
        {"name": "poseidon", "route": "cuda",
         "source": "eth_lc_plonky2_tpu_torch/csrc/poseidon.cu",
         "replaces": "eth_lc_plonky2_tpu/ops/pallas/poseidon_pallas.py:114",
         "launches": launches["poseidon"], "max_abs_err": chk.err["poseidon"],
         "ms": res["poseidon"][0], "plain_ms": res["poseidon"][1],
         "bound_ms": res["poseidon"][2], "bound_by": res["poseidon"][3], "library_ms": None},
        {"name": "field", "route": "cuda", "source": "eth_lc_plonky2_tpu_torch/csrc/field.cu",
         "replaces": "eth_lc_plonky2_tpu/ops/goldilocks.py:143-301, "
                     "eth_lc_plonky2_tpu/prover/prove.py:551, :457-481 and :264-363, "
                     "eth_lc_plonky2_tpu/prover/fri.py:72 and :170 (XLA-fused, no Pallas kernel)",
         "launches": launches["field"], "max_abs_err": chk.err["field"],
         **summed(field_parts), "library_ms": None, "by_kernel": field_parts},
        # one source, three kernels, one launch each a proof: the times are the
        # three kernels' at (184, 2^21) added up, and "by_kernel" has each alone
        {"name": "gates", "route": "cuda", "source": "eth_lc_plonky2_tpu_torch/csrc/gates.cu",
         "replaces": "eth_lc_plonky2_tpu/circuit/gates_sha256.py:223, "
                     "eth_lc_plonky2_tpu/circuit/gates_poseidon.py:133 and "
                     "eth_lc_plonky2_tpu/prover/prove.py:484-520 (XLA-fused, no Pallas kernel)",
         "launches": launches["gates"], "max_abs_err": chk.err["gates"],
         **summed(gate_parts), "library_ms": None, "by_kernel": gate_parts},
    ]}
    log(f"[8] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
