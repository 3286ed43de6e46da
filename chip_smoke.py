#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's prover on one GPU, and check it.

    python3 chip_smoke.py [--seed N]

Phases (any mismatch or exception exits non-zero without the ok line):
  0. device facts: card name and power limit, torch, nvcc, GPU count;
  1. build the five kernel sources of eth_lc_plonky2_tpu_torch/csrc with
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
     with zeros at every place of a run; the device SHA-256 (csrc/sha256.cu,
     no prove uses it): compress and two_to_one at N in {1, 31, 32, 33, 255,
     257, 2^20} on seeded and edge words (0, 0xFFFFFFFF, 0x80000000), one
     launch a call, and the flagship's sync committee root (512 seeded keys:
     1,024 half-key chunks hashed level by level, 10 launches, then the
     aggregate key's root and the container hash) against
     eth/ssz.sync_committee_root's hashlib root; both kernels timed at 2^20
     messages (the order of a level of an SSZ list tree over the beacon
     chain's validator registry) beside their bound and plain versions;
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
     and peak memory), a warm-up, one timed prove, the phases' times, a
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
     inputs; csrc/field.cu's fused kernels, three for the openings of all
     batches (the power table, the product, the slices' sum), three
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
     chunks (then at 2^12 with one and two challenges, at 2^4, and at 256
     routed wires in chunks of 4, blocks of 32), each timed beside its bound,
     its plain version and the eager chain it replaced; last, the four quotient kernels'
     window form on rank 0's half of a 2^21 domain (halo 128) timed beside
     their one-device form (their words are phase 10's to check);
  8. the flagship itself through the CLI's entry point: cli.run at
     --synthetic 512 --bls dummy --seed N, nothing cut (committee 512, 184
     wires, 16 PoW bits, 28 queries).  It proves the dummy BLS circuit on the
     card (142 wires, 2^12 rows, 8 PoW bits, 12 queries; that proof is also
     made on the plain versions on the card and through the circuit cache,
     and must be equal), builds the light-client circuit with the inner proof
     verified in-circuit (166,704 of 2^18 rows, as the JAX package's),
     generates its witness, preprocesses, proves, exports the portable bundle
     and verifies, the public inputs against the host SSZ contract_state_root
     of the pair; the bundle's config and circuit sections must equal
     lc512_bls_bundle.json's (its vk is compared and the outcome logged),
     tools/verify_standalone.py must accept it and reject a tampered copy;
     then a warm-up, three timed proves whose median is full512_prove_wall_s
     (the last without a profiler of its own, under ELP_PROFILE=1 and
     ELP_PHASE_LOG=1: its ELP_PROFILE record, captured and logged on a line
     of its own, must have the JAX package's keys, the witness_upload phase
     and the sync wait, be the profiler's last_profile, and its proof and
     launches must be the other timed proves'),
     a traced prove as in phase 6, and two forged witnesses rejected; last,
     prove_stream over three more synthetic pairs (seeds 1 to 3, their inner
     dummy proofs made on the card first; the worker thread makes the outer
     witnesses only): each streamed proof must equal a sequential prove of its
     witness byte for byte and pass verify, and the stream's wall is logged
     beside the sequential sum of witness and prove;
  9. the in-circuit BLS12-381 aggregate through the CLI's entry point: cli.run
     at --synthetic 512 --bls aggregate:slices=8 --seed N with keys on the
     curve, nothing cut (inner: 184 wires, 8 PoW bits, 12 queries, 64 members
     a slice; outer: 184 wires, 16 PoW bits, 28 queries).  The aggregate inner
     circuit is built once (221,832 of 2^18 rows, the JAX package's rows and
     gate counts, or it fails), preprocessed once and proved for each of the 8
     slices on the card; the outer circuit verifies all 8 in-circuit; witness,
     preprocess, prove, export, verify, the public inputs against the host SSZ
     roots, tools/verify_standalone.py on the bundle and a tampered copy.  Then
     one slice again: its constrained aggregate must be host_aggregate of its
     64 keys and bits, its proof the CLI's byte for byte and accepted by
     verify, and a steady inner prove launches its own plan (no SHA-256 gate:
     two gate kernels); slices 0 and 1 swapped in the outer witness must be
     refused; one timed and traced steady outer prove held to the plan; the
     2-member aggregate circuit (8,946 of 2^14 rows) on the kernels against
     the plain versions on the card;
 10. the NTT past 2^22 and the sharded prover on the card.  (a) ntt and intt
     of (2, 2^23) and (2, 2^24) and coset_lde of (16, 2^21) to 2^24 (three
     passes) against the plain versions on the card, with each pass kind's
     time beside its bound and that LDE's peak memory; (b) one rank over NCCL
     in this process: make_dist_ntt (both ways) and make_dist_coset_lde against
     ntt and coset_lde at log n 10, 16 and 21, make_sharded_commit against
     commit_field_values at (184, 2^18) (LDE, every level's block, cap), and
     prove_sharded of the dryrun circuit against assets/dryrun/ref_proof.json;
     (c) two spawned ranks sharing the card over gloo: (b)'s checks, the window
     form of the four quotient kernels on each rank's window against the plain
     versions on the window (gates at phase 7's sizes, the permutation terms
     and the generic share at (184, 2^21)), and prove_sharded of the flagship
     (phase 8's circuit from its cache, the witness of --synthetic 512 --seed
     N made by each rank): both ranks' proofs must equal phase 8's byte for
     byte and pass verify, and each rank's first sharded prove (its counts set
     to 0 just before) must launch every kernel source.  The sharded prove's
     times are printed on a line of their own, labelled as two ranks sharing
     one card (no multi-GPU figure).
The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel with its launches on the main path, its error against the plain
version, and its time beside the plain version's and beside the least time
the card could take (bound_ms: the larger of bytes over 3.35 TB/s and 32-bit
integer multiply-adds, counted in the cheapest form known, over 16.75 T/s;
for sha256 its shifts and logic, ``sha256_pipe_ops``).  The sha256 entry's
launches are 0 (no prove hashes with SHA-256 on the card) and its
phase2_launches those of phase 2's checks.
A kernel's time is its device time (``device_ms``: the durations of its
kernels in a torch.profiler trace of 10 calls of its wrapper after a timed
warm-up inside the trace, no fallback); the plain version's and the eager chain's are CUDA events
around one call.
The launches are phase 9's cli.run (the eight inner proofs, both
preprocesses and the first outer proof), by_kernel's phase 9's traced steady
outer prove; the gates entry adds up its three kernels (one launch each a
proof) and the field entry its elementwise
product, its batched inverse and its five fused passes, and each lists them
under by_kernel.  No
PyTorch call computes any of these functions, so library_ms is null.

It needs a CUDA device, and no JAX: the port imports neither jax nor the JAX
package.
"""

from __future__ import annotations

import argparse
import importlib.metadata
import importlib.util
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
# three for the openings of all batches (the power table, field_open_kernel
# and its sum over the slices), one for the permutation terms, one for FRI's G
# and one a FRI fold.  A
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
# And when the openings became one call for all batches: less 4 + 4, plus
# 3 (27 - 8 + 3).  What is left: the quotient's product by 1 / Z_H, the
# permutation rows (3), the openings (3), the permutation terms, G and the 13
# folds.
STEADY_FIELD_LAUNCHES = 22

# The card's peaks (NVIDIA H100 SXM data sheet): 3.35 TB/s of device memory,
# and 67 TFLOP/s of float32 = 33.5 T multiply-adds/s on 128 lanes an SM, of
# which 64 do 32-bit integer multiply-adds: 16.75 T/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_MADS_PER_S = 67e12 / 2 / 2
# The int8 tensor cores, dense: 1,979 T operations/s (a multiply-add is two).
PEAK_INT8_OPS_PER_S = 1979e12
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


def words_np(t) -> np.ndarray:
    """A field tensor's u64 values, or a word tensor's (torch.uint32 or
    torch.int32) u32 values, on the host."""
    import torch

    if t.element_size() == 4:
        return t.detach().view(torch.int32).cpu().numpy().view(np.uint32)
    return t.detach().cpu().numpy().view(np.uint64)


def u64_err(a, b) -> float:
    """Largest |a - b| over the u64 values of two field tensors, or the u32
    values of two word tensors (0 when equal)."""
    x, y = words_np(a), words_np(b)
    if x.shape != y.shape:
        fail(f"shape mismatch {x.shape} vs {y.shape}")
    if x.size == 0:
        return 0.0
    return float(np.where(x > y, x - y, y - x).max())


class Checker:
    """Collects each kernel's largest error against its plain version."""

    def __init__(self):
        self.err = {"ntt": 0.0, "poseidon": 0.0, "field": 0.0, "gates": 0.0, "sha256": 0.0}

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


# calls of a wrapper in one traced window of device_ms, and the seconds of
# calls before them in the trace (doubled at each retake)
DEVICE_REPS = 10
DEVICE_WARMUP_S = 0.25


def device_ms(torch, fn, names: tuple, source: str, reps: int = DEVICE_REPS) -> tuple:
    """The device time of one fn() call: a warm-up call (its launches of the
    kernel source ``source`` counted), then a torch.profiler trace (CPU and
    CUDA activity) that first runs fn() for a while, then ``reps`` calls; the
    device durations of the last ``reps`` calls' kernels named ``names`` (in
    the trace's order) summed and divided by ``reps``.  On the card a trace
    started late in a long process records no kernel for a while (some of
    the first calls' records, or all of a short trace's, go missing), so the
    trace runs fn() for DEVICE_WARMUP_S seconds before the counted calls, and
    it counts only if it holds at least the last ``reps`` calls' records,
    each of a positive duration (the count is checked, not the durations:
    the spread of the kept calls' times is logged); it is taken again with
    twice the warm-up, at most six times, and then the run fails: there is
    no fallback to the events' time.  Also, as a cross-check, CUDA events
    around ``reps`` calls back to back, divided by ``reps``: it agrees with
    the trace only where the kernels outlast the wrapper's host time.
    Returns (device ms, events ms)."""
    from torch.profiler import ProfilerActivity, profile

    from eth_lc_plonky2_tpu_torch.ops import kernels

    before = kernels.launches[source]
    fn()
    torch.cuda.synchronize()
    per_call = kernels.launches[source] - before
    want = reps * per_call
    warm_s = DEVICE_WARMUP_S
    for attempt in range(6):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < warm_s:
                fn()
                torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = sorted((ev for ev in prof.events() if ev.device_type.name != "CPU"
                       and (own := re.search(r"\w+_kernel\b", ev.name)) and own.group(0) in names),
                      key=lambda ev: ev.time_range.start)
        kept = [ev.time_range.elapsed_us() for ev in seen[-want:]] if want else []
        if want and len(seen) >= want and min(kept) > 0:
            break
        log(f"device_ms: trace {attempt + 1} of {names} after {warm_s} s of warm-up holds "
            f"{len(seen)} records, the last {reps} calls launched {want}; taken again")
        warm_s *= 2
    else:
        fail(f"six traces in a row lost device records of {names}")
    total = sum(kept) / 1e3
    calls = [sum(kept[c * per_call:(c + 1) * per_call]) / 1e3 for c in range(reps)]
    log(f"device_ms: {'+'.join(names)}: {total / reps:.4f} ms a call, the {reps} calls "
        f"{min(calls):.4f} to {max(calls):.4f} ms")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return total / reps, start.elapsed_time(end) / reps


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
    try:
        pickler = importlib.metadata.version("cloudpickle")
    except importlib.metadata.PackageNotFoundError:
        pickler = "absent"
    log(f"[0] cloudpickle: {pickler} (prover/serialize.py's circuit cache needs it)")
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


def phase2(torch, chk: Checker, rng, card: str) -> dict:
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
    return check_sha256_kernels(torch, chk, rng, card)


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
    kernel beside its plain version at one main-path shape (the kernel's
    device time, ``device_ms``; the plain version's by CUDA events), and
    the device time of one proof's commitments by kernel name (torch.profiler).

    It calls only what the package has had since its first version, so
    tools/torch_kernel_times.py can run it on an older checkout too.
    """
    from torch.profiler import ProfilerActivity, profile, schedule

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
    out["ntt_ms"], out["ntt_events_ms"] = device_ms(
        torch, lambda: ntt.coset_lde(coeffs, RATE_BITS, out=lde_out), ("ntt_pass_kernel",), "ntt")
    out["ntt_plain_ms"] = cuda_ms(lambda: ntt.coset_lde_plain(coeffs, RATE_BITS, 7), 3)
    chk.same("ntt", lde_out, ntt.coset_lde_plain(coeffs, RATE_BITS, 7), "timed coset_lde chunk")
    scratch = torch.empty_like(coeffs)
    out["intt_ms"] = cuda_ms(lambda: ntt.intt(coeffs, out=scratch), 5)
    log(f"[4] ntt: coset_lde ({chunk}, 2^{LOG_N}) -> 2^{LOG_N + RATE_BITS}: kernel "
        f"{out['ntt_ms']:.4f} ms of device time ({out['ntt_events_ms']:.4f} ms a call by events, "
        f"{DEVICE_REPS} back to back), plain {out['ntt_plain_ms']:.3f} ms; intt ({chunk}, "
        f"2^{LOG_N}): kernel {out['intt_ms']:.3f} ms [{card}]")
    del lde_out, scratch
    level = gl.from_u64(rng.integers(0, gl.P, size=(n << 1, 4), dtype=np.uint64), dev)
    out["level_ms"], out["level_events_ms"] = device_ms(
        torch, lambda: pos.compress_level(level), ("merkle_level_kernel",), "poseidon")
    out["level_plain_ms"] = cuda_ms(lambda: pos._hash_plain(level.reshape(-1, 8)), 3)
    chk.same("poseidon", pos.compress_level(level), pos._hash_plain(level.reshape(-1, 8)),
             "timed level compression")
    log(f"[4] poseidon: Merkle level ({2 * n}, 4) -> ({n}, 4): kernel {out['level_ms']:.4f} ms "
        f"of device time ({out['level_events_ms']:.4f} ms a call by events), plain "
        f"{out['level_plain_ms']:.3f} ms [{card}]")
    wires_lde = torch.empty((NUM_WIRES, n_lde), dtype=torch.int64, device=dev)
    out["leaves_ms"] = cuda_ms(lambda: pos.hash_no_pad(wires_lde.T), 3)
    log(f"[4] poseidon: wires leaves ({NUM_WIRES}, 2^{LOG_N + RATE_BITS}): kernel "
        f"{out['leaves_ms']:.3f} ms [{card}]")
    del wires_lde, level

    # Device time per proof by kernel name, and the idle share of the window.
    # Each trace first traces and discards one proof's commitments (it pays for
    # the tracer's start-up), then keeps the next.  A trace can still lose
    # device records (ROADMAP C3: one NTT pass of 58 went missing on the card):
    # a trace whose launches by kernel source are not the wrappers' counts is
    # taken again, at most six times, and then the run fails.
    from eth_lc_plonky2_tpu_torch.ops import kernels

    for attempt in range(6):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                torch.cuda.synchronize()
                before = dict(kernels.launches)
                t0 = time.perf_counter()
                commit_all(inputs)
                torch.cuda.synchronize()
                window_ms = (time.perf_counter() - t0) * 1e3
                prof.step()
        launched = {src: n - before[src] for src, n in kernels.launches.items() if n > before[src]}
        by_name = {}
        for ev in prof.key_averages():
            if (ev.device_type.name != "CPU" and ev.self_device_time_total > 0
                    and not ev.key.startswith("ProfilerStep")):  # the step's own span is no work
                own = re.search(r"\w+_kernel\b", ev.key)  # this repo's kernels, without their namespace
                entry = by_name.setdefault(own.group(0) if own else ev.key[:48],
                                           {"ms": 0.0, "launches": 0})
                entry["ms"] += ev.self_device_time_total / 1e3
                entry["launches"] += ev.count
        seen = dict.fromkeys(launched, 0)
        for name, v in by_name.items():
            if BY_SOURCE.get(name) in seen:
                seen[BY_SOURCE[name]] += v["launches"]
        if seen == launched:
            break
        log(f"[4] trace {attempt + 1} shows launches {seen}, the wrappers counted {launched}; "
            f"taken again")
    else:
        fail(f"six traces in a row lost records: {seen} against {launched}")
    busy_ms = sum(v["ms"] for v in by_name.values())
    for name, v in sorted(by_name.items(), key=lambda kv: -kv[1]["ms"]):
        log(f"[4] profile, one proof's commitments: {name}: {v['ms']:.3f} ms in "
            f"{v['launches']} launches [{card}]")
    log(f"[4] profile: busy {busy_ms:.3f} ms of a {window_ms:.3f} ms window, idle share "
        f"{1 - busy_ms / window_ms:.3f}, one trace's reading, {attempt} incomplete traces "
        f"discarded before it [{card}]")
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
    check_sources_launched(launched, "the commitments", ("ntt", "poseidon"))

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


# csrc/sha256.cu's shapes: around a warp and a block of 256 threads, and 2^20
# messages, the order of a level of an SSZ list tree over the beacon chain's
# validator registry (about 2^20 entries); the last is the one timed
SHA256_NS = (1, 31, 32, 33, 255, 257, 1 << 20)
SHA256_COMMITTEE = 512  # the flagship's sync committee: 1,024 chunks, a tree of height 10
# The least integer work, in the cheapest form: a round is Σ1 and Σ0 at 3
# funnel shifts and one LOP3 each, Ch and Maj at one LOP3 each, and 4 adds; a
# schedule word σ0 and σ1 at 3 shifts and one LOP3 each, and 2 adds; a
# compression ends with 8 feed-forward adds; the two-to-one's second block
# (the padding) has a constant schedule.  Shifts and logic run on the integer
# pipe alone, 64 lanes a clock an SM (PEAK_INT32_MADS_PER_S), while an add may
# run on the FMA pipe as an IMAD beside them (the compiler puts a third to 40%
# of them there), and an SM dispatches 128 lanes a clock in all: the bound counts
# the shifts and logic, or half of every instruction, whichever is more.
SHA256_ROUND_LOGIC, SHA256_ROUND_ADDS = 2 * (3 + 1) + 2, 4
SHA256_SCHEDULE_LOGIC, SHA256_SCHEDULE_ADDS = 2 * (3 + 1), 2
SHA256_COMPRESS = (64 * SHA256_ROUND_LOGIC + 48 * SHA256_SCHEDULE_LOGIC,
                   64 * SHA256_ROUND_ADDS + 48 * SHA256_SCHEDULE_ADDS + 8)
SHA256_TWO_TO_ONE = (2 * 64 * SHA256_ROUND_LOGIC + 48 * SHA256_SCHEDULE_LOGIC,
                     2 * (64 * SHA256_ROUND_ADDS + 8) + 48 * SHA256_SCHEDULE_ADDS)


def sha256_pipe_ops(logic_and_adds: tuple) -> float:
    """A message's instructions at the integer pipe's rate: its shifts and
    logic, or half of all its instructions (the dispatch rate), whichever is more."""
    logic, adds = logic_and_adds
    return max(logic, (logic + adds) / 2)


def sha256_words(rng, shape: tuple, device: str):
    """Seeded u32 words (torch.uint32 on ``device``) whose first rows are all
    0, all 0xFFFFFFFF, all 0x80000000, then those three words in turn."""
    import torch

    x = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, 0xFFFFFFFF, 0x80000000], dtype=np.uint32)
    rows = x.reshape(-1, shape[-1])
    for r in range(min(4, rows.shape[0])):
        rows[r] = edge[r] if r < 3 else np.resize(edge, shape[-1])
    return torch.from_numpy(x.view(np.int32)).to(device).view(torch.uint32)


def sha256_committee_root(pubkeys: list, aggregate: bytes, device: str) -> bytes:
    """eth/ssz.sync_committee_root recomputed with ops/sha256.two_to_one on
    ``device``: the 2 * len(pubkeys) half-key chunks hashed level by level (a
    call a level), then the aggregate key's root and the container hash."""
    import torch

    from eth_lc_plonky2_tpu_torch.eth import ssz
    from eth_lc_plonky2_tpu_torch.ops import sha256 as sha

    def words(chunks):  # 32-byte chunks -> (n, 8) big-endian words, int32 read as u32
        arr = np.frombuffer(b"".join(chunks), dtype=">u4").astype(np.uint32).reshape(-1, 8)
        return torch.from_numpy(arr.view(np.int32)).to(device)

    level = words([half for pk in pubkeys for half in ssz.pubkey_leaves(pk)])
    while level.shape[0] > 1:
        level = sha.two_to_one(level[0::2].contiguous(), level[1::2].contiguous()).view(torch.int32)
    agg = words(ssz.pubkey_leaves(aggregate))
    agg_root = sha.two_to_one(agg[:1], agg[1:]).view(torch.int32)
    return sha.bytes_from_words(words_np(sha.two_to_one(level, agg_root))[0])


def check_sha256_kernels(torch, chk: Checker, rng, card: str) -> dict:
    """csrc/sha256.cu's two kernels against their plain versions on the card,
    bit for bit, at SHA256_NS (edge words in the first rows), one launch a
    call; the flagship's sync committee root (SHA256_COMMITTEE seeded keys) by
    two_to_one against eth/ssz.sync_committee_root (hashlib); both kernels
    timed at 2^20 beside their bound and their plain versions.  Returns
    {"by_kernel": {kernel: {ms, plain_ms, bound_ms, bound_by, events_ms}},
    "launches": the checks' launches}."""
    from eth_lc_plonky2_tpu_torch.eth import ssz
    from eth_lc_plonky2_tpu_torch.ops import kernels, sha256 as sha

    before = kernels.launches["sha256"]
    for n in SHA256_NS:
        state, block = sha256_words(rng, (n, 8), DEVICE), sha256_words(rng, (n, 16), DEVICE)
        left, right = sha256_words(rng, (n, 8), DEVICE), sha256_words(rng, (n, 8), DEVICE)
        runs = {"sha256_compress_kernel": (lambda: sha.compress(state, block),
                                           lambda: sha.compress_plain(state, block)),
                "sha256_two_to_one_kernel": (lambda: sha.two_to_one(left, right),
                                             lambda: sha.two_to_one_plain(left, right))}
        for name, (run, plain) in runs.items():
            count = kernels.launches["sha256"]
            got = run()
            if kernels.launches["sha256"] - count != 1:
                fail(f"{name} at N={n}: {kernels.launches['sha256'] - count} launches, not 1")
            chk.same("sha256", got, plain(), f"{name} at N={n}")
        torch.cuda.synchronize()
    log(f"[2] sha256 compress and two_to_one == plain at N {SHA256_NS} (edge words in the first "
        f"rows), one launch a call")
    keys = [rng.bytes(48) for _ in range(SHA256_COMMITTEE)]
    aggregate = rng.bytes(48)
    count = kernels.launches["sha256"]
    root = sha256_committee_root(keys, aggregate, DEVICE)
    levels = (2 * SHA256_COMMITTEE).bit_length() - 1
    if kernels.launches["sha256"] - count != levels + 2:
        fail(f"the committee root took {kernels.launches['sha256'] - count} launches, not "
             f"{levels} levels + 2")
    if root != ssz.sync_committee_root(keys, aggregate):
        fail("the sync committee root by sha256_two_to_one_kernel differs from eth/ssz's")
    launched = kernels.launches["sha256"] - before
    log(f"[2] sync committee root of {SHA256_COMMITTEE} seeded keys by two_to_one on the card "
        f"({levels} levels, the aggregate key's root, the container: {levels + 2} launches) == "
        f"eth/ssz.sync_committee_root {root.hex()[:16]}...")
    n = SHA256_NS[-1]
    parts = {}
    for name, nbytes, ops in (("sha256_compress_kernel", n * (32 + 64 + 32),
                               n * sha256_pipe_ops(SHA256_COMPRESS)),
                              ("sha256_two_to_one_kernel", n * (64 + 32),
                               n * sha256_pipe_ops(SHA256_TWO_TO_ONE))):
        run, plain = runs[name]
        ms, events_ms = device_ms(torch, run, (name,), "sha256")
        plain_ms = cuda_ms(plain, 1)
        bound, by = bound_of(nbytes, ops)
        parts[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                       "events_ms": events_ms}
        log(f"[2] {name} at 2^{n.bit_length() - 1}: {ms:.4f} ms of device time ({events_ms:.4f} "
            f"ms a call by events), bound {bound:.4f} ms by {by} ({100 * bound / ms:.1f}%), plain "
            f"{plain_ms:.3f} ms [{card}]")
    return {"by_kernel": parts, "launches": launched}


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
             "field_open_table_kernel": "field", "field_open_kernel": "field",
             "field_open_sum_kernel": "field",
             "perm_quotient_kernel": "field", "fri_g_kernel": "field", "fri_fold_kernel": "field",
             "perm_z_kernel": "field", "perm_z_scan_kernel": "field", "perm_z_fixup_kernel": "field",
             "sha_gate_quotient_kernel": "gates", "poseidon_gate_quotient_kernel": "gates",
             "generic_gate_quotient_kernel": "gates",
             "sha256_compress_kernel": "sha256", "sha256_two_to_one_kernel": "sha256"}


def launch_plan(data, pow_witness: int, field: int, gates: int) -> dict:
    """The launches of one steady prove at this script's widths (184 wires, 20 Z
    and 16 quotient polynomials): three commitments, the quotients' inverse
    transform (a four-step at 2^21) and the final polynomial's (one pass);
    three trees, a tree a FRI layer, a grind batch up to the witness; the
    circuit's eager field ops and its gates' own kernels; no SHA-256 kernel."""
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
    return {"ntt": plan_ntt, "poseidon": plan_sponge, "field": field, "gates": gates, "sha256": 0}


SYNC_WAIT = "_sync_wait"  # the profiler's waits at the phase marks: a share of the phases, not one
# the prover's spans: like SYNC_WAIT, every "_" key of the record is a share of the phases
SPAN_COUNTS = {"transcript", "transcript_permutations", "device_read"}
SPAN_TIMES = {"_transcript", "_device_read"}


def profile_prove(torch, tag: str, pd, witness, first_proof, card: str, field_plan: int,
                  gates_plan: int, timed: int = 3, switch: bool = False) -> dict:
    """A warm-up, ``timed`` proves with the phase marks, a steady prove whose
    launches must be the plan's, and a scheduled trace split by kernel name
    whose launches must be the wrappers' counts.  With ``switch`` the last
    timed prove takes its profiler from ELP_PROFILE instead
    (``switched_prove``), and its record must agree with the others'."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import prove
    from eth_lc_plonky2_tpu_torch.prover.profiler import Profiler

    prove.prove(pd, witness)  # warm-up: every table is cached now
    runs, phases, proofs, counted = [], [], [], []
    for k in range(timed):
        before = dict(kernels.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if switch and k == timed - 1:
            proof, record = switched_prove(pd, witness, tag)
            times = record["phases"]
        else:
            prof = Profiler(enabled=True)
            proof = prove.prove(pd, witness, prof=prof)
            times = prof.times
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        proofs.append(proof)
        phases.append(times)
        counted.append({key: v - before[key] for key, v in kernels.launches.items()})
    prove_ms = statistics.median(runs) * 1e3
    log(f"{tag} prove: median {prove_ms:.2f} ms of {len(runs)} "
        f"({', '.join(f'{r * 1e3:.2f}' for r in runs)}), each phase ending in a synchronize "
        f"[{card}]")
    want = proof_dict(first_proof)
    for p in proofs:
        if (where := first_difference(proof_dict(p), want)):
            fail(f"two proofs of one witness differ at {where}")
    if any(c != counted[0] for c in counted):
        fail(f"{tag} the timed proves launched {counted}: not the same")
    if switch:
        log(f"{tag} the prove under ELP_PROFILE=1 ELP_PHASE_LOG=1: its proof and its launches "
            f"{counted[-1]} are the other timed proves' [{card}]")
    phase_ms = {name: statistics.median(ph[name] for ph in phases) * 1e3
                for name in phases[0] if not name.startswith("_")}
    for name, ms in sorted(phase_ms.items(), key=lambda kv: -kv[1]):
        log(f"{tag} phase {name}: {ms:.3f} ms (median of {len(phases)}) [{card}]")
    for name in sorted(k for k in phases[0] if k.startswith("_")):
        ms = statistics.median(ph[name] for ph in phases) * 1e3
        log(f"{tag} share {name}: {ms:.3f} ms (median of {len(phases)}), a share of the phases "
            f"above, not a phase [{card}]")

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


PHASE_LOG = re.compile(r"\[prove \+ *\d+\.\ds\] phase (\w+)")


def switched_prove(pd, witness, tag: str) -> tuple:
    """One prove without a ``prof``, under ELP_PROFILE=1 and ELP_PHASE_LOG=1
    (the environment is restored after it): its stdout and stderr are
    captured, so that its ELP_PROFILE line is never this script's last.  The
    record must have the JAX package's keys, the port's witness_upload phase,
    the sync wait and the prover's spans, exactly the spans' counts, phases
    (every key but the "_" shares) that add up to at most its total (up to its
    rounding), the phase log's lines for every phase, and be the profiler's
    ``last_profile``.  Returns (the proof, the record)."""
    import contextlib
    import io

    from eth_lc_plonky2_tpu_torch.prover import profiler, prove

    saved = {k: os.environ.get(k) for k in ("ELP_PROFILE", "ELP_PHASE_LOG")}
    out, err = io.StringIO(), io.StringIO()
    try:
        os.environ.update({"ELP_PROFILE": "1", "ELP_PHASE_LOG": "1"})
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            proof = prove.prove(pd, witness)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    lines = [line for line in out.getvalue().splitlines() if line.startswith("ELP_PROFILE ")]
    if len(lines) != 1:
        fail(f"{tag} a prove under ELP_PROFILE=1 printed {len(lines)} ELP_PROFILE lines, not one")
    record = json.loads(lines[0][len("ELP_PROFILE "):])
    if (set(record) != {"total_s", "phases", "counts"} or set(record["counts"]) != SPAN_COUNTS
            or min(record["counts"].values()) < 1):
        fail(f"{tag} the ELP_PROFILE record has keys {sorted(record)} and counts "
             f"{record.get('counts')}")
    phases = record["phases"]
    if not {"witness_upload", SYNC_WAIT} | SPAN_TIMES <= set(phases):
        fail(f"{tag} the ELP_PROFILE record's phases {sorted(phases)} lack witness_upload, "
             f"{SYNC_WAIT} or {sorted(SPAN_TIMES)}")
    shares = {k for k in phases if k.startswith("_")}
    summed_s = sum(v for k, v in phases.items() if k not in shares)
    rounding_s = 5e-4 + 5e-5 * len(phases)  # total_s to 3 places, each phase to 4
    if summed_s > record["total_s"] + rounding_s:
        fail(f"{tag} the phases add up to {summed_s} s, more than the total {record['total_s']} s")
    if profiler.last_profile != record:
        fail(f"{tag} profiler.last_profile is not the printed record")
    logged = [PHASE_LOG.fullmatch(line) for line in err.getvalue().splitlines()]
    names = [m.group(1) for m in logged if m]
    if None in logged or names[-1:] != ["None"] or set(names[:-1]) != set(phases) - shares:
        fail(f"{tag} ELP_PHASE_LOG printed {err.getvalue()!r}")
    log(f"{tag} ELP_PROFILE record of a timed prove (prof=None, ELP_PROFILE=1 ELP_PHASE_LOG=1): "
        f"{json.dumps(record)}; {len(names)} ELP_PHASE_LOG lines, the last "
        f"{err.getvalue().splitlines()[-1]!r}; the phases without {sorted(shares)} add up to "
        f"{summed_s:.4f} s of {record['total_s']} s")
    return proof, record


def fused_launch_plan(pd) -> dict:
    """The launches of the fused kernels in one steady prove: for the
    openings of all batches one field_open_table_kernel, one
    field_open_kernel (one a group of at most 8 entries: one at phase 7's
    shapes) and, with more than one slice, one field_open_sum_kernel with
    each; one perm_quotient_kernel, one fri_g_kernel, one
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
    plans = kernels.field_open_plans([rows[tag] for tag in points],
                                     [tuple(range(k)) for k in points.values()], pd.data.n)
    return {"field_open_table_kernel": 1, "field_open_kernel": len(plans),
            "field_open_sum_kernel": sum(plan["launches"] - 2 for _, plan in plans),
            "perm_quotient_kernel": 1, "fri_g_kernel": 1,
            "fri_fold_kernel": pd.data.log_n - cfg.fri.final_poly_bits,
            "generic_gate_quotient_kernel": 1, "perm_z_kernel": 1, "perm_z_scan_kernel": 1,
            "perm_z_fixup_kernel": 1, "field_binary_kernel": 1, "field_inv_kernel": 0}


PROVER_SOURCES = ("ntt", "poseidon", "field", "gates")  # csrc/sha256.cu is no prover's


def check_sources_launched(launched: dict, what: str, sources: tuple = PROVER_SOURCES) -> None:
    """Each of ``sources`` launched at least once, csrc/sha256.cu never: no
    prove or commitment hashes with SHA-256 on the card."""
    for name in sources:
        if launched[name] <= 0:
            fail(f"{what} never launched the {name} kernel")
    if launched["sha256"]:
        fail(f"{what} launched csrc/sha256.cu {launched['sha256']} times: no prove uses it")


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
    check_sources_launched(launched, f"{tag} the main path", sources)
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
    res = profile_prove(torch, "[6]", pd, witness, proof, card, STEADY_FIELD_LAUNCHES, 1, timed=1)
    n_lde = data.n << cfg.rate_bits

    # the field kernel beside its plain version at a main-path shape: one
    # permutation chunk (8, 2^21) times another
    a = gl.from_u64(rng.integers(0, gl.P, size=(8, n_lde), dtype=np.uint64), DEVICE)
    b = gl.from_u64(rng.integers(0, gl.P, size=(8, n_lde), dtype=np.uint64), DEVICE)
    field_ms, field_events_ms = device_ms(torch, lambda: gl.mul(a, b), ("field_binary_kernel",),
                                          "field")
    field_plain_ms = cuda_ms(lambda: gl.mul_plain(a, b), 3)
    chk.same("field", gl.mul(a, b), gl.mul_plain(a, b), "timed field mul")
    # and ten launches back to back (no host time between them)
    back10_ms = cuda_ms(lambda: [gl.mul(a, b) for _ in range(10)], 5) / 10
    add_ms = cuda_ms(lambda: gl.add(a, b), 9)
    row_ms = cuda_ms(lambda: gl.mul(a, b[0]), 9)
    inv_in = a[:5]  # the table's shape since the inverse kernel came: (5, 2^21)
    inv_ms, inv_events_ms = device_ms(torch, lambda: gl.inv(inv_in), ("field_inv_kernel",),
                                      "field")
    inv_plain_ms = cuda_ms(lambda: gl.inv_plain(inv_in), 1)
    chk.same("field", gl.inv(inv_in), gl.inv_plain(inv_in), "timed field inv")
    # a 64 x 64 product is 4 multiply-adds of 32 x 32 bits, its reduction one more
    field_bound = bound_of(3 * a.numel() * 8, a.numel() * 5)
    inv_bound = bound_of(2 * inv_in.numel() * 8, inv_in.numel() * INV_PRODUCTS_PER_WORD * 5)
    log(f"[6] field: mul (8, 2^21) x (8, 2^21): kernel {field_ms:.4f} ms of device time "
        f"({field_events_ms:.4f} ms a call by events), plain "
        f"{field_plain_ms:.3f} ms, bound {field_bound[0]:.4f} ms by {field_bound[1]} "
        f"({field_bound[0] / field_ms:.1%} of the kernel's time); ten launches back to back: "
        f"{back10_ms:.4f} ms a launch ({field_bound[0] / back10_ms:.1%} of its bound); add "
        f"{add_ms:.3f} ms; mul by a row (2^21,) {row_ms:.3f} ms [{card}]")
    log(f"[6] field inv (5, 2^21): field_inv_kernel {inv_ms:.4f} ms of device time "
        f"({inv_events_ms:.4f} ms a call by events), plain {inv_plain_ms:.3f} ms, "
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
# powers) + 3, then 27 - 8 + 3 (the openings in one call): the same launches
# as phase 6's.
LC_STEADY_FIELD_LAUNCHES = 22

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
    """{kernel (mangled name): {"registers", "spill_bytes", "stack_bytes",
    "shared_bytes"}} from an ``-Xptxas -v`` report."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = out.setdefault(m.group(1), {"registers": None, "spill_bytes": None,
                                                  "stack_bytes": None, "shared_bytes": 0})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            current["stack_bytes"] = int(m.group(1))
            current["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            current["shared_bytes"] = int(smem.group(1)) if smem else 0
    return out


def kernel_registers(name: str) -> dict:
    """ptxas's registers, spills, stack frame and static shared memory of the
    kernel whose mangled name holds ``name`` (of a kernel with a window form,
    its one-device instantiation, template argument false: ``ILb0E``), from
    this process's build; None each where the library was built before (no
    report)."""
    from eth_lc_plonky2_tpu_torch.ops import kernels

    found = [v for k, v in ptxas_info(kernels.build()["ptxas"]).items()
             if name in k and "ILb1E" not in k]
    return found[0] if len(found) == 1 else dict.fromkeys(("registers", "spill_bytes",
                                                           "stack_bytes", "shared_bytes"))


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
        ms, events_ms = device_ms(torch, lambda: gate_kernel(gate, inputs, RATE_BITS, scratch),
                                  (name,), "gates")
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
        log(f"[7] gate {gate.name} at (184, 2^21), 2 challenges: kernel {ms:.4f} ms of device "
            f"time ({events_ms:.4f} ms a call by events), its words == "
            f"the generic eval loop's on the plain ops and on field.cu; the generic "
            f"eval loop on field.cu {field_ms:.3f} ms in {generic_launches} launches, on the plain "
            f"ops {plain_ms:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]} (bytes {by_bytes:.4f} ms "
            f"for {rows} rows, operations {by_ops:.4f} ms for {mads} multiply-adds a "
            f"column; {bound[0] / ms:.1%} of the kernel's time); {regs['registers']} registers, "
            f"{regs['spill_bytes']} bytes spilled, {regs['shared_bytes']} bytes of static shared "
            f"memory [{card}]")
        out[gate.name] = {"ms": ms, "events_ms": events_ms, "plain_ms": plain_ms, "field_ms": field_ms,
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


def opening_inputs(rng, log_n: int, zeta=None) -> dict:
    """Phase 7's four opening batches at 2^log_n coefficients on the card, as
    the prover's one call takes them: {"tags", "coeffs": [(rows, n)], "z_re",
    "z_im": the union of the points zeta * omega^o of the batches' offsets,
    "rows": each batch's indices into it}; zeta seeded unless given; the edge
    words stand in the first and the last columns of the coefficients."""
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl, goldilocks_ext as ge

    n = 1 << log_n
    if zeta is None:
        zeta = tuple(int(v) for v in rng.integers(0, gl.P, size=2, dtype=np.uint64))
    omega = gl.primitive_root_of_unity(log_n)
    edge = field_edge_words()
    union = sorted({o for _, _, offsets in OPEN_BATCHES for o in offsets})
    points = [ge.h_mul(zeta, (pow(omega, o % n, gl.P), 0)) for o in union]
    coeffs = []
    for tag, rows, offsets in OPEN_BATCHES:
        c = rng.integers(0, gl.P, size=(rows, n), dtype=np.uint64)
        c[:, : min(n, len(edge))] = edge[: min(n, len(edge))]
        c[::3, -1] = edge[-1]
        coeffs.append(gl.from_u64(c, DEVICE))
    return {"tags": [tag for tag, _, _ in OPEN_BATCHES], "coeffs": coeffs,
            "z_re": gl.from_u64([z[0] for z in points], DEVICE),
            "z_im": gl.from_u64([z[1] for z in points], DEVICE),
            "rows": [tuple(union.index(o) for o in offsets) for _, _, offsets in OPEN_BATCHES]}


def open_all(inp, plain: bool = False) -> list:
    """The openings of every batch of ``inp`` (``opening_inputs``) in one call
    of ``prove.open_batches``: the kernels, or the plain versions."""
    from eth_lc_plonky2_tpu_torch.prover import prove

    def run():
        return prove.open_batches(inp["coeffs"], inp["z_re"], inp["z_im"], inp["rows"])

    return on_plain(run) if plain else run()


def open_plan(inp) -> dict:
    from eth_lc_plonky2_tpu_torch.ops import kernels

    return kernels.field_open_plan([(c.shape[0], len(r)) for c, r in zip(inp["coeffs"], inp["rows"])],
                                   inp["coeffs"][0].shape[1])


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


def perm_terms(inputs, plain: bool = False):
    """The permutation terms: ``kernels.perm_quotient`` as (2, n_lde), or the
    plain version stacked the same way."""
    import torch

    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import prove

    if not plain:
        return kernels.perm_quotient(*inputs)
    return torch.stack(on_plain(lambda: prove.perm_quotient_terms_plain(*inputs)))


def generic_inputs(rng, n_lde: int, past_visit: int = 0, num_pi: int = 12) -> dict:
    """Phase 7's generic share of the quotient at n_lde columns on the card,
    as the quotient passes it: the gates in the light-client circuit's
    selector order (arith 20 ops, basesum2, const 6, noop, poseidon, sha256),
    a (184, n_lde) wires LDE, a (92, n_lde) preprocessed LDE (6 selectors, 6
    constant rows, 80 sigmas), ``num_pi`` (12; the flagship has 16) Lagrange
    rows, public inputs at seeded columns below 80 (the last ``past_visit``
    of them at or past 80, the first two of those in one column), two alpha
    rows of 1 + 10 + num_pi + 130 powers and two accumulators; random words
    with the edge words in the first and last columns."""
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
    pi_cols = [int(c) for c in rng.integers(0, NUM_ROUTED, size=num_pi)]
    if past_visit:
        past = [int(c) for c in rng.integers(NUM_ROUTED, NUM_WIRES, size=past_visit)]
        pi_cols[num_pi - past_visit :] = [past[0]] + past[:-1]
    pi = rng.integers(0, gl.P, size=num_pi, dtype=np.uint64)
    pi[:5] = edge[:5]
    return {"generic": prove.split_gates(SimpleNamespace(gates=gates))[0], "wires": rows(NUM_WIRES),
            "pre": rows(92), "num_sel": len(gates), "num_con": 6, "lr": rows(num_pi),
            "pi": gl.from_u64(pi, DEVICE), "pi_cols_host": pi_cols,
            "pi_cols": torch.tensor(pi_cols, dtype=torch.int64, device=pi_cols_device()),
            "apows": [gl.from_u64(rng.integers(0, gl.P, size=1 + 10 + num_pi + 130, dtype=np.uint64),
                                  DEVICE) for _ in range(2)],
            "accs": list(rows(2)), "pi0": 1 + 10, "k0": 1 + 10 + num_pi}


def pi_cols_device() -> str:
    """Where ``kernels.generic_gate_quotient`` takes the public inputs'
    columns: on the host since its plan places them (an older checkout, timed
    in turns by tools/torch_kernel_times.py, read them on the card)."""
    from eth_lc_plonky2_tpu_torch.ops import kernels

    return "cpu" if hasattr(kernels, "GEN_TILE") else DEVICE


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
    (fri.g_plain on the plain ops or on field.cu); "launch" is kernels.fri_g's
    own return, unstacked (for its timing)."""
    import torch

    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import fri

    args = (inp["ldes"], inp["apow"], inp["y"], inp["z"], inp["x"])
    if mode in ("kernel", "launch"):
        out = kernels.fri_g(*args, tuple(fri.TAGS.index(t) for t in inp["tags"]))
        return out if mode == "launch" else torch.stack(out)

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
    "eager" (fri.fold_plain on the plain ops or on field.cu); "launch" is
    kernels.fri_fold's own return, unstacked (for its timing)."""
    import torch

    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import fri

    args = (inp["re"], inp["im"], inp["w_inv"], inp["scale"])
    if mode in ("kernel", "launch"):
        out = kernels.fri_fold(*args, fri.INV2, inp["beta"])
        return out if mode == "launch" else torch.stack(out)

    def run():
        return torch.stack(fri.fold_plain(*args, inp["beta"]))

    return on_plain(run) if mode == "plain" else run()


# The openings' least work: the coefficients read once, the points read and
# the values written once (8 bytes a word; the power table and the slices'
# partial sums are csrc/field.cu's intermediates, not counted); on the int8
# tensor cores, 64 byte-plane pairs for each coefficient word and power word
# that meet (rows x 2 points x n), each a multiply-add of two operations, no
# tile padding; the powers z^c themselves on the integer pipe, one ext
# product (4 multiply-accumulates and 2 reductions, 26 in the count below)
# for each point and column past the first.  The two pipes run side by side, so the operations' time is
# the larger of theirs.  32 x 32 multiply-adds, in the cheapest form known (a 64 x
# 64 product is 4, its reduction one more, a multiply-accumulate into the
# column sums 4): the permutation terms, per column and challenge, per chunk
# of 8 wires 8 + 8 products for the factors and 7 + 7 for the running
# products, 2 for the chain terms and 2 multiply-accumulates by alpha, and for
# term 0 one product and 2 multiply-accumulates.
OPEN_PLANE_PAIRS = 64
PERM_MADS_PER_COLUMN = 2 * ((NUM_ROUTED // PERM_CHUNK) * ((2 * PERM_CHUNK + 2 * (PERM_CHUNK - 1) + 2) * 5
                                                          + 2 * 4) + 5 + 2 * 4)


def open_bound(inp) -> tuple:
    """The openings' least time on the card: (ms, "bytes" or "operations",
    bytes, int8 operations, 32 x 32 multiply-adds), from this run's inputs."""
    n, points = inp["coeffs"][0].shape[1], inp["z_re"].numel()
    values = sum(2 * len(r) * c.shape[0] for c, r in zip(inp["coeffs"], inp["rows"]))
    nbytes = (sum(c.numel() for c in inp["coeffs"]) + 2 * points + values) * 8
    ops = sum(2 * OPEN_PLANE_PAIRS * c.shape[0] * 2 * len(r) * n
              for c, r in zip(inp["coeffs"], inp["rows"]))
    mads = points * (n - 1) * (4 * 4 + 2 * 5)
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = max(ops / PEAK_INT8_OPS_PER_S, mads / PEAK_INT32_MADS_PER_S) * 1e3
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", nbytes, ops,
            mads)


def check_fused_field_kernels(torch, chk: Checker, rng, card: str) -> dict:
    """Both fused kernels of csrc/field.cu against their plain versions at the
    main path's shapes: phase 7's four opening batches at 2^18 coefficients
    (92, 184, 20 and 16 rows, three of them no multiple of 16; 12 points, 9
    in the power table's union) in one call, and the permutation terms at
    (80, 2^21) with 2 challenges and chunk 8, edge words included; then the
    openings at 2^12 with edge points, and the power table alone against its
    plain version.  Each call must launch only its plan's launches (no
    field_binary_kernel); each is timed (device time, ``device_ms``) beside
    its bound, its plain version and the eager chain of field.cu ops it
    replaces (CUDA events)."""
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl, kernels
    from eth_lc_plonky2_tpu_torch.prover import prove

    out = {}
    inp = opening_inputs(rng, LOG_N)
    plan = open_plan(inp)
    before = kernels.launches["field"]
    got = open_all(inp)
    if kernels.launches["field"] - before != plan["launches"]:
        fail(f"openings: {kernels.launches['field'] - before} field launches, the plan's are "
             f"{plan['launches']}")
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(open_all(inp, plain=True)), 1)
    for tag, g, w in zip(inp["tags"], got, plain[-1]):
        chk.same("field", g[0], w[0], f"openings {tag}, real parts")
        chk.same("field", g[1], w[1], f"openings {tag}, imaginary parts")
    del plain, got
    ms, events_ms = device_ms(torch, lambda: open_all(inp), TRACED_AS["field_open_kernel"], "field")
    n = inp["coeffs"][0].shape[1]
    table_ms, _ = device_ms(torch, lambda: kernels.field_open_table(inp["z_re"], inp["z_im"], n),
                            ("field_open_table_kernel",), "field")
    chk.same("field", kernels.field_open_table(inp["z_re"], inp["z_im"], n),
             on_plain(lambda: prove.open_table_plain(inp["z_re"], inp["z_im"], n)),
             f"the power table at 2^{LOG_N}")
    before = kernels.launches["field"]
    # the plain version's field ops on CUDA tensors: one field_binary_kernel each
    chain_ms = cuda_ms(lambda: prove.open_batches_plain(inp["coeffs"], inp["z_re"], inp["z_im"],
                                                        inp["rows"]), 1)
    chain_launches = kernels.launches["field"] - before
    bound_ms, bound_by, nbytes, ops, mads = open_bound(inp)
    out["field_open_kernel"] = dict(ms=ms, events_ms=events_ms, plain_ms=plain_ms, chain_ms=chain_ms,
                                    chain_launches=chain_launches, table_ms=table_ms,
                                    launches=plan["launches"], bound_ms=bound_ms, bound_by=bound_by)
    log(f"[7] openings, the four batches of phase 7 (92, 184, 20, 16 rows of 2^{LOG_N}; 12 points, "
        f"{inp['z_re'].numel()} in the table) in one call: field_open_table_kernel, "
        f"field_open_kernel and its sum {ms:.4f} ms of device time in {plan['launches']} launches "
        f"({events_ms:.4f} ms a call by events; the table alone "
        f"{table_ms:.3f} ms), its words == the plain version's ({plain_ms:.3f} ms); the eager chain on "
        f"field.cu it replaces {chain_ms:.3f} ms in {chain_launches} launches; bound {bound_ms:.4f} "
        f"ms by {bound_by} ({nbytes} bytes, {ops} int8 tensor operations, {mads} 32 x 32 "
        f"multiply-adds for the powers; {bound_ms / ms:.1%} of the "
        f"kernels' time); plan blocks {plan['blocks']} x slices {plan['slices']} [{card}]")
    del inp
    # edge points at 2^12: zeta with words at the ends of the range
    for zeta in ((gl.P - 1, 1 << 63), (0, 1), (1 << 32, gl.P - 1)):
        small = opening_inputs(rng, 12, zeta)
        for tag, g, w in zip(small["tags"], open_all(small), open_all(small, plain=True)):
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
    ms, events_ms = device_ms(torch, lambda: perm_terms(inputs), ("perm_quotient_kernel",), "field")
    before = kernels.launches["field"]
    chain_ms = cuda_ms(lambda: prove.perm_quotient_terms_plain(*inputs), 1)
    chain_launches = kernels.launches["field"] - before
    n_lde = 1 << (LOG_N + RATE_BITS)
    rows_read = 2 * NUM_ROUTED + NUM_Z + 2  # wires, sigmas, Z rows, x, l0
    bound = bound_of((rows_read + 2) * n_lde * 8, PERM_MADS_PER_COLUMN * n_lde)
    regs = kernel_registers("perm_quotient_kernel")
    out["perm_quotient_kernel"] = dict(ms=ms, events_ms=events_ms, plain_ms=plain_ms,
                                       chain_ms=chain_ms,
                                       chain_launches=chain_launches,
                                       **dict(zip(("bound_ms", "bound_by"), bound)),
                                       registers=regs["registers"], stack_bytes=regs["stack_bytes"])
    r = out["perm_quotient_kernel"]
    log(f"[7] permutation terms at (80, 2^{LOG_N + RATE_BITS}), 2 challenges, chunk 8: "
        f"perm_quotient_kernel {ms:.4f} ms of device time in 1 launch ({events_ms:.4f} ms a call "
        f"by events), its words == the plain version's "
        f"({plain_ms:.3f} ms); the eager chain on field.cu it replaces {chain_ms:.3f} ms in "
        f"{chain_launches} launches; bound {r['bound_ms']:.4f} ms by {r['bound_by']} ({rows_read} "
        f"rows read, 2 written; {PERM_MADS_PER_COLUMN} multiply-adds a column; "
        f"{r['bound_ms'] / ms:.1%} of the kernel's time); {regs['registers']} registers, "
        f"{regs['stack_bytes']} bytes of stack, {regs['spill_bytes']} bytes spilled [{card}]")
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
    """run("kernel") against run("plain") (timed once), and the eager chain on
    field.cu run("eager") timed once with its field launches (CUDA events):
    (plain_ms, chain_ms, chain_launches).  The kernel's own time is
    ``device_ms`` of its bare wrapper call."""
    from eth_lc_plonky2_tpu_torch.ops import kernels

    got = run("kernel")
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(run("plain")), 1)
    chk.same(source, got, plain[-1], what)
    del got, plain
    before = kernels.launches["field"]
    chain_ms = cuda_ms(lambda: run("eager"), 1)
    return plain_ms, chain_ms, kernels.launches["field"] - before


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
    # public inputs at columns past the 80 the gates visit; 16 (the flagship's:
    # a ring of 3 stages) and 64 (tiles of 128 columns) public inputs
    for log_n_lde, past, num_pi in ((7, 0, 12), (7, 3, 12), (12, 0, 12), (12, 3, 16),
                                    (12, 3, 64)):
        inp = generic_inputs(rng, 1 << log_n_lde, past, num_pi)
        got = launches_of(lambda: generic_terms(inp), {"gates": 1}, "generic gates")
        chk.same("gates", got, generic_terms(inp, "plain"),
                 f"generic gates at n_lde 2^{log_n_lde}, {num_pi} public inputs, {past} past the "
                 f"visit")
    inp = generic_inputs(rng, n_lde)
    launches_of(lambda: generic_terms(inp), {"gates": 1}, "generic gates at 2^21")
    plain_ms, chain_ms, chain_launches = timed_against_plain(
        torch, chk, "gates", lambda mode: generic_terms(inp, mode),
        f"generic gates at (184, 2^{LOG_N + RATE_BITS})")
    scratch = [a.clone() for a in inp["accs"]]
    launch_ms, events_ms = device_ms(torch, lambda: kernels.generic_gate_quotient(
        inp["generic"], inp["wires"], inp["pre"], inp["num_sel"], inp["num_con"], inp["lr"],
        inp["pi"], inp["pi_cols"], inp["apows"], scratch, inp["pi0"], inp["k0"]),
        ("generic_gate_quotient_kernel",), "gates")
    del inp, scratch
    bound = bound_of(GENERIC_ROWS * n_lde * 8, GENERIC_MADS_PER_COLUMN * n_lde)
    regs = kernel_registers("generic_gate_quotient_kernel")
    out["generic_gate_quotient_kernel"] = dict(
        ms=launch_ms, events_ms=events_ms, plain_ms=plain_ms, chain_ms=chain_ms,
        chain_launches=chain_launches, bound_ms=bound[0], bound_by=bound[1],
        registers=regs["registers"], stack_bytes=regs["stack_bytes"])
    log(f"[7] generic gates and 12 public inputs at (184, 2^{LOG_N + RATE_BITS}), 2 challenges: "
        f"generic_gate_quotient_kernel {launch_ms:.4f} ms of device time in 1 launch "
        f"({events_ms:.4f} ms a call by events), its words == the plain version's "
        f"({plain_ms:.3f} ms); the eager "
        f"chain on field.cu it replaces {chain_ms:.3f} ms in {chain_launches} launches; bound "
        f"{bound[0]:.4f} ms by {bound[1]} ({GENERIC_ROWS} rows, {GENERIC_MADS_PER_COLUMN} "
        f"multiply-adds a column; {bound[0] / launch_ms:.1%} of the kernel's time); "
        f"{regs['registers']} registers, {regs['stack_bytes']} bytes of stack, "
        f"{regs['spill_bytes']} bytes spilled [{card}]")

    for num_specs in sorted(G_SPEC_TAGS):
        inp = g_inputs(rng, 12, num_specs)
        got = launches_of(lambda: g_terms(inp), {"field": 1}, "fri G")
        chk.same("field", got, g_terms(inp, "plain"), f"fri G at 2^12, {num_specs} specs")
    rows = sum(G_ROWS.values())
    for num_specs in sorted(G_SPEC_TAGS):
        inp = g_inputs(rng, LOG_N + RATE_BITS, num_specs)
        launches_of(lambda: g_terms(inp), {"field": 1}, "fri G at 2^21")
        plain_ms, chain_ms, chain_launches = timed_against_plain(
            torch, chk, "field", lambda mode: g_terms(inp, mode),
            f"fri G at 2^{LOG_N + RATE_BITS}, {num_specs} specs")
        ms, events_ms = device_ms(torch, lambda: g_terms(inp, "launch"), ("fri_g_kernel",), "field")
        del inp
        bound = bound_of((rows + 1 + 2) * n_lde * 8,
                         (rows * 2 * 4 + num_specs * G_MADS_PER_SPEC + G_MADS_FERMAT) * n_lde)
        entry = dict(ms=ms, events_ms=events_ms, plain_ms=plain_ms, chain_ms=chain_ms,
                     chain_launches=chain_launches, bound_ms=bound[0], bound_by=bound[1])
        if num_specs == 12:
            out["fri_g_kernel"] = entry
        log(f"[7] fri G at 2^{LOG_N + RATE_BITS} over {rows} rows (92, 184, 20, 16), {num_specs} "
            f"specs: fri_g_kernel {ms:.4f} ms of device time in 1 launch ({events_ms:.4f} ms a "
            f"call by events), its words == the plain version's "
            f"({plain_ms:.3f} ms); the eager chain on field.cu it replaces {chain_ms:.3f} ms in "
            f"{chain_launches} launches; bound {bound[0]:.4f} ms by {bound[1]} "
            f"({bound[0] / ms:.1%} of the kernel's time) [{card}]")

    for log_size in range(1, LOG_N + RATE_BITS + 1):
        inp = fold_inputs(rng, log_size)
        got = launches_of(lambda: fold_terms(inp), {"field": 1}, "fri fold")
        chk.same("field", got, fold_terms(inp, "plain"), f"fri fold of 2^{log_size}")
    plain_ms, chain_ms, chain_launches = timed_against_plain(
        torch, chk, "field", lambda mode: fold_terms(inp, mode), "fri fold of 2^21")
    ms, events_ms = device_ms(torch, lambda: fold_terms(inp, "launch"), ("fri_fold_kernel",), "field")
    h = n_lde // 2
    bound = bound_of(7 * h * 8, FOLD_MADS_PER_WORD * h)
    out["fri_fold_kernel"] = dict(ms=ms, events_ms=events_ms, plain_ms=plain_ms, chain_ms=chain_ms,
                                  chain_launches=chain_launches, bound_ms=bound[0],
                                  bound_by=bound[1])
    log(f"[7] fri fold 2^{LOG_N + RATE_BITS} -> 2^{LOG_N + RATE_BITS - 1}: fri_fold_kernel "
        f"{ms:.4f} ms of device time in 1 launch ({events_ms:.4f} ms a call by events, its two "
        f"outputs as the wrapper returns them), its words == the "
        f"plain version's ({plain_ms:.3f} ms) at every size 2^1 to 2^{LOG_N + RATE_BITS}; the eager "
        f"chain on field.cu it replaces {chain_ms:.3f} ms in {chain_launches} launches; bound "
        f"{bound[0]:.4f} ms by {bound[1]} ({bound[0] / ms:.1%} of the kernel's time) [{card}]")
    torch.cuda.synchronize()
    return out


def perm_z_inputs(rng, log_n: int, zeros: tuple = (), routed: int = NUM_ROUTED,
                  chunk: int = PERM_CHUNK) -> tuple:
    """The permutation rows' arguments at 2^log_n rows on the card, as prove
    passes them: the ``routed`` (80) routed rows of a (routed + 104, n) wires
    matrix (read through its row stride), as many sigma rows, the subgroup's
    points, the k shifts, two betas and gammas, ``chunk`` (8); seeded words
    with the edge words in the first columns.  Each (challenge j, chunk k,
    column x) of ``zeros`` sets the wire x % chunk of chunk k at column x to
    -(beta_j sigma + gamma_j): chunk k's den is 0 there, so challenge j's Z is
    0 from column x + 1 on."""
    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl, host_field as hf

    n = 1 << log_n
    edge = field_edge_words()
    wires = rng.integers(0, gl.P, size=(routed + NUM_WIRES - NUM_ROUTED, n), dtype=np.uint64)
    sigma = rng.integers(0, gl.P, size=(routed, n), dtype=np.uint64)
    wires[:, : min(n, len(edge))] = edge[: min(n, len(edge))]
    sigma[::3, : min(n, len(edge))] = edge[::-1][: min(n, len(edge))]
    betas = rng.integers(0, gl.P, size=2, dtype=np.uint64)
    gammas = rng.integers(0, gl.P, size=2, dtype=np.uint64)
    for j, k, x in zeros:
        i = k * chunk + x % chunk
        wires[i, x] = (gl.P - (int(betas[j]) * int(sigma[i, x]) + int(gammas[j])) % gl.P) % gl.P
    dev = lambda a: gl.from_u64(a, DEVICE)  # noqa: E731
    return (dev(wires)[:routed], dev(sigma), dev(hf.powers(gl.primitive_root_of_unity(log_n), n)),
            dev(hf.powers(gl.MULTIPLICATIVE_GENERATOR, routed)), dev(betas), dev(gammas), chunk)


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
# the kernel names of the permutation rows: perm_z_kernel, its scan and its
# fix-up (device_ms sums their durations)
PERM_ROWS_KERNELS = ("perm_z_kernel", "perm_z_scan_kernel", "perm_z_fixup_kernel")
PERM_Z_PRODUCTS_PER_COLUMN = 2 * (NUM_ROUTED * 4 + PERM_Z_CHUNKS * 4 + 2 * (PERM_Z_CHUNKS - 1) + 1) + 72


def check_perm_z_kernel(torch, chk: Checker, rng, card: str) -> dict:
    """perm_z_kernel, its scan and its fix-up against the plain permutation
    rows and the eager chain of field.cu ops they replaced, both challenges at
    (80, 2^18) with zero den chunks near the end (challenge 0's chunk 3 at
    column n - 300, challenge 1's chunk 9 at n - 2), timed beside the bound,
    the plain version and the eager chain; then at 2^12 with zeros in the first
    block, one challenge, at 2^4 (less than a block), and 256 routed wires in
    chunks of 4 at 2^14 (m = 64: 512 blocks of 32 columns).  Each call
    launches the plan's 3 field kernels and nothing else."""
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
    del zs
    plain_ms, chain_ms, chain_launches = timed_against_plain(
        torch, chk, "field", lambda mode: perm_rows(inputs, mode),
        f"permutation rows at (80, 2^{LOG_N}), 2 challenges")
    ms, events_ms = device_ms(torch, lambda: perm_rows(inputs), PERM_ROWS_KERNELS, "field")
    del inputs, got
    bound = bound_of((2 * NUM_ROUTED + 1 + NUM_Z) * n * 8, PERM_Z_PRODUCTS_PER_COLUMN * 5 * n)
    plan = kernels.perm_z_plan(NUM_ROUTED, n, PERM_CHUNK, 2)
    log(f"[7] permutation rows at (80, 2^{LOG_N}), 2 challenges, chunk 8, zero den chunks: "
        f"perm_z_kernel + scan + fix-up {ms:.4f} ms of device time in {plan['launches']} launches "
        f"({events_ms:.4f} ms a call by events; {plan['blocks']} blocks of {plan['threads']}, "
        f"{plan['shared_bytes']} bytes of shared memory), its words == the plain version's "
        f"({plain_ms:.3f} ms) and the eager chain's; the eager chain on field.cu it replaces "
        f"{chain_ms:.3f} ms in {chain_launches} launches; bound {bound[0]:.4f} ms by {bound[1]} "
        f"({2 * NUM_ROUTED + 1} rows read, {NUM_Z} written; {PERM_Z_PRODUCTS_PER_COLUMN} products a "
        f"column; {bound[0] / ms:.1%} of the kernels' time) [{card}]")
    small = perm_z_inputs(rng, 12, ((0, 0, 5), (1, 4, 300)))
    one = small[:4] + (small[4][1:], small[5][1:], PERM_CHUNK)
    tiny = perm_z_inputs(rng, 4, ((0, 2, 3),))
    narrow = perm_z_inputs(rng, 14, ((0, 40, 9000), (1, 63, 16000)), routed=256, chunk=4)
    got = [launches_of(lambda: perm_rows(small), "permutation rows at 2^12"),
           launches_of(lambda: perm_rows(one), "one challenge's rows at 2^12"),
           launches_of(lambda: perm_rows(tiny), "permutation rows at 2^4"),
           launches_of(lambda: perm_rows(narrow), "permutation rows at (256, 2^14), chunk 4")]
    chk.same("field", got[0], perm_rows(small, "plain"),
             "permutation rows at (80, 2^12), zeros in the first block")
    chk.same("field", got[1], perm_rows(one, "plain"), "permutation rows at (80, 2^12), one challenge")
    chk.same("field", got[2], perm_rows(tiny, "plain"), "permutation rows at (80, 2^4), less than a block")
    chk.same("field", got[3], perm_rows(narrow, "plain"),
             "permutation rows at (256, 2^14), chunk 4: blocks of 32 columns")
    torch.cuda.synchronize()
    return {"perm_z_kernel": dict(ms=ms, events_ms=events_ms, plain_ms=plain_ms, chain_ms=chain_ms,
                                  chain_launches=chain_launches, bound_ms=bound[0],
                                  bound_by=bound[1])}


def measure_perm_polys(torch, rng, card: str) -> dict:
    """The permutation rows of both challenges at (80 of 184, 2^18), through
    ``prove.compute_permutation_polys`` a challenge and ``torch.cat``, as the
    prove of every checkout since the rows were ported called them (an entry
    both sides of a comparison have): the device time of the rows' kernels
    (``PERM_ROWS_KERNELS``), with the field launches of one call.  Where the package has
    ``prove.permutation_polys``, its one call for both challenges is timed too
    (``both_ms``)."""
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
    ms, events_ms = device_ms(torch, per_challenge, PERM_ROWS_KERNELS, "field")
    res = {"perm_polys_ms": ms, "perm_polys_events_ms": events_ms,
           "perm_polys_field_launches": launched, "both_ms": None}
    if hasattr(prove, "permutation_polys"):
        both = prove.permutation_polys(pd, wires, b, g)
        if not torch.equal(both, want):
            fail("permutation_polys of both challenges differs from one call a challenge")
        res["both_ms"], res["both_events_ms"] = device_ms(
            torch, lambda: prove.permutation_polys(pd, wires, b, g), PERM_ROWS_KERNELS, "field")
        res["both_field_launches"] = kernels.perm_z_plan(NUM_ROUTED, 1 << LOG_N, chunk, 2)["launches"]
    log(f"[m] permutation rows (80, 2^{LOG_N}), 2 challenges: compute_permutation_polys a challenge "
        f"and a cat: the rows' kernels {ms:.4f} ms of device time in {launched} field launches "
        f"({events_ms:.4f} ms a call by events); both challenges in one call: {res['both_ms']} ms "
        f"of device time ({res.get('both_events_ms')} ms by events) [{card}]")
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
        kernels, field_open=prove.open_batches_plain, perm_z=prove.perm_rows_plain,
        perm_quotient=lambda *args, window=False: torch.stack(
            prove.perm_quotient_terms_plain(*args)),
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
    res = profile_prove(torch, "[7]", pd, witness, proof, card, LC_STEADY_FIELD_LAUNCHES, 3, timed=1)
    check_forged_rejected(data, vk, pd, witness, "[7] 2^18 rows")
    fused_against_eager_chains(torch, pd, witness, proof, card)
    del pd
    gates_res = measure_gate_kernels(torch, chk, rng, card)
    fused_res = check_fused_field_kernels(torch, chk, rng, card)
    fused_res.update(check_fused_quotient_fri_kernels(torch, chk, rng, card))
    fused_res.update(check_perm_z_kernel(torch, chk, rng, card))
    windows = measure_window_kernels(torch, rng, card)
    return {"launches": launched, "prove_ms": res["prove_ms"], "phase_ms": res["phase_ms"],
            "gates": gates_res, "fused": fused_res, "windows": windows, "traced": res["by_name"]}


# ---------------------------------------------------------------------------
# Phase 8: the light-client circuit itself, through the CLI's entry point
# ---------------------------------------------------------------------------

FLAGSHIP_COMMITTEE = 512
FLAGSHIP_BUNDLE = os.path.join(REPO, "lc512_bls_bundle.json")  # the JAX package's flagship bundle


class CliLog:
    """A text stream for ``cli.run``'s ``out=``: each line it prints is logged."""

    def __init__(self, tag: str):
        self.tag, self.buf = tag, ""

    def write(self, text: str) -> None:
        self.buf += text
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            log(f"{self.tag} cli: {line}")

    def flush(self) -> None:
        pass


def check_inner_proof(torch, cli_inner, kw: dict, card: str) -> None:
    """The dummy BLS circuit (142 wires, a small domain, 8 PoW bits, 12
    queries): its proof on the kernels equals the one on the plain versions
    on the card and the one the CLI made, the port's verifier accepts it, and
    where cloudpickle is present the circuit cache gives the same proof."""
    import tempfile

    from eth_lc_plonky2_tpu_torch.models import bls
    from eth_lc_plonky2_tpu_torch.prover import prove, serialize
    from eth_lc_plonky2_tpu_torch.prover.verify import verify

    data, cli_proof, cli_vk = cli_inner
    w = bls.dummy_bls_witness(data, kw["signing_root"], kw["signature"],
                              kw["sync_committee_pubkeys"], kw["sync_committee_bits"])
    pd, vk = prove.preprocess(data)
    if not np.array_equal(vk.pre_cap, cli_vk.pre_cap):
        fail("[8] the inner circuit's preprocessed cap differs from the CLI's")
    cfg = data.config
    got = prove_kernels_and_plain(
        torch, pd, w, f"[8] the dummy BLS circuit ({cfg.num_wires} wires, {data.num_rows_used} "
        f"of 2^{data.log_n} rows, "
        f"{cfg.fri.proof_of_work_bits} PoW bits, {cfg.fri.num_query_rounds} queries)",
        ("ntt", "poseidon", "field", "gates"))
    if (where := first_difference(got, proof_dict(cli_proof))):
        fail(f"[8] the inner proof differs from the CLI's at {where}")
    verify(data, vk, cli_proof)
    if importlib.util.find_spec("cloudpickle") is None:
        log("[8] cloudpickle is absent: the circuit cache (serialize.save_circuit) is not run")
        return
    with tempfile.TemporaryDirectory() as tmp:
        serialize.save_circuit(tmp, data, pd, extras=("inner", data.num_rows_used))
        extras, data2, pd2, vk2 = serialize.load_circuit(tmp)
        w2 = bls.dummy_bls_witness(data2, kw["signing_root"], kw["signature"],
                                   kw["sync_committee_pubkeys"], kw["sync_committee_bits"])
        again = proof_dict(prove.prove(pd2, w2))
    if pd2.device.type != "cuda" or not np.array_equal(vk2.pre_cap, vk.pre_cap) \
            or extras != ("inner", data.num_rows_used) or first_difference(again, got):
        fail("[8] the circuit cache does not give the same circuit and proof on the card")
    log("[8] the inner circuit saved and loaded through the circuit cache (cloudpickle) gives "
        "the same proof on the card")


def check_bundle(bundle_path: str, report: dict) -> None:
    """The bundle's config and circuit sections must equal the committed
    flagship bundle's (the vk comparison is logged), and the standalone
    verifier must accept it and reject a tampered copy."""
    with open(bundle_path) as f:
        bundle = json.load(f)
    with open(FLAGSHIP_BUNDLE) as f:
        committed = json.load(f)
    for key in ("config", "circuit"):
        if bundle[key] != committed[key]:
            fail(f"[8] the bundle's {key} section differs from lc512_bls_bundle.json's "
                 f"(at {first_difference(bundle[key], committed[key], key)})")
    vk_equal = bundle["vk"] == committed["vk"]
    log(f"[8] the bundle's config and circuit sections == lc512_bls_bundle.json's; vk.pre_cap "
        f"{'==' if vk_equal else '!='} the committed bundle's vk")
    check_standalone(bundle_path, report, "[8]")


def check_standalone(bundle_path: str, report: dict, tag: str) -> None:
    """tools/verify_standalone.py (standard library only) accepts the bundle
    and rejects a copy with a tampered public input."""
    import tempfile

    with open(bundle_path) as f:
        bundle = json.load(f)
    tool = os.path.join(REPO, "tools", "verify_standalone.py")
    t0 = time.perf_counter()
    ok = subprocess.run([sys.executable, tool, bundle_path], capture_output=True, text=True,
                        timeout=600)
    standalone_s = time.perf_counter() - t0
    if ok.returncode != 0:
        fail(f"{tag} tools/verify_standalone.py rejects the port's bundle: {ok.stdout}{ok.stderr}")
    bad = json.loads(json.dumps(bundle))
    pi0 = int(bad["proof"]["public_inputs"][0], 16)
    bad["proof"]["public_inputs"][0] = hex(pi0 + 1 if pi0 < 0xFFFF_FFFF else pi0 - 1)
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(bad, f)
    try:
        rej = subprocess.run([sys.executable, tool, f.name], capture_output=True, text=True,
                             timeout=600)
    finally:
        os.unlink(f.name)
    if rej.returncode == 0:
        fail(f"{tag} tools/verify_standalone.py accepts a bundle with a tampered public input")
    log(f"{tag} tools/verify_standalone.py accepts the bundle in {standalone_s:.1f} s "
        f"({ok.stdout.strip().splitlines()[-1] if ok.stdout.strip() else 'rc 0'}) and rejects "
        f"the copy with a tampered public input (rc {rej.returncode}); bundle exported in "
        f"{report.get('bundle_export_s')} s, {os.path.getsize(bundle_path) / 1e6:.2f} MB")


def phase8(torch, card: str, seed: int, cache_dir: str) -> dict:
    """``cli.run`` at --synthetic 512 --bls dummy, nothing cut: the inner
    proof, the outer circuit's build and witness, preprocess, a first prove,
    export and verify (the public inputs against the host's SSZ roots), then
    the steady proves, the trace, forged witnesses and the bundle.  The
    circuit goes into ``cache_dir`` (phase 10's ranks load it), and the
    returned ``proof`` is the first proof's JSON."""
    import tempfile

    from eth_lc_plonky2_tpu_torch import cli
    from eth_lc_plonky2_tpu_torch.eth.synthetic import make_synthetic_update_pair
    from eth_lc_plonky2_tpu_torch.models.lc_circuit import default_threshold
    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import prove

    syn = make_synthetic_update_pair(FLAGSHIP_COMMITTEE, seed=seed)
    if syn.threshold != default_threshold(FLAGSHIP_COMMITTEE):
        fail(f"[8] the synthetic pair's threshold {syn.threshold} is not the default")
    keep: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        bundle_path = os.path.join(tmp, "lc512_bundle.json")
        # the main path: the counts are set to 0 just before the CLI's entry
        # point and read just after it
        kernels.reset_launches()
        t0 = time.perf_counter()
        report = cli.run(syn.witness_kwargs, FLAGSHIP_COMMITTEE, syn.threshold, bls_mode="dummy",
                         export_bundle_path=bundle_path, cache_dir=cache_dir, out=CliLog("[8]"),
                         keep=keep)
        torch.cuda.synchronize()
        launched = dict(kernels.launches)
        run_s = time.perf_counter() - t0
        log(f"[8] cli.run --synthetic {FLAGSHIP_COMMITTEE} --bls dummy --seed {seed} in "
            f"{run_s:.1f} s, launches {launched}: {json.dumps(report)} [{card}]")
        check_sources_launched(launched, "[8] the main path")
        if (report["rows_used"], report["degree_bits"]) != (FLAGSHIP_ROWS_USED, LOG_N):
            fail(f"[8] the flagship circuit has {report['rows_used']} rows on "
                 f"2^{report['degree_bits']}, the JAX package's {FLAGSHIP_ROWS_USED} on 2^{LOG_N}")
        if (report["cur_state"], report["new_state"]) != (syn.cur_state.hex(), syn.new_state.hex()):
            fail("[8] the public inputs are not the host SSZ contract_state_root of the pair")
        check_bundle(bundle_path, report)
    data, witness, pd, vk, proof = (keep[k] for k in ("data", "witness", "pd", "vk", "proof"))
    log(f"[8] {data.config.num_wires} wires, {len(data.public_input_targets)} public inputs, "
        f"{len(pd.pre_values)} preprocessed polys, "
        f"{len(prove.opening_point_specs(data))} opening points, gates {report['gate_counts']}")
    check_inner_proof(torch, keep["bls_inners"][0], syn.witness_kwargs, card)
    res = profile_prove(torch, "[8]", pd, witness, proof, card, LC_STEADY_FIELD_LAUNCHES, 3,
                        switch=True)
    check_forged_rejected(data, vk, pd, witness, "[8] the flagship")
    log(f"[8] full512_prove_wall_s {res['prove_ms'] / 1e3:.5f} (median of 3 steady proves) "
        f"[{card}]")
    check_stream(torch, keep, card)
    return {"launches": launched, "traced": res["by_name"], "cache_dir": cache_dir,
            "proof": json.dumps(proof_dict(proof))}


STREAM_SEEDS = (1, 2, 3)


def check_stream(torch, keep: dict, card: str) -> None:
    """prove_stream over three more synthetic pairs (seeds 1 to 3, prefetch 1)
    with the flagship's prover data.  Each pair's inner dummy BLS proof is made
    on the card first, on this thread: the stream's worker makes the outer
    witnesses only, host work.  Each streamed proof must equal a sequential
    prove of the same witness byte for byte, pass verify and carry its pair's
    contract-state roots; the stream's wall is logged beside the sequential
    sum of witness and prove."""
    import threading

    from eth_lc_plonky2_tpu_torch import cli
    from eth_lc_plonky2_tpu_torch.eth.synthetic import make_synthetic_update_pair
    from eth_lc_plonky2_tpu_torch.models import bls
    from eth_lc_plonky2_tpu_torch.prover import prove
    from eth_lc_plonky2_tpu_torch.prover.pipeline import prove_stream
    from eth_lc_plonky2_tpu_torch.prover.verify import verify

    data, pd, vk, target, bls_targets = (keep[k] for k in ("data", "pd", "vk", "target",
                                                           "bls_targets"))
    inner_data, _, inner_vk = keep["bls_inners"][0]
    inner_pd, _ = prove.preprocess(inner_data)
    items = []
    for seed in STREAM_SEEDS:
        syn = make_synthetic_update_pair(FLAGSHIP_COMMITTEE, seed=seed)
        kw = syn.witness_kwargs
        inner_w = bls.dummy_bls_witness(inner_data, kw["signing_root"], kw["signature"],
                                        kw["sync_committee_pubkeys"], kw["sync_committee_bits"])
        items.append((syn, [(inner_data, prove.prove(inner_pd, inner_w), inner_vk)]))
    made = []  # (witness, seconds, thread) in the order the worker made them

    def make_witness(d, item):
        t0 = time.perf_counter()
        w = cli.light_client_witness(d, target, item[0].witness_kwargs, bls_targets, item[1])
        made.append((w, time.perf_counter() - t0, threading.get_ident()))
        return w

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streamed = list(prove_stream(pd, items, make_witness, prefetch=1))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    if len(streamed) != len(items) or threading.get_ident() in {m[2] for m in made}:
        fail(f"[8] the stream gave {len(streamed)} proofs of {len(items)}, or its witnesses were "
             "made on the proving thread")
    prove_s = []
    for (w, _, _), proof, (syn, _) in zip(made, streamed, items):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = prove.prove(pd, w)
        torch.cuda.synchronize()
        prove_s.append(time.perf_counter() - t0)
        if (where := first_difference(proof_dict(proof), proof_dict(again))):
            fail(f"[8] a streamed proof differs from the sequential prove of its witness at {where}")
        verify(data, vk, proof)
        if cli._public_inputs_hex(proof.public_inputs) != (syn.cur_state.hex(), syn.new_state.hex()):
            fail("[8] a streamed proof's public inputs are not its pair's contract-state roots")
    witness_s = [m[1] for m in made]
    log(f"[8] prove_stream of {len(items)} pairs (seeds {STREAM_SEEDS}, prefetch 1): "
        f"{stream_s:.3f} s, against the sequential sum {sum(witness_s) + sum(prove_s):.3f} s "
        f"(witnesses {', '.join(f'{x:.3f}' for x in witness_s)} s in the worker; proves "
        f"{', '.join(f'{x:.3f}' for x in prove_s)} s); each streamed proof == the sequential "
        f"prove of its witness, verify() accepts it, its public inputs are its pair's [{card}]")


# ---------------------------------------------------------------------------
# Phase 9: the in-circuit BLS12-381 aggregate, through the CLI's entry point
# ---------------------------------------------------------------------------

AGG_SLICES = 8
AGG_MODE = f"aggregate:slices={AGG_SLICES}"
# the JAX package's inner circuit at committee 512 in 8 slices with 184 wires
AGG_INNER_ROWS = 221_832
AGG_INNER_GATES = {"arith": 36_551, "basesum2": 179_864, "const": 9, "noop": 4_999,
                   "poseidon": 409}
AGG_SMALL_ROWS = 8_946  # the 2-member aggregate circuit, on 2^14
AGG_CHECKED_SLICE = 3


def check_small_aggregate(torch) -> None:
    """The 2-member aggregate circuit at the inner's widths (184 wires, 8 PoW
    bits, 12 queries): its proof on the kernels equals the one on the plain
    versions on the card, and verify accepts it."""
    from eth_lc_plonky2_tpu_torch.eth.synthetic import make_valid_pubkey
    from eth_lc_plonky2_tpu_torch.models import bls_aggregate as agg
    from eth_lc_plonky2_tpu_torch.prover import prove, serialize
    from eth_lc_plonky2_tpu_torch.prover.config import FriConfig

    rng = np.random.default_rng(2)
    keys = [make_valid_pubkey(rng) for _ in range(2)]
    data = agg.build_aggregate_bls_circuit(
        2, fri=FriConfig(proof_of_work_bits=8, num_query_rounds=12), num_wires=NUM_WIRES)
    if (data.num_rows_used, data.log_n) != (AGG_SMALL_ROWS, 14):
        fail(f"[9] the 2-member aggregate circuit has {data.num_rows_used} rows on 2^{data.log_n}")
    w = agg.aggregate_witness(data, bytes(range(32)), bytes(range(96)), keys, [1, 1])
    pd, vk = prove.preprocess(data)
    got = prove_kernels_and_plain(torch, pd, w, f"[9] the 2-member aggregate circuit "
                                  f"({AGG_SMALL_ROWS} of 2^14 rows)",
                                  ("ntt", "poseidon", "field", "gates"))
    check_proof(data, vk, serialize.proof_from_dict(got), w, "[9] the 2-member aggregate")


def check_aggregate_slice(torch, keep: dict, kw: dict, card: str) -> None:
    """One slice again: its witness holds host_aggregate of its 64 keys and bits
    as the constrained aggregate, its proof equals the CLI's byte for byte and
    passes verify, and a steady prove of the inner circuit launches its
    computed plan (no SHA-256 gate: two gate kernels)."""
    from eth_lc_plonky2_tpu_torch.circuit import gadgets_bls12_381 as g1
    from eth_lc_plonky2_tpu_torch.models import bls_aggregate as agg
    from eth_lc_plonky2_tpu_torch.prover import prove

    data, cli_proof, vk = keep["bls_inners"][AGG_CHECKED_SLICE]
    num_slices, size = data._agg_slice
    t0 = time.perf_counter()
    w = agg.aggregate_witness(data, kw["signing_root"], kw["signature"],
                              kw["sync_committee_pubkeys"], kw["sync_committee_bits"],
                              slice_index=AGG_CHECKED_SLICE)
    witness_s = time.perf_counter() - t0
    lo = AGG_CHECKED_SLICE * size
    agg_t = data._agg_inputs[4]
    want = agg.host_aggregate(kw["sync_committee_pubkeys"][lo:lo + size],
                              kw["sync_committee_bits"][lo:lo + size])
    if (g1.fq_value(w, agg_t.x), g1.fq_value(w, agg_t.y)) != want:
        fail(f"[9] slice {AGG_CHECKED_SLICE}'s constrained aggregate is not host_aggregate of its "
             "keys and bits")
    pd, vk2 = prove.preprocess(data)
    if not np.array_equal(vk2.pre_cap, vk.pre_cap):
        fail("[9] the inner circuit's preprocessed cap differs from the CLI's")
    proof, _ = first_prove(torch, "[9] inner", pd, w, card, PROVER_SOURCES)
    if (where := first_difference(proof_dict(proof), proof_dict(cli_proof))):
        fail(f"[9] slice {AGG_CHECKED_SLICE}'s proof differs from the CLI's at {where}")
    check_proof(data, vk, proof, w, f"[9] slice {AGG_CHECKED_SLICE} of {num_slices}")
    log(f"[9] slice {AGG_CHECKED_SLICE}: witness in {witness_s:.1f} s, its constrained aggregate "
        f"== host_aggregate of its {size} keys ({sum(map(int, kw['sync_committee_bits'][lo:lo + size]))}"
        f" bits set), its proof == the CLI's [{card}]")
    # the inner's own plan: of csrc/field.cu the fused kernels at its opening
    # points; of csrc/gates.cu the generic gates' and the Poseidon gate's
    field_plan = sum(n for name, n in fused_launch_plan(pd).items() if BY_SOURCE[name] == "field")
    profile_prove(torch, "[9] inner", pd, w, proof, card, field_plan, 2, timed=1)


def check_swapped_slices(keep: dict, kw: dict) -> None:
    """Slices 0 and 1's proofs swapped in the outer witness: each digest hashes
    its own [slice_index, num_slices], so witness generation must conflict or
    the proof fail verify (the Poseidon gate's batch generator writes its rows
    without a conflict check, so the digest's mismatch shows at verify's
    constraint identity)."""
    from eth_lc_plonky2_tpu_torch import cli
    from eth_lc_plonky2_tpu_torch.prover import prove
    from eth_lc_plonky2_tpu_torch.prover.verify import VerificationError, verify

    inners = list(keep["bls_inners"])
    inners[0], inners[1] = inners[1], inners[0]
    t0 = time.perf_counter()
    try:
        w = cli.light_client_witness(keep["data"], keep["target"], kw, keep["bls_targets"], inners)
    except ValueError as e:
        log(f"[9] slices 0 and 1 swapped in the outer witness: generation refuses it in "
            f"{time.perf_counter() - t0:.1f} s ({e})")
        return
    try:
        verify(keep["data"], keep["vk"], prove.prove(keep["pd"], w))
    except VerificationError as e:
        log(f"[9] slices 0 and 1 swapped: verify() rejects the proof ({e})")
        return
    fail("[9] the outer circuit accepts slices 0 and 1's proofs swapped")


def phase9(torch, card: str, seed: int) -> dict:
    """``cli.run`` at --synthetic 512 --bls aggregate:slices=8, nothing cut: the
    aggregate inner circuit built once and proved for each of the 8 slices with
    one preprocess, the outer circuit absorbing all 8, its witness, preprocess,
    a first prove, export and verify; then the bundle, one slice again, the
    swapped slices, a steady outer prove traced, and the 2-member aggregate on
    the kernels against the plain versions."""
    import tempfile

    from eth_lc_plonky2_tpu_torch import cli
    from eth_lc_plonky2_tpu_torch.eth.synthetic import make_synthetic_update_pair
    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import prove

    syn = make_synthetic_update_pair(FLAGSHIP_COMMITTEE, seed=seed, valid_pubkeys=True)
    kw = syn.witness_kwargs
    keep: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        bundle_path = os.path.join(tmp, "lc512_aggregate_bundle.json")
        # the main path: the counts are set to 0 just before the CLI's entry
        # point and read just after it
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        report = cli.run(kw, FLAGSHIP_COMMITTEE, syn.threshold, bls_mode=AGG_MODE,
                         export_bundle_path=bundle_path, out=CliLog("[9]"), keep=keep)
        torch.cuda.synchronize()
        launched = dict(kernels.launches)
        run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"[9] cli.run --synthetic {FLAGSHIP_COMMITTEE} --bls {AGG_MODE} --seed {seed} in "
            f"{run_s:.1f} s, launches {launched}, peak memory {peak_gb:.2f} GB: "
            f"{json.dumps(report)} [{card}]")
        check_sources_launched(launched, "[9] the main path")
        inner = keep["bls_inners"][0][0]
        inner_gates = {name: int(c) for name, c in zip(inner.gate_names, inner.selectors.sum(axis=1))}
        if len(keep["bls_inners"]) != AGG_SLICES or (inner.num_rows_used, inner.log_n) != (
                AGG_INNER_ROWS, LOG_N) or inner_gates != AGG_INNER_GATES:
            fail(f"[9] {len(keep['bls_inners'])} inner proofs of {inner.num_rows_used} rows on "
                 f"2^{inner.log_n}, gates {inner_gates}: not the JAX package's {AGG_SLICES} of "
                 f"{AGG_INNER_ROWS} on 2^{LOG_N}, {AGG_INNER_GATES}")
        if (report["cur_state"], report["new_state"]) != (syn.cur_state.hex(), syn.new_state.hex()):
            fail("[9] the public inputs are not the host SSZ contract_state_root of the pair")
        check_standalone(bundle_path, report, "[9]")
    data, witness, pd, vk, proof = (keep[k] for k in ("data", "witness", "pd", "vk", "proof"))
    log(f"[9] the inner circuit: {inner.config.num_wires} wires, {inner.num_rows_used} of "
        f"2^{inner.log_n} rows, gates {inner_gates} (the JAX package's), "
        f"{len(prove.opening_point_specs(inner))} opening points; the outer: "
        f"{data.config.num_wires} wires, {data.num_rows_used} of 2^{data.log_n} rows, gates "
        f"{report['gate_counts']}, {len(data.public_input_targets)} public inputs, "
        f"{len(prove.opening_point_specs(data))} opening points [{card}]")
    check_aggregate_slice(torch, keep, kw, card)
    check_swapped_slices(keep, kw)
    res = profile_prove(torch, "[9]", pd, witness, proof, card, LC_STEADY_FIELD_LAUNCHES, 3,
                        timed=1)
    log(f"[9] the outer prove {res['prove_ms']:.2f} ms (one timed steady prove) [{card}]")
    check_small_aggregate(torch)
    return {"launches": launched, "traced": res["by_name"]}


# ---------------------------------------------------------------------------
# Phase 10: the NTT past 2^22, and the sharded prover on the card
# ---------------------------------------------------------------------------

BIG_NTT_LOGS = (23, 24)
BIG_LDE_ROWS, BIG_LDE_LOG = 16, 21  # a commit chunk of 2^21 coefficients to a 2^24 LDE
DIST_NTT_LOGS = (10, 16, 21)
SHARDED_RANKS = 2  # two ranks share the one card over gloo
SHARDED_SEED = 10  # the seeded inputs of the (b) checks, the same on every rank
WINDOW_HALO = 16 << RATE_BITS  # the light-client circuit's: offset -16 at 2^3 columns a row
RANK_TIMEOUT_S = 900


def big_ntt_passes(torch, coeffs, card: str) -> dict:
    """The three passes of the (16, 2^21) -> 2^24 coset LDE, each kind timed
    alone (A one launch, B one a row, C one; device time) beside its bound."""
    from eth_lc_plonky2_tpu_torch.ops import kernels, ntt

    rows, n_in = coeffs.shape
    n = n_in << RATE_BITS
    out = torch.empty((rows, n), dtype=torch.int64, device=DEVICE)
    passes = ntt._passes(coeffs, out, False, in_tab=ntt._powers_on(7, n_in, DEVICE),
                         log_pad=RATE_BITS)
    kinds = {"A": passes[:1], "B": passes[1:-1], "C": passes[-1:]}
    if len(kinds["B"]) != rows:
        fail(f"[10] the 2^24 plan has {len(passes)} launches, not {rows + 2}")
    res = {}
    for kind, group in kinds.items():
        ms, _ = device_ms(torch, lambda g=group: [kernels.ntt_pass(s, d, **a) for s, d, a in g],
                          ("ntt_pass_kernel",), "ntt")
        log_m = group[0][2]["log_m"]
        stages = log_m - group[0][2].get("log_pad", 0)
        read = rows * (n_in if kind == "A" else n)
        # butterflies x one 64 x 64 product (4 multiply-adds), and the step
        # twiddle's two products a word (A and B)
        mads = rows * (n // 2) * stages * 4 + (rows * n * 2 * 4 if kind != "C" else 0)
        bound = bound_of((read + rows * n) * 8, mads)
        res[kind] = {"ms": ms, "launches": len(group), "log_m": log_m, "bound_ms": bound[0],
                     "bound_by": bound[1]}
    total = sum(r["ms"] for r in res.values())
    bound_total = sum(r["bound_ms"] for r in res.values())
    log(f"[10] the 2^24 LDE's passes: " + ", ".join(
        f"{k} (2^{r['log_m']}, {r['launches']} launch{'es' if r['launches'] > 1 else ''}) "
        f"{r['ms']:.3f} ms, bound {r['bound_ms']:.3f} ms by {r['bound_by']}"
        for k, r in res.items()) + f"; {total:.3f} ms against {bound_total:.3f} ms [{card}]")
    return {"passes": res, "ms": total, "bound_ms": bound_total}


def check_big_ntt(torch, chk: Checker, rng, card: str) -> dict:
    """Step 0 on the card: ntt and intt at 2^23 and 2^24 on 2 columns, and
    coset_lde of (16, 2^21) to 2^24 (three passes, the first reading the
    coefficients unpadded), against the plain versions on the card."""
    from eth_lc_plonky2_tpu_torch.ops import kernels, ntt

    before = kernels.launches["ntt"]
    for log_n in BIG_NTT_LOGS:
        x = device_rows(rng, 2, 1 << log_n, field_edge_words())
        chk.same("ntt", ntt.ntt(x), ntt.ntt_plain(x), f"[10] ntt of (2, 2^{log_n})")
        chk.same("ntt", ntt.intt(x), ntt.ntt_plain(x, inverse=True), f"[10] intt of (2, 2^{log_n})")
        del x
    if kernels.launches["ntt"] - before != 2 * len(BIG_NTT_LOGS) * (2 + 2):
        fail(f"[10] {kernels.launches['ntt'] - before} NTT launches for the 2-column transforms")
    coeffs = device_rows(rng, BIG_LDE_ROWS, 1 << BIG_LDE_LOG, field_edge_words())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lde = ntt.coset_lde(coeffs, RATE_BITS)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    chk.same("ntt", lde, ntt.coset_lde_plain(coeffs, RATE_BITS, 7),
             f"[10] coset_lde of ({BIG_LDE_ROWS}, 2^{BIG_LDE_LOG}) to 2^{BIG_LDE_LOG + RATE_BITS}")
    out_gb = lde.numel() * 8 / 1e9
    del lde
    torch.cuda.empty_cache()
    log(f"[10] ntt and intt of (2, 2^23) and (2, 2^24) and coset_lde of ({BIG_LDE_ROWS}, "
        f"2^{BIG_LDE_LOG}) to 2^24 == the plain versions on the card; that LDE's peak memory "
        f"{peak_gb:.2f} GB above its input (its output {out_gb:.2f} GB and one scratch) [{card}]")
    res = big_ntt_passes(torch, coeffs, card)
    res["peak_gb"] = peak_gb
    return res


def gathered(mesh, t, axis: int):
    """A point-sharded tensor's blocks, every rank's, joined in rank order."""
    import torch

    return torch.cat(list(mesh.all_gather(t)), dim=axis)


def check_sharded_steps(torch, chk: Checker, mesh, tag: str) -> dict:
    """On ``mesh``: make_dist_ntt (both ways) and make_dist_coset_lde equal the
    one-device ntt and coset_lde at log n 10, 16 and 21; make_sharded_commit
    equals commit_field_values at (184, 2^18) in the LDE, the leaves, every
    level's block and the cap; prove_sharded of the dryrun circuit equals
    assets/dryrun/ref_proof.json.  The inputs come from SHARDED_SEED, the same
    on every rank."""
    from eth_lc_plonky2_tpu_torch.ops import ntt
    from eth_lc_plonky2_tpu_torch.parallel import commit as pcommit, ntt as pntt, prover as pprover
    from eth_lc_plonky2_tpu_torch.prover import prove

    rng = np.random.default_rng(SHARDED_SEED)
    t0 = time.perf_counter()
    for log_n in DIST_NTT_LOGS:
        n = 1 << log_n
        x = device_rows(rng, 2, n, field_edge_words())
        block = x[:, mesh.block(n)]
        for inverse in (False, True):
            got = gathered(mesh, pntt.make_dist_ntt(mesh, n, inverse)(block), 1)
            chk.same("ntt", got, ntt.ntt(x, inverse=inverse), f"{tag} dist ntt 2^{log_n} {inverse}")
        got = gathered(mesh, pntt.make_dist_coset_lde(mesh, n, RATE_BITS)(block), 1)
        chk.same("ntt", got, ntt.coset_lde(x, RATE_BITS), f"{tag} dist coset_lde 2^{log_n}")
    values = device_rows(rng, NUM_WIRES, 1 << LOG_N)
    rows = pcommit.column_rows(mesh, NUM_WIRES)
    cb = len(rows) // mesh.size
    block = torch.zeros((cb, 1 << LOG_N), dtype=torch.int64, device=values.device)
    mine = [p for p in rows[mesh.rank * cb : (mesh.rank + 1) * cb] if p >= 0]
    block[: len(mine)] = values[mine[0] : mine[-1] + 1]
    batch, _ = pcommit.make_sharded_commit(mesh, RATE_BITS, CAP_HEIGHT)(block, rows)
    ref = prove.commit_field_values(values, RATE_BITS, CAP_HEIGHT)
    pts = mesh.block(ref.lde.shape[1])
    chk.same("ntt", batch.lde, ref.lde[:, pts], f"{tag} sharded commit: LDE")
    if len(batch.tree.levels) != len(ref.tree.levels):
        fail(f"{tag} sharded commit: {len(batch.tree.levels)} levels, not {len(ref.tree.levels)}")
    for k, (mine_lvl, whole) in enumerate(zip(batch.tree.levels, ref.tree.levels)):
        chk.same("poseidon", mine_lvl, whole[mesh.block(whole.shape[0])],
                 f"{tag} sharded commit: level {k}")
    if not np.array_equal(batch.cap, ref.cap):
        fail(f"{tag} sharded commit: the cap differs")
    del values, block, batch, ref
    data, w = dryrun_circuit()
    pd, _ = prove.preprocess(data, device=DEVICE)
    got = proof_dict(pprover.prove_sharded(pd, w, mesh))
    with open(os.path.join(REPO, "assets", "dryrun", "ref_proof.json")) as f:
        text = f.read()
    if (where := first_difference(got, json.loads(text))) or json.dumps(got) != text:
        fail(f"{tag} prove_sharded of the dryrun circuit differs from ref_proof.json at {where}")
    torch.cuda.synchronize()
    log(f"{tag} {mesh}: make_dist_ntt (forward and inverse) and make_dist_coset_lde == ntt and "
        f"coset_lde at log n {DIST_NTT_LOGS}; make_sharded_commit == commit_field_values at "
        f"({NUM_WIRES}, 2^{LOG_N}) (LDE, leaves, every level's block, cap); prove_sharded of the "
        f"dryrun circuit == assets/dryrun/ref_proof.json byte for byte, in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"seconds": time.perf_counter() - t0}


def windows_of(t, lo: int, width: int, halo: int):
    """The columns [lo - halo, lo + width + halo) mod n_lde of (rows, n_lde) ``t``."""
    import torch

    n_lde = t.shape[-1]
    cols = torch.arange(lo - halo, lo + width + halo, device=t.device) % n_lde
    return t.index_select(t.dim() - 1, cols)


def check_window_kernels(torch, chk: Checker, rng, rank: int, size: int, tag: str) -> dict:
    """The window form of the four quotient kernels on rank ``rank``'s points
    of ``size``: each kernel on the middle of its window against the plain
    version (the existing eager code) run on the whole window and cut to the
    middle.  The gates at phase 7's sizes, the permutation terms and the
    generic share at (184, 2^21)."""
    from eth_lc_plonky2_tpu_torch.circuit.gates_poseidon import PoseidonGate
    from eth_lc_plonky2_tpu_torch.circuit.gates_sha256 import Sha256RoundGate
    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.prover import prove

    h = WINDOW_HALO
    t0 = time.perf_counter()
    for gate in (Sha256RoundGate(), PoseidonGate()):
        for n_lde in GATE_SIZES:
            width = n_lde // size
            lo = rank * width
            wires, consts, sel, apow_rows, accs = gate_inputs(rng, n_lde, gate.num_constraints)
            ww, cw, sw = (windows_of(t, lo, width, h) for t in (wires, consts, sel))
            acc_w = [windows_of(a, lo, width, h) for a in accs]
            mine = [a[lo : lo + width].clone() for a in accs]
            got = gate.absorb_quotient_device(ww[:, h : h + width], lambda i: cw[i, h : h + width],
                                              sw[h : h + width], apow_rows, mine, RATE_BITS,
                                              window=True)
            want = gate_generic(gate, (ww, cw, sw, apow_rows, acc_w), RATE_BITS, plain=True)
            for j in range(2):
                chk.same("gates", got[j], want[j][h : h + width],
                         f"{tag} {gate.name} window form, n_lde {n_lde}, rank {rank} of {size}")
    n_lde = 1 << (LOG_N + RATE_BITS)
    width = n_lde // size
    lo = rank * width
    inp = perm_inputs(rng, LOG_N + RATE_BITS)
    w_all, sigma, zs, x, l0 = (windows_of(t, lo, width, h) for t in inp[:5])
    rest = inp[5:]
    got = kernels.perm_quotient(w_all[:, h : h + width], sigma[:, h : h + width],
                                zs[:, h : h + width], x[h : h + width], l0[h : h + width], *rest,
                                window=True)
    want = torch.stack(on_plain(lambda: prove.perm_quotient_terms_plain(w_all, sigma, zs, x, l0,
                                                                       *rest)))
    chk.same("field", got, want[:, h : h + width], f"{tag} perm_quotient window form, rank {rank}")
    del inp, w_all, sigma, zs, x, l0, got, want
    gen = generic_inputs(rng, n_lde)
    win = dict(gen, wires=windows_of(gen["wires"], lo, width, h), pre=windows_of(gen["pre"], lo, width, h),
               lr=windows_of(gen["lr"], lo, width, h),
               accs=[windows_of(a, lo, width, h) for a in gen["accs"]])
    want = generic_terms(win, "plain")[:, h : h + width]
    mine = [a[lo : lo + width].clone() for a in gen["accs"]]
    kernels.generic_gate_quotient(gen["generic"], win["wires"][:, h : h + width],
                                  win["pre"][:, h : h + width], gen["num_sel"], gen["num_con"],
                                  win["lr"][:, h : h + width], gen["pi"], gen["pi_cols"],
                                  gen["apows"], mine, gen["pi0"], gen["k0"])
    chk.same("gates", torch.stack(mine), want, f"{tag} generic gates window form, rank {rank}")
    torch.cuda.synchronize()
    log(f"{tag} rank {rank} of {size}: the window form of the SHA-256 and Poseidon gate kernels "
        f"(n_lde {GATE_SIZES}), perm_quotient_kernel and generic_gate_quotient_kernel (2^{LOG_N + RATE_BITS}) on "
        f"this rank's window (halo {h}) == the plain versions on the window, cut to the middle, "
        f"in {time.perf_counter() - t0:.1f} s")
    return {"seconds": time.perf_counter() - t0}


def measure_window_kernels(torch, rng, card: str, size: int = SHARDED_RANKS) -> dict:
    """The four quotient kernels' window form at the flagship's shapes on rank
    0's window of a 2^21 domain split ``size`` ways, each timed beside its
    one-device form on the whole domain in the same call (device time, both)
    and beside its bound for the window's columns (the same rows a column as
    phase 7's)."""
    from eth_lc_plonky2_tpu_torch.circuit.gates_poseidon import PoseidonGate
    from eth_lc_plonky2_tpu_torch.circuit.gates_sha256 import Sha256RoundGate
    from eth_lc_plonky2_tpu_torch.ops import kernels

    h, n_lde = WINDOW_HALO, 1 << (LOG_N + RATE_BITS)
    width = n_lde // size
    mid = slice(h, h + width)
    out = {}

    def record(name, window_ms, whole_ms, rows, mads):
        bound = bound_of(rows * width * 8, mads * width)
        out[name] = {"ms": window_ms, "whole_ms": whole_ms, "bound_ms": bound[0],
                     "bound_by": bound[1]}

    for gate, name, rows, mads in (
            (Sha256RoundGate(), "sha_gate_quotient_kernel", SHA_GATE_ROWS, SHA_GATE_MADS),
            (PoseidonGate(), "poseidon_gate_quotient_kernel", 142 + 1 + 2 + 2,
             POSEIDON_GATE_MADS)):
        inputs = gate_inputs(rng, n_lde, gate.num_constraints)
        wires, consts, sel, apow_rows, accs = inputs
        ww, cw, sw = (windows_of(t, 0, width, h) for t in (wires, consts, sel))
        mine = [a[:width].clone() for a in accs]
        window_ms, _ = device_ms(torch, lambda: gate.absorb_quotient_device(
            ww[:, mid], lambda i: cw[i, mid], sw[mid], apow_rows, mine, RATE_BITS, window=True),
            (name,), "gates")
        scratch = [a.clone() for a in accs]
        whole_ms, _ = device_ms(torch, lambda: gate_kernel(gate, inputs, RATE_BITS, scratch),
                                (name,), "gates")
        record(name, window_ms, whole_ms, rows, mads)
        del inputs, wires, ww, cw, sw, mine, scratch
    inp = perm_inputs(rng, LOG_N + RATE_BITS)
    w_all, sigma, zs, x, l0 = (windows_of(t, 0, width, h) for t in inp[:5])
    window_ms, _ = device_ms(torch, lambda: kernels.perm_quotient(
        w_all[:, mid], sigma[:, mid], zs[:, mid], x[mid], l0[mid], *inp[5:], window=True),
        ("perm_quotient_kernel",), "field")
    whole_ms, _ = device_ms(torch, lambda: perm_terms(inp), ("perm_quotient_kernel",), "field")
    record("perm_quotient_kernel", window_ms, whole_ms, 2 * NUM_ROUTED + NUM_Z + 2 + 2,
           PERM_MADS_PER_COLUMN)
    del inp, w_all, sigma, zs, x, l0
    gen = generic_inputs(rng, n_lde)
    ww, pw, lw = (windows_of(gen[k], 0, width, h) for k in ("wires", "pre", "lr"))
    mine = [a[:width].clone() for a in gen["accs"]]
    window_ms, _ = device_ms(torch, lambda: kernels.generic_gate_quotient(
        gen["generic"], ww[:, mid], pw[:, mid], gen["num_sel"], gen["num_con"], lw[:, mid],
        gen["pi"], gen["pi_cols"], gen["apows"], mine, gen["pi0"], gen["k0"]),
        ("generic_gate_quotient_kernel",), "gates")
    whole_ms, _ = device_ms(torch, lambda: generic_terms(gen), ("generic_gate_quotient_kernel",),
                            "gates")
    record("generic_gate_quotient_kernel", window_ms, whole_ms, GENERIC_ROWS,
           GENERIC_MADS_PER_COLUMN)
    log(f"[7] the window form on rank 0's {width} points of 2^{LOG_N + RATE_BITS} (halo {h}): "
        + ", ".join(f"{k} {v['ms']:.3f} ms (bound {v['bound_ms']:.4f} ms by {v['bound_by']}; the "
                    f"whole domain's one-device form {v['whole_ms']:.3f} ms)" for k, v in out.items())
        + f" [{card}]")
    return out


def measure_quotient_kernels(torch, rng, card: str) -> dict:
    """The permutation terms' and the generic share's kernels at (80, 2^21)
    and (184, 2^21), one device, their device time (tools/torch_kernel_times.py
    holds them against an older checkout in turns, so it makes only calls
    that the port has had since it gained the generic gates' kernel)."""
    inp = perm_inputs(rng, LOG_N + RATE_BITS)
    perm_ms, _ = device_ms(torch, lambda: perm_terms(inp), ("perm_quotient_kernel",), "field")
    del inp
    gen = generic_inputs(rng, 1 << (LOG_N + RATE_BITS))
    generic_ms, _ = device_ms(torch, lambda: generic_terms(gen), ("generic_gate_quotient_kernel",),
                              "gates")
    log(f"the quotient's kernels at 2^{LOG_N + RATE_BITS}: perm_quotient_kernel {perm_ms:.3f} ms, "
        f"generic_gate_quotient_kernel {generic_ms:.3f} ms [{card}]")
    return {"perm_quotient_kernel": perm_ms, "generic_gate_quotient_kernel": generic_ms}


def measure_open_and_g(torch, rng, card: str) -> dict:
    """The openings of phase 7's four batches at 2^18 and G at 2^21 with 12
    specs, one device, their device time (tools/torch_kernel_times.py holds them
    against an older checkout in turns: a checkout without
    ``prove.open_batches`` opens batch by batch through ``prove._open_core``,
    which every version of the package has)."""
    from eth_lc_plonky2_tpu_torch.prover import prove

    inp = opening_inputs(rng, LOG_N)
    if hasattr(prove, "open_batches"):
        def run():
            return open_all(inp)
    else:
        idx = [torch.tensor(r, device=DEVICE) for r in inp["rows"]]

        def run():
            return [prove._open_core(c, inp["z_re"][i], inp["z_im"][i])
                    for c, i in zip(inp["coeffs"], idx)]
    open_ms, _ = device_ms(torch, run, TRACED_AS["field_open_kernel"], "field")
    del inp
    g = g_inputs(rng, LOG_N + RATE_BITS, 12)
    g_ms, _ = device_ms(torch, lambda: g_terms(g), ("fri_g_kernel",), "field")
    log(f"the openings at 2^{LOG_N} (four batches, 12 points) {open_ms:.3f} ms, fri_g_kernel at "
        f"2^{LOG_N + RATE_BITS} (12 specs) {g_ms:.3f} ms [{card}]")
    return {"field_open_kernel": open_ms, "fri_g_kernel": g_ms}


def sharded_flagship(torch, mesh, cache_dir: str, seed: int, tag: str) -> dict:
    """The flagship proved by the ranks of ``mesh``: cli.run --synthetic 512
    --bls dummy --seed N with skip_prove loads phase 8's circuit from the
    cache and makes the witness; the rank's shard, a first prove (the main
    path of this phase: its launches), a timed prove with its phase marks,
    and the port's verify.  Returns both proofs as JSON and the numbers."""
    import io

    from eth_lc_plonky2_tpu_torch import cli
    from eth_lc_plonky2_tpu_torch.eth.synthetic import make_synthetic_update_pair
    from eth_lc_plonky2_tpu_torch.ops import kernels
    from eth_lc_plonky2_tpu_torch.parallel import prover as pprover
    from eth_lc_plonky2_tpu_torch.prover.profiler import Profiler
    from eth_lc_plonky2_tpu_torch.prover.verify import verify

    t0 = time.perf_counter()
    syn = make_synthetic_update_pair(FLAGSHIP_COMMITTEE, seed=seed)
    keep: dict = {}
    report = cli.run(syn.witness_kwargs, FLAGSHIP_COMMITTEE, syn.threshold, bls_mode="dummy",
                     cache_dir=cache_dir, skip_prove=True, out=io.StringIO(), keep=keep)
    if report.get("cache") != "hit" or "pd" not in keep:
        fail(f"{tag} rank {mesh.rank}: phase 8's circuit is not in the cache")
    setup_s = time.perf_counter() - t0
    shard = pprover.shard_prover_data(keep.pop("pd"), mesh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.distributed.barrier()
    # the main path of this phase: the counts are set to 0 just before it
    kernels.reset_launches()
    t1 = time.perf_counter()
    first = pprover.prove_sharded(shard, keep["witness"], mesh)
    torch.cuda.synchronize()
    launched = dict(kernels.launches)
    first_s = time.perf_counter() - t1
    torch.distributed.barrier()
    prof = Profiler(enabled=True)
    t1 = time.perf_counter()
    proof = pprover.prove_sharded(shard, keep["witness"], mesh, prof=prof)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t1
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t1 = time.perf_counter()
    verify(keep["data"], keep["vk"], proof)
    verify_s = time.perf_counter() - t1
    return {"first": json.dumps(proof_dict(first)), "proof": json.dumps(proof_dict(proof)),
            "launches": launched, "first_s": first_s, "wall_s": wall_s, "verify_s": verify_s,
            "setup_s": setup_s, "peak_gb": peak_gb,
            "phases": {k: v for k, v in prof.times.items() if not k.startswith("_")},
            "sync_wait_s": prof.times[SYNC_WAIT],
            "rows": (keep["data"].num_rows_used, keep["data"].log_n)}


def phase10_rank(rank: int, size: int, store: str, cache_dir: str, seed: int, queue) -> None:
    """One of the ranks that share the card: (b)'s checks, the window form on
    this rank's window, and the sharded flagship; its results on ``queue``.
    Any exception ends the process with a non-zero code."""
    import torch

    from eth_lc_plonky2_tpu_torch.parallel import distributed as dist

    tag = f"[10c:{rank}]"
    dist.initialize("file://" + store, size, rank, device="cuda:0", backend="gloo")
    mesh = dist.make_global_mesh()
    chk = Checker()
    out = {"mesh": repr(mesh)}
    out["steps"] = check_sharded_steps(torch, chk, mesh, tag)
    out["windows"] = check_window_kernels(torch, chk, np.random.default_rng(seed + 100 + rank),
                                          rank, size, tag)
    out["flagship"] = sharded_flagship(torch, mesh, cache_dir, seed, tag)
    out["err"] = chk.err
    queue.put((rank, out))
    dist.shutdown()


def phase10(torch, chk: Checker, rng, card: str, seed: int, flagship: dict) -> dict:
    """(a) the NTT past 2^22; (b) one rank over NCCL in this process; (c) two
    ranks sharing the card over gloo, the flagship among their checks."""
    import tempfile

    import torch.distributed as tdist

    from eth_lc_plonky2_tpu_torch.parallel import distributed as dist

    big = check_big_ntt(torch, chk, rng, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        # (c)'s ranks start first: (b) runs here while they set up, before
        # their timed proves
        t0 = time.perf_counter()
        procs, q = dist.spawn_ranks(phase10_rank, SHARDED_RANKS,
                                    (os.path.join(tmp, "ranks"), flagship["cache_dir"], seed))
        try:
            dist.initialize("file://" + os.path.join(tmp, "store"), 1, 0)  # NCCL on the card
            mesh = dist.make_global_mesh()
            if mesh.backend != "nccl" or tdist.get_world_size() != 1:
                fail(f"[10b] {mesh}: not one rank over NCCL")
            check_sharded_steps(torch, chk, mesh, "[10b]")
            dist.shutdown()
            torch.cuda.empty_cache()
        except BaseException:
            for p in procs:
                p.kill()
                p.join()
            raise
        try:
            ranks = dist.collect_ranks(procs, q, RANK_TIMEOUT_S)
        except RuntimeError as e:
            fail(f"[10c] {e}")
        ranks_s = time.perf_counter() - t0
    want = flagship["proof"]
    for r, out in sorted(ranks.items()):
        res = out["flagship"]
        if res["rows"] != (FLAGSHIP_ROWS_USED, LOG_N):
            fail(f"[10c] rank {r}: the cached circuit has {res['rows']} rows")
        for key in ("first", "proof"):
            if res[key] != want:
                where = first_difference(json.loads(res[key]), json.loads(want))
                fail(f"[10c] rank {r}'s sharded proof ({key}) differs from phase 8's at {where}")
        check_sources_launched(res["launches"], f"[10c] rank {r}'s sharded prove")
        for kernel, e in out["err"].items():
            chk.err[kernel] = max(chk.err[kernel], e)
    walls = [ranks[r]["flagship"]["wall_s"] for r in sorted(ranks)]
    log(f"[10c] two ranks sharing one {card} over gloo (no multi-GPU figure): the flagship "
        f"(--synthetic {FLAGSHIP_COMMITTEE} --bls dummy --seed {seed}) proved by prove_sharded == "
        f"phase 8's proof byte for byte on both ranks, accepted by verify; launches "
        f"{[ranks[r]['flagship']['launches'] for r in sorted(ranks)]}")
    log(json.dumps({"sharded_prove": {
        "label": f"two ranks sharing one card ({card}) over gloo, not a multi-GPU figure",
        "ranks": SHARDED_RANKS, "wall_s": walls,
        "first_prove_s": [ranks[r]["flagship"]["first_s"] for r in sorted(ranks)],
        "verify_s": [ranks[r]["flagship"]["verify_s"] for r in sorted(ranks)],
        "setup_s": [ranks[r]["flagship"]["setup_s"] for r in sorted(ranks)],
        "peak_gb": [ranks[r]["flagship"]["peak_gb"] for r in sorted(ranks)],
        "phases_s": [ranks[r]["flagship"]["phases"] for r in sorted(ranks)],
        "sync_wait_s": [ranks[r]["flagship"]["sync_wait_s"] for r in sorted(ranks)],
        "ranks_s": ranks_s, "big_ntt": big}}))
    return {"big_ntt": big, "walls": walls}


def measure_flagship(torch, card: str, seed: int = 0) -> dict:
    """The flagship's entry for timing two checkouts in turns
    (tools/torch_kernel_times.py --flagship): cli.run --synthetic 512 --bls
    dummy with skip_prove (the inner proof, build and witness), then
    preprocess, a first prove and three timed proves; their median is
    full512_prove_wall_s."""
    import io

    from eth_lc_plonky2_tpu_torch import cli
    from eth_lc_plonky2_tpu_torch.eth.synthetic import make_synthetic_update_pair
    from eth_lc_plonky2_tpu_torch.prover import prove

    syn = make_synthetic_update_pair(FLAGSHIP_COMMITTEE, seed=seed)
    keep: dict = {}
    report = cli.run(syn.witness_kwargs, FLAGSHIP_COMMITTEE, syn.threshold, bls_mode="dummy",
                     skip_prove=True, out=io.StringIO(), keep=keep)
    t0 = time.perf_counter()
    pd, _ = prove.preprocess(keep["data"])
    torch.cuda.synchronize()
    preprocess_s = time.perf_counter() - t0
    runs = []
    for _ in range(4):  # the first makes the per-circuit tables
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prove.prove(pd, keep["witness"])
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    wall = statistics.median(runs[1:])
    log(f"flagship: full512_prove_wall_s {wall:.5f} (median of {runs[1:]}), first prove "
        f"{runs[0]:.3f} s, preprocess {preprocess_s:.3f} s, {json.dumps(report)} [{card}]")
    return {"full512_prove_wall_s": wall, "first_prove_s": runs[0], "preprocess_s": preprocess_s,
            **{k: report[k] for k in ("bls_inner_prove_s", "build_s", "witness_s", "rows_used")}}


# the trace's kernel names that one entry of the kernels line stands for
TRACED_AS = {"field_open_kernel": ("field_open_table_kernel", "field_open_kernel",
                                   "field_open_sum_kernel"),
             "perm_z_kernel": PERM_ROWS_KERNELS}


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
    sha = timed(2, phase2, torch, chk, rng, card)
    timed(3, phase3, torch)
    res = timed(4, phase4, torch, chk, rng, card)
    timed(5, phase5, torch)
    whole = timed(6, phase6, torch, chk, rng, card, args.seed)
    lc = timed(7, phase7, torch, chk, rng, card, args.seed)
    import tempfile

    with tempfile.TemporaryDirectory() as cache_dir:
        flagship = timed(8, phase8, torch, card, args.seed, cache_dir)
        aggregate = timed(9, phase9, torch, card, args.seed)
        timed(10, phase10, torch, chk, rng, card, args.seed, flagship)
    # the launches are those of the newest main path, phase 9's cli.run (the
    # eight inner proofs, preprocess and the first outer proof: every kernel
    # source); phases 4, 6, 7 and 8 have held their own above
    launches = aggregate["launches"]
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
    # each kernel's launches are those of phase 9's traced steady prove of the
    # outer circuit (the inverse's are 0 there: it runs in the first prove, for
    # the circuit's tables); the openings' entry times field_open_kernel with
    # its power table and column-slice sums, the permutation rows' perm_z_kernel with its scan
    # and fix-up
    for name, part in {**field_parts, **gate_parts}.items():
        part["launches"] = sum(aggregate["traced"].get(k, {}).get("launches", 0)
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
         **summed(field_parts), "library_ms": None, "by_kernel": field_parts,
         # FRI's 13 folds of one steady outer prove, device time from phase 9's trace
         "fri_folds_traced_ms": aggregate["traced"].get("fri_fold_kernel", {}).get("ms")},
        # one source, three kernels, one launch each a proof: the times are the
        # three kernels' at (184, 2^21) added up, and "by_kernel" has each alone
        {"name": "gates", "route": "cuda", "source": "eth_lc_plonky2_tpu_torch/csrc/gates.cu",
         "replaces": "eth_lc_plonky2_tpu/circuit/gates_sha256.py:223, "
                     "eth_lc_plonky2_tpu/circuit/gates_poseidon.py:133 and "
                     "eth_lc_plonky2_tpu/prover/prove.py:484-520 (XLA-fused, no Pallas kernel)",
         "launches": launches["gates"], "max_abs_err": chk.err["gates"],
         **summed(gate_parts), "library_ms": None, "by_kernel": gate_parts},
        # no prove launches it (launches: phase 9's, 0); its two kernels at
        # 2^20 messages added up, "by_kernel" each alone
        {"name": "sha256", "route": "cuda", "source": "eth_lc_plonky2_tpu_torch/csrc/sha256.cu",
         "replaces": "eth_lc_plonky2_tpu/ops/sha256.py:174, :211 (jitted jnp, no Pallas kernel)",
         "launches": launches["sha256"], "phase2_launches": sha["launches"],
         "max_abs_err": chk.err["sha256"], **summed(sha["by_kernel"]), "library_ms": None,
         "by_kernel": sha["by_kernel"]},
    ]}
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
