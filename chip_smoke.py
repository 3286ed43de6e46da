#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's polynomial commitment on one GPU, and check it.

    python3 chip_smoke.py [--seed N]

Phases (any mismatch or exception exits non-zero without the ok line):
  0. device facts: card name and power limit, torch, nvcc, GPU count;
  1. build both kernels from eth_lc_plonky2_tpu_torch/csrc with nvcc (sm_90a);
  2. each kernel against its plain PyTorch version on the card, bit for bit:
     the NTT (forward, inverse, coset; the LDE reads its coefficients without
     padding them) at log n in 1..14, 16, 18, 21, the Poseidon sponge at L in
     {8, 16, 20, 184}, N in {1, 511, 512, 2049, 4097}, Merkle levels, and
     whole trees of 2^4, 2^5, 2^11 and 2^12 leaves at cap heights 0 and 4
     (the one-launch tail of a tree);
  3. commit_values on assets/dryrun/pre.npz must reproduce its stored
     coefficients, LDE and every Merkle level;
  4. one proof's three commitments at the flagship width (CircuitConfig
     num_wires=184 on a 2^18 domain, rate 2^3, cap height 4): wires and Z
     from values, the quotient from coefficients, with seeded data; launch
     counts, subset checks against the plain versions, Merkle paths
     verified against the cap, timings, and a torch.profiler split by kernel
     name whose launch counts must be the plan's (leaves, levels, tail, NTT
     passes).
The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel with its launches on the main path, its error against the plain
version, and its time beside the plain version's and beside the least time
the card could take (bound_ms: the larger of bytes over 3.35 TB/s and 32-bit
integer multiply-adds, counted in the cheapest form known, over 16.75 T/s).
No PyTorch call computes either function, so library_ms is null.

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
SPONGE_LS = (8, 16, 20, 184)
SPONGE_NS = (1, 511, 512, 2049, 4097)
TREE_LEAVES = (1 << 4, 1 << 5, 1 << 11, 1 << 12)
TREE_CAPS = (0, 4)
DEVICE = "cuda"

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
        self.err = {"ntt": 0.0, "poseidon": 0.0}

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
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                fail(f"a kernel spills registers: {line.strip()}")


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
    for name, count in launched.items():
        if count <= 0:
            fail(f"the main path never launched the {name} kernel")

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
    if launched != {"ntt": expected["ntt_pass_kernel"],
                    "poseidon": sum(expected.values()) - expected["ntt_pass_kernel"]}:
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

    # The least time the card could take (each input read once, each output
    # written once; the multiply-adds the algorithm needs).
    def bound(nbytes, mads):
        by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S * 1e3, mads / PEAK_INT32_MADS_PER_S * 1e3
        return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"

    ntt_bound = bound((chunk * n + chunk * n_lde) * 8,
                      chunk * (n_lde // 2) * (LOG_N + RATE_BITS) * 4)  # butterflies x (64 x 64 product)
    level_bound = bound((2 * n * 4 + n * 4) * 8, n * MADS_PER_PERMUTATION)
    leaf_bound = bound(NUM_WIRES * n_lde * 8 + n_lde * 32,
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    import eth_lc_plonky2_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = phase0(torch)
    phase1()
    rng = np.random.default_rng(args.seed)
    chk = Checker()
    phase2(torch, chk, rng)
    phase3(torch)
    res = phase4(torch, chk, rng, card)
    kernels_line = {"kernels": [
        {"name": "ntt", "route": "cuda", "source": "eth_lc_plonky2_tpu_torch/csrc/ntt.cu",
         "replaces": "eth_lc_plonky2_tpu/ops/pallas/ntt_mxu.py:165",
         "launches": res["launches"]["ntt"], "max_abs_err": chk.err["ntt"],
         "ms": res["ntt"][0], "plain_ms": res["ntt"][1], "bound_ms": res["ntt"][2],
         "bound_by": res["ntt"][3], "library_ms": None},
        {"name": "poseidon", "route": "cuda",
         "source": "eth_lc_plonky2_tpu_torch/csrc/poseidon.cu",
         "replaces": "eth_lc_plonky2_tpu/ops/pallas/poseidon_pallas.py:114",
         "launches": res["launches"]["poseidon"], "max_abs_err": chk.err["poseidon"],
         "ms": res["poseidon"][0], "plain_ms": res["poseidon"][1],
         "bound_ms": res["poseidon"][2], "bound_by": res["poseidon"][3], "library_ms": None},
    ]}
    print(card_line(), flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
