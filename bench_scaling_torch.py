#!/usr/bin/env python3
"""Scaling of the port's sharded prover and distributed NTT at 1, 2 and 4
ranks: the counterpart of bench_scaling.py (which stays: its child imports
jax).

    python3 bench_scaling_torch.py [--ranks 1,2,4] [--log-rows 12] [--log-n 16]
                                   [--reps 3] [--device cuda|cpu]

One process a rank (torch.multiprocessing, spawned), joined through a
FileStore in a temporary directory.  On the card, rank r takes card r mod
the card count: where there are fewer cards than ranks, ranks share cards,
and then the group runs over gloo with the exchanged tensors staged through
host memory (NCCL takes one rank a card); otherwise over NCCL.  Each rank
count builds bench_scaling.py's circuit (16 wires, arithmetic rows up to
2^log_rows), preprocesses it, proves once to warm up and then ``reps`` times
with ``prove_sharded`` (checking the proof against the one-device ``prove``
and ``verify``), and times ``make_dist_ntt`` of one 2^log_n row.  One JSON
line a rank count on stdout, naming the card, its power limit and how many
ranks shared a card: two ranks on one card are no multi-GPU figure.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

RANK_TIMEOUT_S = 1800  # for one rank count's set-up, warm-up and timed runs


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "not measured"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not measured"


def bench_circuit(log_rows: int):
    """bench_scaling.py's circuit: 16 wires, x -> x * acc + x to 2^log_rows - 8 rows."""
    from eth_lc_plonky2_tpu_torch.circuit.builder import CircuitBuilder
    from eth_lc_plonky2_tpu_torch.prover.config import CircuitConfig, FriConfig

    cfg = CircuitConfig(num_wires=16, num_routed_wires=16, num_constants=2,
                        permutation_chunk_size=2,
                        fri=FriConfig(cap_height=4, proof_of_work_bits=8, num_query_rounds=12))
    b = CircuitBuilder(cfg)
    x = b.add_virtual_target()
    acc = x
    while len(b.rows) < (1 << log_rows) - 8:
        acc = b.mul_add(acc, x, x)
    b.register_public_input(acc)
    data = b.build()
    w = data.new_witness()
    w.set(x, 1)
    w.generate()
    return data, w


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rank_main(rank: int, size: int, store: str, args, queue) -> None:
    import numpy as np
    import torch
    import torch.distributed

    from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
    from eth_lc_plonky2_tpu_torch.parallel import distributed as dist
    from eth_lc_plonky2_tpu_torch.parallel.ntt import make_dist_ntt
    from eth_lc_plonky2_tpu_torch.parallel.prover import prove_sharded, shard_prover_data
    from eth_lc_plonky2_tpu_torch.prover import prove as pr
    from eth_lc_plonky2_tpu_torch.prover import serialize
    from eth_lc_plonky2_tpu_torch.prover.verify import verify

    if args.device == "cuda":
        cards = torch.cuda.device_count()
        device = f"cuda:{rank % cards}"
        backend = "nccl" if size <= cards else "gloo"
    else:
        device, backend = "cpu", "gloo"
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    dist.initialize("file://" + store, size, rank, device=device, backend=backend)
    mesh = dist.make_global_mesh()
    dev = mesh.device
    out = {"ranks": size, "rank": rank, "backend": backend, "device": str(dev)}
    data, w = bench_circuit(args.log_rows)
    pd, vk = pr.preprocess(data, device=str(dev))
    want = serialize.proof_to_dict(pr.prove(pd, w), include_indices=True)
    shard = shard_prover_data(pd, mesh)
    del pd
    proof = prove_sharded(shard, w, mesh)  # warm-up: the per-circuit tables
    if serialize.proof_to_dict(proof, include_indices=True) != want:
        raise AssertionError("the sharded proof differs from the one-device proof")
    verify(data, vk, proof)
    walls = []
    for _ in range(args.reps):
        torch.distributed.barrier()
        _sync(torch, dev)
        t0 = time.perf_counter()
        prove_sharded(shard, w, mesh)
        _sync(torch, dev)
        walls.append(time.perf_counter() - t0)
    out["prove_s"] = statistics.median(walls)
    out["prove_runs_s"] = walls
    n = 1 << args.log_n
    vals = np.random.default_rng(7).integers(0, gl.P, size=(1, n), dtype=np.uint64)
    block = gl.from_u64(vals[:, mesh.block(n)], dev)
    fn = make_dist_ntt(mesh, n)
    fn(block)
    torch.distributed.barrier()
    _sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        fn(block)
    _sync(torch, dev)
    out["dist_ntt_ms"] = (time.perf_counter() - t0) / args.reps * 1e3
    queue.put((rank, out))
    dist.shutdown()


def run(size: int, args) -> list:
    """Every rank's results, in rank order; a rank that fails ends the bench."""
    from eth_lc_plonky2_tpu_torch.parallel import distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        procs, queue = dist.spawn_ranks(rank_main, size, (os.path.join(tmp, "store"), args))
        try:
            results = dist.collect_ranks(procs, queue, RANK_TIMEOUT_S)
        except RuntimeError as e:
            raise SystemExit(f"{size} ranks: {e}") from None
    return [results[r] for r in range(size)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--log-rows", type=int, default=12)
    ap.add_argument("--log-n", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (--device cpu runs the ranks on the CPU)")
    card = card_line() if args.device == "cuda" else "cpu"
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    for size in (int(s) for s in args.ranks.split(",")):
        per_rank = run(size, args)
        shared = -(-size // cards) if cards else size
        print(json.dumps({
            "ranks": size, "card": card, "cards": cards, "ranks_per_card": shared,
            "backend": per_rank[0]["backend"], "log_rows": args.log_rows, "log_n": args.log_n,
            "prove_s": max(o["prove_s"] for o in per_rank),
            "dist_ntt_ms": max(o["dist_ntt_ms"] for o in per_rank),
            "per_rank": per_rank}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
