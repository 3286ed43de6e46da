#!/usr/bin/env python3
"""Time two checkouts of the PyTorch/CUDA port in turns on one GPU.

    python3 tools/torch_kernel_times.py --parent DIR     # DIR, here, here, DIR

``DIR`` is a second checkout of the repo (e.g. ``git archive`` of an older
commit unpacked into a gitignored directory).  Each turn is a process of its
own with that tree's package first on ``sys.path``, so both versions meet the
same card under the same power limit.  The measurement is ``chip_smoke.py``'s
own (``measure``: one proof's three commitments at the flagship width, each
kernel at one main-path shape, and the ``torch.profiler`` split by kernel
name; then ``measure_gate_kernels``: the SHA-256 and Poseidon gates' kernels
at (184, 2^21) against the generic loop; then ``measure_perm_polys``: the
permutation rows of both challenges at (80, 2^18) through
``prove.compute_permutation_polys``; then ``measure_quotient_kernels``: the
permutation terms' and the generic share's kernels at 2^21; then
``measure_open_and_g``: the openings of phase 7's four batches at 2^18 and
FRI's G at 2^21); a turn prints its log lines and then one JSON line of the
numbers.

    python3 tools/torch_kernel_times.py --parent DIR --flagship

adds the flagship's entry (``measure_flagship``: ``cli.run --synthetic 512
--bls dummy`` with ``skip_prove``, then preprocess and timed proves, whose
median is ``full512_prove_wall_s``) to each turn of a checkout that has
``eth_lc_plonky2_tpu_torch/cli.py``; about two minutes a turn.

    python3 tools/torch_kernel_times.py --parent DIR --only perm_polys,open_and_g

runs only the named entries (``commit``, ``gates``, ``perm_polys``,
``quotient_kernels``, ``open_and_g``) in each turn.  Every kernel time is
device time (``chip_smoke.device_ms``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


ENTRIES = ("commit", "gates", "perm_polys", "quotient_kernels", "open_and_g")


def turn(tag: str, root: str, flagship: bool, only: tuple) -> None:
    sys.path.insert(0, root)  # the package under test; chip_smoke.py is always this checkout's
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import numpy as np
    import torch

    from eth_lc_plonky2_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        raise RuntimeError("this measurement needs an NVIDIA GPU")
    build = kernels.build()
    rng = np.random.default_rng(0)
    card = smoke.card_line()
    chk = smoke.Checker()
    res = {}
    if "commit" in only:
        res = smoke.measure(torch, chk, rng, card, smoke.flagship_inputs(rng))
    if "gates" in only:
        res["gates"] = smoke.measure_gate_kernels(torch, chk, rng, card)
    if "perm_polys" in only:
        res["perm_polys"] = smoke.measure_perm_polys(torch, rng, card)
    if "quotient_kernels" in only:
        res["quotient_kernels"] = smoke.measure_quotient_kernels(torch, rng, card)
    if "open_and_g" in only:
        res["open_and_g"] = smoke.measure_open_and_g(torch, rng, card)
    if flagship and importlib.util.find_spec("eth_lc_plonky2_tpu_torch.cli") is not None:
        res["flagship"] = smoke.measure_flagship(torch, card)
    print(json.dumps({"tag": tag, "build_s": build["seconds"], **res}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the second checkout")
    ap.add_argument("--flagship", action="store_true",
                    help="also time the flagship through cli.run (where the checkout has it)")
    ap.add_argument("--only", default=",".join(ENTRIES),
                    help=f"comma-separated entries to run (of {', '.join(ENTRIES)})")
    ap.add_argument("--turn", nargs=2, metavar=("TAG", "ROOT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = tuple(args.only.split(","))
    if set(only) - set(ENTRIES):
        ap.error(f"--only takes {', '.join(ENTRIES)}")
    if args.turn:
        turn(*args.turn, args.flagship, only)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    parent = os.path.abspath(args.parent)
    for tag, root in (("parent", parent), ("change", HERE), ("change", HERE), ("parent", parent)):
        cmd = [sys.executable, os.path.abspath(__file__), "--turn", tag, root]
        res = subprocess.run(cmd + ["--flagship"] * args.flagship + ["--only", args.only],
                             cwd=root, timeout=1500)
        if res.returncode != 0:
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
