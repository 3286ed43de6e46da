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
``prove.compute_permutation_polys``); a turn prints its log lines and then
one JSON line of the numbers.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def turn(tag: str, root: str) -> None:
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
    res = smoke.measure(torch, chk, rng, card, smoke.flagship_inputs(rng))
    res["gates"] = smoke.measure_gate_kernels(torch, chk, rng, card)
    res["perm_polys"] = smoke.measure_perm_polys(torch, rng, card)
    print(json.dumps({"tag": tag, "build_s": build["seconds"], **res}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the second checkout")
    ap.add_argument("--turn", nargs=2, metavar=("TAG", "ROOT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        turn(*args.turn)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    parent = os.path.abspath(args.parent)
    for tag, root in (("parent", parent), ("change", HERE), ("change", HERE), ("parent", parent)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", tag, root],
                             cwd=root, timeout=1500)
        if res.returncode != 0:
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
