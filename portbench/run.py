#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic and metrics
are found by name (``portbench/harness.py``).  The run sets up (the circuit,
its preprocess, the cell's distinct witnesses from ``--seed``), proves each
witness once to warm up, proves them in turn for ``--seconds``, judges every
proof of the window, and prints one JSON line last on standard output; the
numbers it compared, each beside its limit, are the last lines on standard
error.  The window is traced by ``torch.profiler`` in every run.  With
``--trace 0`` the line holds the end-to-end metrics, the card's busy time among
them; with ``--trace 1``, which also marks the program's phases, the per-layer
metrics from the trace and the program's phase record.

It exits with another code than 0, printing no result, where there is no
card, fewer cards than the cell asks for, no program beside it, or where JAX
or the JAX package was loaded.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent


def _args(argv):
    p = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    if sys.path and Path(sys.path[0]).resolve() == BENCH:
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(BENCH / ".cache" / sub)

    from portbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        result, _ = harness.run(cell, args.seed, args.seconds, bool(args.trace), T_PROCESS,
                                out_dir=BENCH / ".out")
    except ImportError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
