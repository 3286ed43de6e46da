#!/usr/bin/env python3
"""The readings the judge's limits are set from, at a cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 4

For each seed, in one process, the cell is set up and warmed up, then a short
window of the program and one of the control (``control.py``: one FRI query
fewer than the configuration states) are judged; each window's numbers are
printed as one JSON line.  The program's lines give the lower readings, the
control's the upper.  The benchmark's own runs never run the control.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == BENCH:
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import control, harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for side, prove in (("program", None), ("control", control.control_prove)):
            t0 = time.time()
            result, _ = harness.run(cell, seed, args.seconds, False, t0, prove=prove)
            print(json.dumps({"workload": cell.name, "seed": seed, "side": side,
                              "correct": result["correct"], "attempted": result["attempted"],
                              "checks": result["checks"],
                              "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
