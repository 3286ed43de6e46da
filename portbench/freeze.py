#!/usr/bin/env python3
"""Export a configuration's circuit and verification key from the program, in
the proof format's shape (``docs/proof_format.md``: format, config, circuit,
vk), to compare with or to make its frozen file under ``reference/circuits/``.

    python3 portbench/freeze.py --config <name> --out <file.json> [--device cpu]

The judge reads only the frozen files; this script is how one was made or
checked, never part of a run.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent


def export(data, pd) -> dict:
    from eth_lc_plonky2_tpu_torch.circuit.algebra import gate_expression
    from eth_lc_plonky2_tpu_torch.prover import serialize as ser

    return {
        "format": ser.BUNDLE_FORMAT,
        "config": ser._config_dict(data.config),
        "circuit": {
            "log_n": data.log_n,
            "gate_names": list(data.gate_names),
            "gates": [gate_expression(g) for g in data.gates],
            "wire_offsets": sorted({off for g in data.gates for off in g.wire_offsets} | {0}),
            "public_input_rows": [[int(r), int(c)] for (r, c) in data.public_input_targets],
        },
        "vk": {"pre_cap": [[hex(int(v)) for v in row] for row in pd.pre_batch.cap]},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == BENCH:
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    with open(BENCH / "configs" / f"{args.config}.json") as f:
        config = json.load(f)
    ctx = harness.Context(args.device, BENCH / ".cache" / "circuits")
    module = harness.load_module(BENCH / "circuits" / f"{config['circuit']}.py", config["circuit"])
    c = module.circuit(config, ctx)
    out = export(c["data"], c["pd"])
    frozen = BENCH / "reference" / "circuits" / f"{args.config}.json"
    if frozen.exists():
        with open(frozen) as f:
            have = json.load(f)
        same = {k: have.get(k) == out[k] for k in ("format", "config", "circuit", "vk")}
        print(f"freeze: {args.config} against its frozen file: {same}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, separators=(",", ":"))
    print(f"freeze: wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
