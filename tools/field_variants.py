#!/usr/bin/env python3
"""Time edited copies of csrc/field.cu against the checkout's own, in turns, on one GPU.

    python3 tools/field_variants.py VARIANTS.py [--rounds 2]

``VARIANTS.py`` defines ``VARIANTS = {name: [(old, new), ...]}``: each
variant is ``csrc/field.cu`` with every ``old`` string (which must occur
exactly once) replaced by ``new``; ``"base"``, the file as it is, is always
timed first.  An optional ``PY = {name: {attribute: value}}`` sets constants
of ``ops/kernels.py`` while that variant runs (a plan that must agree with an
edited constant).  All copies are built side by side with the package's own
``nvcc`` flags, each into a library of its own that ``kernels._libraries``
is pointed at in turn.  Each variant's openings (phase 7's four batches at
2^18, ``chip_smoke.open_all``) and G (2^21, 12 specs, ``chip_smoke.g_terms``)
are checked word for word against the base's (an edit that changes the
arithmetic shows as False) and timed with CUDA events, ``--rounds`` rounds of
all variants; one JSON line a variant.  About 40 s a call for a few variants.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import runpy
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", help="a Python file defining VARIANTS (and optionally PY)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from eth_lc_plonky2_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        raise RuntimeError("this measurement needs an NVIDIA GPU")
    spec = runpy.run_path(args.variants)
    variants = {"base": [], **spec["VARIANTS"]}
    consts = spec.get("PY", {})
    source = (kernels.CSRC / "field.cu").read_text()
    out_dir = tempfile.mkdtemp(prefix="field_variants_")
    builds = {}
    for name, edits in variants.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"{name}: {old[:60]!r} occurs {text.count(old)} times")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"field_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"libfield_{name}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(kernels.CSRC),
               "-o", so, cu]
        builds[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                             text=True))
    real = kernels._libraries()
    libs, ptxas = {}, {}
    for name, (so, proc) in builds.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        ptxas[name] = {k: v for k, v in cs.ptxas_info(err).items()
                       if "fri_g_kernel" in k or "field_open" in k}
        lib = ctypes.CDLL(so)
        for fn in ("elp_fri_g", "elp_field_open", "elp_field_open_table"):
            getattr(lib, fn).argtypes = getattr(real["field"], fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    rng = np.random.default_rng(0)
    inp = cs.opening_inputs(rng, cs.LOG_N)
    g = cs.g_inputs(rng, cs.LOG_N + cs.RATE_BITS, 12)
    original = kernels._libraries

    def run(name, fn):
        kernels._libraries = lambda: {**real, "field": libs[name]}
        saved = {k: getattr(kernels, k) for k in consts.get(name, {})}
        try:
            for k, v in consts.get(name, {}).items():
                setattr(kernels, k, v)
            return fn()
        finally:
            for k, v in saved.items():
                setattr(kernels, k, v)
            kernels._libraries = original

    def opened():
        return [torch.stack(pair) for pair in cs.open_all(inp)]

    want_open = run("base", opened)
    want_g = run("base", lambda: cs.g_terms(g))
    res = {name: {"open_ms": [], "g_ms": []} for name in libs}
    for name in libs:
        res[name]["open_equal"] = all(torch.equal(a, b) for a, b in zip(run(name, opened), want_open))
        res[name]["g_equal"] = torch.equal(run(name, lambda: cs.g_terms(g)), want_g)
    for _ in range(args.rounds):
        for name in libs:
            res[name]["open_ms"].append(run(name, lambda: cs.cuda_ms(lambda: cs.open_all(inp), 9)))
            res[name]["g_ms"].append(run(name, lambda: cs.cuda_ms(lambda: cs.g_terms(g), 9)))
    card = cs.card_line()
    for name, r in res.items():
        print(json.dumps({"variant": name, "card": card, **r, "ptxas": ptxas[name]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
