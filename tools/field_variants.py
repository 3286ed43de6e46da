#!/usr/bin/env python3
"""Time edited copies of a CUDA source against the checkout's own, in turns, on one GPU.

    python3 tools/field_variants.py VARIANTS.py [--source field.cu|gates.cu|sha256.cu] [--rounds 2]

``VARIANTS.py`` defines ``VARIANTS = {name: [(old, new), ...]}``: each
variant is ``csrc/<source>`` (``field.cu`` unless ``--source`` says
otherwise) with every ``old`` string (which must occur exactly once) replaced
by ``new``; ``"base"``, the file as it is, is always timed first.  An
optional ``PY = {name: {attribute: value}}`` sets constants of
``ops/kernels.py`` while that variant runs (a plan that must agree with an
edited constant).  All copies are built side by side with the package's own
``nvcc`` flags, each into a library of its own that ``kernels._libraries``
is pointed at in turn.  For ``field.cu`` each variant's openings (phase 7's
four batches at 2^18, ``chip_smoke.open_all``), G (2^21, 12 specs,
``chip_smoke.g_terms``), permutation terms ((80, 2^21),
``chip_smoke.perm_terms``) and permutation rows ((80, 2^18), two challenges,
``chip_smoke.perm_rows``) are timed (``--what`` picks some); for
``gates.cu`` the generic gates' share ((184, 2^21) with 12 public inputs,
``chip_smoke.generic_terms``); for ``sha256.cu`` compress and two_to_one
at 2^20 seeded messages (``chip_smoke.sha256_words``; each library gets its
own __constant__ table).  Each is checked word for word against the
base's (an edit that changes the arithmetic shows as False) and timed by its
kernels' device time (``chip_smoke.device_ms``), ``--rounds`` rounds of all
variants; one JSON line a variant, with ptxas's registers, stack and spills
of the timed kernels.  About 40 s a call for a few variants.
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

# the kernels each source's variants are timed by (ptxas lines kept), and the
# C entry points their libraries must bind
TIMED = {"field": ("fri_g_kernel", "field_open", "perm_quotient_kernel", "perm_z_kernel"),
         "gates": ("generic_gate_quotient_kernel",),
         "sha256": ("sha256_compress_kernel", "sha256_two_to_one_kernel")}
ENTRIES = {"field": ("elp_fri_g", "elp_field_open", "elp_field_open_table", "elp_perm_quotient",
                     "elp_perm_z"),
           "gates": ("elp_generic_gate_quotient",),
           "sha256": ("elp_sha256_set_constants", "elp_sha256_compress", "elp_sha256_two_to_one")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", help="a Python file defining VARIANTS (and optionally PY)")
    ap.add_argument("--source", default="field.cu", choices=("field.cu", "gates.cu", "sha256.cu"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--what", default="open,g,perm,rows,generic,compress,two_to_one",
                    help="comma-separated measurements to time (field.cu: open, g, perm, rows)")
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
    stem = args.source.split(".")[0]
    source = (kernels.CSRC / args.source).read_text()
    out_dir = tempfile.mkdtemp(prefix="field_variants_")
    builds = {}
    for name, edits in variants.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"{name}: {old[:60]!r} occurs {text.count(old)} times")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{stem}_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"lib{stem}_{name}.so")
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
                       if any(s in k for s in TIMED[stem])}
        lib = ctypes.CDLL(so)
        for fn in ENTRIES[stem]:
            getattr(lib, fn).argtypes = getattr(real[stem], fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    rng = np.random.default_rng(0)
    n_lde = cs.LOG_N + cs.RATE_BITS
    what = args.what.split(",")
    if stem == "field":
        inp = cs.opening_inputs(rng, cs.LOG_N) if "open" in what else None
        g = cs.g_inputs(rng, n_lde, 12) if "g" in what else None
        perm = cs.perm_inputs(rng, n_lde) if "perm" in what else None
        n = 1 << cs.LOG_N
        rows = (cs.perm_z_inputs(rng, cs.LOG_N, ((0, 3, n - 300), (1, 9, n - 2)))
                if "rows" in what else None)
        timed = {"open": (lambda: [torch.stack(pair) for pair in cs.open_all(inp)],
                          cs.TRACED_AS["field_open_kernel"]),
                 "g": (lambda: cs.g_terms(g), ("fri_g_kernel",)),
                 "perm": (lambda: cs.perm_terms(perm), ("perm_quotient_kernel",)),
                 "rows": (lambda: cs.perm_rows(rows), cs.PERM_ROWS_KERNELS)}
    elif stem == "gates":
        gen = cs.generic_inputs(rng, 1 << n_lde)
        timed = {"generic": (lambda: cs.generic_terms(gen), ("generic_gate_quotient_kernel",))}
    else:
        from eth_lc_plonky2_tpu_torch.ops import sha256 as sha

        n = cs.SHA256_NS[-1]
        state, block, left, right = (cs.sha256_words(rng, (n, w), "cuda") for w in (8, 16, 8, 8))
        # read as int32, which torch.equal takes on the card
        timed = {"compress": (lambda: sha.compress(state, block).view(torch.int32),
                              ("sha256_compress_kernel",)),
                 "two_to_one": (lambda: sha.two_to_one(left, right).view(torch.int32),
                                ("sha256_two_to_one_kernel",))}
    timed = {k: v for k, v in timed.items() if k in what}
    original = kernels._libraries

    def run(name, fn):
        kernels._libraries = lambda: {**real, stem: libs[name]}
        saved = {k: getattr(kernels, k) for k in consts.get(name, {})}
        try:
            for k, v in consts.get(name, {}).items():
                setattr(kernels, k, v)
            return fn()
        finally:
            for k, v in saved.items():
                setattr(kernels, k, v)
            kernels._libraries = original

    def same(a, b):
        return (all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(a, list)
                else torch.equal(a, b))

    want = {w: run("base", fn) for w, (fn, _) in timed.items()}
    res = {name: {f"{w}_ms": [] for w in timed} for name in libs}
    for name in libs:
        for w, (fn, _) in timed.items():
            res[name][f"{w}_equal"] = same(run(name, fn), want[w])
    source = stem
    for _ in range(args.rounds):
        for name in libs:
            for w, (fn, names) in timed.items():
                res[name][f"{w}_ms"].append(
                    run(name, lambda: cs.device_ms(torch, fn, names, source)[0]))
    card = cs.card_line()
    for name, r in res.items():
        print(json.dumps({"variant": name, "card": card, **r, "ptxas": ptxas[name]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
