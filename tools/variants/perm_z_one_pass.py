#!/usr/bin/env python3
"""The permutation rows in one launch (``perm_z_one_pass.cu`` beside this
file), held against the main path's three launches on one GPU.

    python3 tools/variants/perm_z_one_pass.py [--rounds 2]

Builds the variant with the package's ``nvcc`` flags, checks its words
against ``kernels.perm_z`` (``perm_z_kernel``, its scan and fix-up) and the
plain version at (80, 2^18) with two challenges and zero den chunks, twice
back to back on one look-back state, at 2^12 with zeros in the first tile,
with one challenge, at 2^4, and at 256 routed wires in chunks of 4 at 2^14
(tiles of 32 columns: one warp looks back for both challenges); then times
both at (80, 2^18) by ``chip_smoke.device_ms``, three launches, one pass,
one pass, three launches a round, and prints one JSON line with the card's
name and power limit.

``plan`` and ``state`` size and keep the variant's look-back state;
``tests/test_torch_perm_one_pass.py`` walks the same algorithm under the
same plan on the CPU.  The variant is off the main path because it ran
slower on an H100 (PERF.md section 6)."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))

import torch  # noqa: E402

from eth_lc_plonky2_tpu_torch.ops import kernels  # noqa: E402

SOURCE = HERE / "perm_z_one_pass.cu"
# perm_z_one_pass.cu's tile of THREADS columns (a block of as many threads),
# halved while its dynamic shared memory (two words a chunk, challenge and
# column) would pass SHARED_TARGET, two blocks an SM
THREADS = 256
SHARED_TARGET = 96 * 1024


def plan(routed: int, n: int, chunk: int, challenges: int) -> dict:
    """How the one launch is sized for ``routed`` wires in chunks of
    ``chunk`` (m = routed / chunk) on an n-point subgroup, ``challenges``
    challenges: tiles of ``tile`` columns (THREADS, halved while its
    ``shared_bytes``, challenges * m words of num and of den a column, pass
    SHARED_TARGET: 256 up to m = 12 at two challenges, 32 at m = 64),
    ``grid`` tiles, a look-back state of ``state_words`` words.  The limits
    are ``kernels.perm_z_plan``'s."""
    if n < 1 or chunk < 1 or routed < chunk or routed % chunk or routed > kernels.PERM_MAX_ROUTED:
        raise ValueError(f"perm Z: {routed} routed wires in chunks of {chunk} on {n} points (at "
                         f"most {kernels.PERM_MAX_ROUTED} wires)")
    m = routed // chunk
    if m > kernels.PERM_MAX_CHUNKS or not 1 <= challenges <= kernels.PERM_CHALLENGES:
        raise ValueError(f"perm Z: {m} chunks, {challenges} challenges (at most "
                         f"{kernels.PERM_MAX_CHUNKS} chunks, 1 to {kernels.PERM_CHALLENGES} "
                         f"challenges)")

    def shared(t):
        return 2 * challenges * m * t * 8

    tile = THREADS
    while shared(tile) > SHARED_TARGET:  # m <= PERM_MAX_CHUNKS stops at 32 or more
        tile //= 2
    grid = -(-n // tile)
    if grid >= 1 << 31:
        raise ValueError(f"perm Z: a grid of {grid} tiles")
    return {"m": m, "tile": tile, "grid": grid, "shared_bytes": shared(tile),
            "state_words": state_words(grid)}


def state_words(cap: int) -> int:
    """The words of a look-back state for ``cap`` tiles: the ticket counter,
    then a status, the tile's own product and its inclusive product for each
    of PERM_CHALLENGES challenges and ``cap`` tiles."""
    return 1 + 3 * kernels.PERM_CHALLENGES * cap


# the look-back state for each (device, stream): {"words": the int64 tensor,
# "cap": tiles, "tickets": the counter's value, "epoch": the last launch's};
# made (zeroed) when a launch needs more tiles than it holds, never reset:
# each launch draws its tiles from "tickets" on and marks its statuses with
# an epoch of its own
_states: dict = {}


def state(device, stream: int, tiles: int) -> dict:
    """The look-back state that a launch of ``tiles`` tiles on ``stream`` of
    ``device`` uses (launches on one stream run in order, so they share it)."""
    key = (str(device), stream)
    st = _states.get(key)
    if st is None or st["cap"] < tiles:
        epoch = st["epoch"] if st is not None else 0
        st = {"words": torch.zeros(state_words(tiles), dtype=torch.int64, device=device),
              "cap": tiles, "tickets": 0, "epoch": epoch}
        _states[key] = st
    return st


_lib = None


def _library():
    global _lib
    if _lib is None:
        out = os.path.join(tempfile.mkdtemp(prefix="perm_z_one_pass_"), "libone_pass.so")
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o", out,
                        str(SOURCE)], check=True)
        lib = ctypes.CDLL(out)
        vp, ll, i32, ull = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong
        lib.elp_perm_z_one_pass.argtypes = [vp, ll, vp, ll, vp, vp, vp, vp, ll, i32, i32, i32, vp,
                                            vp, ll, ull, ull, i32, ll, ll, vp]
        lib.elp_perm_z_one_pass.restype = i32
        _lib = lib
    return _lib


def perm_z_one_pass(wires, sigma, omega, k_shifts, betas, gammas, chunk: int) -> torch.Tensor:
    """``kernels.perm_z``'s arguments and result, in the variant's one launch
    (CUDA tensors only)."""
    for t, name in ((wires, "wires"), (sigma, "sigma"), (omega, "omega"), (k_shifts, "k_shifts"),
                    (betas, "betas"), (gammas, "gammas")):
        kernels._check(t, name)
    routed, n = wires.shape
    dev = wires.device
    kernels._rows_view(wires, n, dev, "wires", "perm Z")
    kernels._rows_view(sigma, n, dev, "sigma", "perm Z")
    challenges = betas.shape[0]
    p = plan(routed, n, chunk, challenges)
    out = torch.empty((challenges * p["m"], n), dtype=torch.int64, device=dev)
    stream = kernels._stream(wires)
    st = state(dev, stream, p["grid"])
    err = _library().elp_perm_z_one_pass(
        wires.data_ptr(), wires.stride(0) if routed > 1 else n, sigma.data_ptr(),
        sigma.stride(0) if routed > 1 else n, omega.data_ptr(), k_shifts.data_ptr(),
        betas.data_ptr(), gammas.data_ptr(), n, routed, chunk, challenges, out.data_ptr(),
        st["words"].data_ptr(), st["cap"], st["tickets"], st["epoch"] + 1, p["tile"], p["grid"],
        p["shared_bytes"], stream)
    kernels.launches["one_pass"] = kernels.launches.get("one_pass", 0) + 1
    kernels._raise_on(err, "perm Z, one pass")
    st["tickets"] += p["grid"]
    st["epoch"] += 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import numpy as np

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise RuntimeError("this measurement needs an NVIDIA GPU")
    kernels.build()
    rng = np.random.default_rng(0)
    n = 1 << cs.LOG_N
    inputs = cs.perm_z_inputs(rng, cs.LOG_N, ((0, 3, n - 300), (1, 9, n - 2)))
    small = cs.perm_z_inputs(rng, 12, ((0, 0, 5), (1, 4, 300)))
    cases = {"(80, 2^18)": inputs, "(80, 2^12), zeros in the first tile": small,
             "(80, 2^12), one challenge": small[:4] + (small[4][1:], small[5][1:], cs.PERM_CHUNK),
             "(80, 2^4)": cs.perm_z_inputs(rng, 4, ((0, 2, 3),)),
             "(256, 2^14), chunk 4": cs.perm_z_inputs(rng, 14, ((0, 40, 9000), (1, 63, 16000)),
                                                      routed=256, chunk=4)}
    equal = {}
    for what, case in cases.items():
        want = kernels.perm_z(*case)
        equal[what] = (torch.equal(perm_z_one_pass(*case), want)
                       and torch.equal(perm_z_one_pass(*case), want)
                       and torch.equal(want, cs.perm_rows(case, "plain")))
    times = {"three_launches_ms": [], "one_pass_ms": []}
    three = (lambda: kernels.perm_z(*inputs), cs.PERM_ROWS_KERNELS, "field")
    one = (lambda: perm_z_one_pass(*inputs), ("perm_z_one_pass_kernel",), "one_pass")
    for _ in range(args.rounds):
        for key, (fn, names, source) in (("three_launches_ms", three), ("one_pass_ms", one),
                                         ("one_pass_ms", one), ("three_launches_ms", three)):
            times[key].append(cs.device_ms(torch, fn, names, source)[0])
    print(json.dumps({"card": cs.card_line(), "equal": equal, **times}), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
