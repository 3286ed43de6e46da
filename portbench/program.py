"""What the benchmark takes from the program: its circuit configuration, its
circuit cache and its circuits' shapes.  Imported only by the set-up modules
(``circuits/``) and the harness, never by the reference.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "eth_lc_plonky2_tpu_torch"


def source_digest() -> str:
    """A digest of the program's sources, so that a circuit cache never
    outlives the code that built it."""
    h = hashlib.sha256()
    pkg = ROOT / PACKAGE
    for path in sorted(pkg.rglob("*")):
        if path.suffix in (".py", ".cu", ".cuh") and "build" not in path.relative_to(pkg).parts:
            h.update(str(path.relative_to(pkg)).encode())
            h.update(path.read_bytes())
    return h.hexdigest()


def circuit_config(config: dict):
    from eth_lc_plonky2_tpu_torch.prover.config import CircuitConfig, FriConfig

    return CircuitConfig(
        num_wires=config["num_wires"],
        num_routed_wires=config["num_routed_wires"],
        num_constants=config["num_constants"],
        num_challenges=config["num_challenges"],
        permutation_chunk_size=config["permutation_chunk_size"],
        fri=FriConfig(**config["fri"]),
    )


def cached_circuit(ctx, config: dict, build) -> tuple:
    """The configuration's circuit and its preprocess: loaded from the circuit
    cache (``prover/serialize.py``) where an entry for this configuration and
    these sources is there, else built by ``build()`` -> (data, extras),
    preprocessed on ``ctx.device`` and written to the cache.
    Returns (data, pd, extras, seconds of build or load plus preprocess)."""
    from eth_lc_plonky2_tpu_torch.prover import prove as pr
    from eth_lc_plonky2_tpu_torch.prover import serialize as ser

    key = hashlib.sha256((json.dumps(config, sort_keys=True) + source_digest()).encode())
    where = ctx.cache_root / f"{config['name']}-{key.hexdigest()[:16]}"
    t0 = time.perf_counter()
    if (where / "circuit.pkl").exists() and (where / "pre.npz").exists():
        extras, data, pd, _ = ser.load_circuit(str(where), device=ctx.device)
        seconds = time.perf_counter() - t0
        ctx.log(f"circuit cache hit: {where.name}, {seconds:.3f} s")
        return data, pd, extras, seconds
    data, extras = build()
    pd, _ = pr.preprocess(data, device=ctx.device)
    seconds = time.perf_counter() - t0
    ctx.log(f"circuit built and preprocessed in {seconds:.3f} s ({data.num_rows_used} of "
            f"2^{data.log_n} rows)")
    t1 = time.perf_counter()
    partial = where.with_name(where.name + ".partial")
    shutil.rmtree(partial, ignore_errors=True)
    ser.save_circuit(str(partial), data, pd, extras=extras)
    os.replace(partial, where)
    ctx.log(f"circuit cache written: {where.name}, {time.perf_counter() - t1:.3f} s")
    return data, pd, extras, seconds


def shapes(pd) -> dict:
    """The sizes the roofline counts read: the circuit's and its commitments'."""
    data = pd.data
    cfg = data.config
    return {
        "log_n": data.log_n,
        "rate_bits": cfg.rate_bits,
        "cap_height": cfg.cap_height,
        "final_poly_bits": cfg.fri.final_poly_bits,
        "num_challenges": cfg.num_challenges,
        "commit_widths": [cfg.num_wires, cfg.num_challenges * cfg.num_permutation_chunks,
                          cfg.num_challenges << cfg.rate_bits],
    }
