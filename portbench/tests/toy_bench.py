"""A toy cell of the benchmark, made only of added files: a small arithmetic
circuit (a chain of products, 2^7 rows, 3 FRI queries) that the program proves
on the CPU in a second, so that a whole run can be driven there."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
P = (1 << 64) - (1 << 32) + 1

CONFIG = {
    "name": "toy", "circuit": "toy_chain", "source": "a test circuit", "rounds": 1500,
    "num_wires": 96, "num_routed_wires": 80, "num_constants": 6, "num_challenges": 2,
    "permutation_chunk_size": 8,
    "fri": {"rate_bits": 3, "cap_height": 4, "proof_of_work_bits": 2, "num_query_rounds": 3,
            "final_poly_bits": 5},
    "assumed": [], "reduced": [],
}

SETUP = '''
import time

from portbench import program, updates


def build(config):
    from eth_lc_plonky2_tpu_torch.circuit.builder import CircuitBuilder

    b = CircuitBuilder(program.circuit_config(config))
    xs = b.add_virtual_targets(2)
    acc = xs[0]
    for _ in range(config["rounds"]):
        acc = b.mul_add(acc, acc, xs[1])
    b.register_public_input(acc)
    return b.build(), xs


def setup(config, traffic, seed, ctx):
    data, pd, xs, circuit_s = program.cached_circuit(ctx, config, lambda: build(config))
    witnesses, raws = [], []
    t0 = time.perf_counter()
    for k in range(traffic["distinct_witnesses"]):
        x = [int(v) for v in updates.rng_for(seed, k).integers(1, 1 << 62, 2)]
        w = data.new_witness()
        for t, v in zip(xs, x):
            w.set(t, v)
        w.generate()
        witnesses.append(w)
        raws.append({"x": x, "rounds": config["rounds"]})
    return {"pd": pd, "witnesses": witnesses, "raws": raws, "circuit_s": circuit_s,
            "witness_gen_s": (time.perf_counter() - t0) / len(witnesses)}
'''

STATEMENT = '''
P = (1 << 64) - (1 << 32) + 1


def expected_public_inputs(raw):
    acc, c = raw["x"]
    for _ in range(raw["rounds"]):
        acc = (acc * acc + c) % P
    return [acc]
'''


def frozen(config: dict) -> dict:
    """The toy's circuit and key, exported from the program."""
    import importlib.util

    from eth_lc_plonky2_tpu_torch.prover import prove as pr

    from portbench import freeze

    spec = importlib.util.spec_from_loader("toy_setup", loader=None)
    module = importlib.util.module_from_spec(spec)
    exec(SETUP, module.__dict__)
    data, _ = module.build(config)
    pd, _ = pr.preprocess(data, device="cpu")
    return freeze.export(data, pd)


def make(tmp: Path) -> Path:
    root = tmp / "checkout"
    bench = root / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(".cache", ".out", "__pycache__"))
    with open(BENCH.parent / "BENCHMARK.json") as f:
        spec = json.load(f)
    spec["configs"] = [{"name": "toy", "source": "a test circuit",
                        "file": "portbench/configs/toy.json", "reduced": [], "why": "tests"}]
    spec["workloads"] = [{"name": "toy.steady", "config": "toy", "traffic": "steady", "chips": 1,
                          "why": "tests"}]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (bench / "configs" / "toy.json").write_text(json.dumps(CONFIG))
    (bench / "circuits" / "toy_chain.py").write_text(SETUP)
    (bench / "reference" / "toy_chain.py").write_text(STATEMENT)
    (bench / "reference" / "circuits" / "toy.json").write_text(json.dumps(frozen(CONFIG)))
    return root
