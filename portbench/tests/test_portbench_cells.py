"""Cells, configurations, traffic and metrics are found by name from files,
and a file added beside them is picked up with no edit."""

import json
import re

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONCE_EACH = """
def drive(prove, pd, witnesses, seconds, sync, new_profiler):
    proofs = [(i, prove(pd, w, prof=new_profiler())) for i, w in enumerate(witnesses)]
    return {"proofs": proofs, "seconds": 1.0, "error": None, "profilers": [], "prove_s": []}
"""


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(workload):
    cell = harness.load_cell(ROOT, workload)
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert cell.config["name"] == entry["config"]
    assert cell.traffic["name"] == entry["traffic"]
    assert (cell.bench_dir / "circuits" / f"{cell.config['circuit']}.py").exists()
    assert (cell.bench_dir / "reference" / f"{cell.config['circuit']}.py").exists()
    assert (cell.bench_dir / "reference" / "circuits" / f"{cell.config['name']}.json").exists()
    names = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "device_busy_ms"} <= names and cell.per_layer
    for m in cell.per_layer:
        assert (cell.bench_dir / "metrics" / f"{m['name']}.py").exists()


def test_unknown_cell_refused():
    with pytest.raises(KeyError):
        harness.load_cell(ROOT, "no_such.cell")


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_matches_its_frozen_circuit(config):
    """The configuration as it is run states the frozen circuit's config."""
    cfg = json.loads((ROOT / config["file"]).read_text())
    frozen = json.loads((ROOT / "portbench" / "reference" / "circuits" /
                         f"{config['name']}.json").read_text())
    stated = {k: cfg[k] for k in ("num_wires", "num_routed_wires", "num_constants",
                                  "num_challenges", "permutation_chunk_size", "fri")}
    assert frozen["config"] == stated
    assert frozen["circuit"]["log_n"] == cfg["log_n"]
    assert len(frozen["circuit"]["public_input_rows"]) == cfg["public_inputs"]
    assert cfg["name"] == config["name"] and cfg["reduced"] == config["reduced"]


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_new_files_picked_up_with_no_edit(toy_root):
    """A configuration, a traffic mix with a driver of its own and a metric
    added as files (and entries of BENCHMARK.json) are found; no file of the
    harness changes."""
    bench = toy_root / "portbench"
    spec = json.loads((toy_root / "BENCHMARK.json").read_text())
    traffic = json.loads((bench / "traffic" / "steady.json").read_text())
    traffic.update(name="steady3", distinct_witnesses=3, driver="once_each")
    (bench / "traffic" / "steady3.json").write_text(json.dumps(traffic))
    (bench / "drivers" / "once_each.py").write_text(ONCE_EACH)
    (bench / "metrics" / "proofs_in_window.py").write_text(
        "def read(record):\n    return float(len(record['proofs']))\n")
    spec["workloads"].append({"name": "toy.steady3", "config": "toy", "traffic": "steady3",
                              "chips": 1, "why": "tests"})
    spec["per_layer"].append({"name": "proofs_in_window", "unit": "proofs", "better": "higher",
                              "source": "program_counter", "layer": "prove", "moves": "device_busy_ms"})
    (toy_root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell(toy_root, "toy.steady3", bench_dir=bench)
    assert cell.config["name"] == "toy" and cell.traffic["distinct_witnesses"] == 3
    window = cell.driver.drive(lambda pd, w, prof: w, None, ["a", "b", "c"], 0.0, lambda: None,
                               lambda: None)
    assert window["proofs"] == [(0, "a"), (1, "b"), (2, "c")]
    assert "proofs_in_window" in {m["name"] for m in cell.per_layer}
    record = {"proofs": [{}, {}], "profiles": [], "setup": {}}
    verdict = {"correct": True, "failed": 0, "checks": {}}
    result = harness._result(cell, record, verdict, [0, 1], None, 1.0, 1.0, True, {})
    assert result["metrics"]["proofs_in_window"] == {"value": 2.0, "unit": "proofs"}


def test_traffic_without_its_driver_refused(toy_root):
    bench = toy_root / "portbench"
    traffic = json.loads((bench / "traffic" / "steady.json").read_text())
    traffic.update(driver="no_such_driver")
    (bench / "traffic" / "steady.json").write_text(json.dumps(traffic))
    with pytest.raises(FileNotFoundError):
        harness.load_cell(toy_root, "toy.steady", bench_dir=bench)
