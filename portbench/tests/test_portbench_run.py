"""A whole run on the CPU (the look for a card skipped): the toy cell is set
up, warmed up, proved for a window and judged; the result line has the keys
the contract names; the control and every fault the cell can have come out
as not correct."""

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from portbench import control, harness
from portbench.tests.conftest import ROOT

SEED = 2**31 + 11


def _cell(toy_root):
    return harness.load_cell(toy_root, "toy.steady", bench_dir=toy_root / "portbench")


def test_toy_run_is_correct_with_the_contract_keys(toy_root):
    result, record = harness.run(_cell(toy_root), SEED, 0.5, False, time.time(), device="cpu")
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] == record["window"]["proofs"] >= 2
    # without a card there is no busy time to trace, so that metric is left out
    assert set(result["metrics"]) == {"setup_s"} and result["metrics"]["setup_s"]["value"] > 0
    assert "trace" not in record
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    json.dumps(result)


def test_same_seed_same_statements(toy_root):
    cell = _cell(toy_root)
    one, two, other = (harness.statements(cell, harness.prepare(cell, s, device="cpu")[1]["raws"])
                       for s in (SEED, SEED, SEED + 1))
    assert one == two and one != other and len(one) == cell.traffic["distinct_witnesses"]


@pytest.mark.parametrize("fault", ["control", "stale", "altered", "half_queries"])
def test_control_and_faults_are_not_correct(toy_root, fault):
    prove = {"control": control.control_prove, "stale": control.stale_prove(),
             "altered": control.altered_prove, "half_queries": control.half_queries_prove}[fault]
    result, _ = harness.run(_cell(toy_root), SEED, 0.5, False, time.time(), device="cpu",
                            prove=prove)
    assert result["correct"] is False and result["failed"] >= 1


def _event(name, start, end, device="CPU"):
    return SimpleNamespace(name=name, device_type=SimpleNamespace(name=device),
                           time_range=SimpleNamespace(start=start, end=end))


def test_trace_record_busy_and_idle_by_phase():
    events = [
        _event(harness.WARM, 0, 100), _event("k_warm", 10, 90, "CUDA"),
        _event(harness.WINDOW, 100, 1100),
        _event(harness.PHASE + "witness_matrix", 100, 600),
        _event(harness.PHASE + "commit_wires", 600, 1100),
        _event("Memcpy HtoD (Pageable -> Device)", 550, 650, "CUDA"),
        _event("sponge_kernel", 700, 800, "CUDA"), _event("sponge_kernel", 750, 900, "CUDA"),
        _event(harness.PHASE + "commit_wires", 700, 800, "CUDA"),  # a span's device copy
    ]
    t = harness._trace_record(SimpleNamespace(events=lambda: events))
    assert t["window_s"] == pytest.approx(1000e-6)
    assert t["busy_s"] == pytest.approx(300e-6)  # 550..650 and 700..900
    assert t["kernel_s"] == pytest.approx({"Memcpy HtoD (Pageable -> Device)": 100e-6,
                                           "sponge_kernel": 250e-6})
    assert t["idle_by_phase"] == pytest.approx({"witness_matrix": 450e-6,
                                                "commit_wires": 250e-6})


def test_run_refuses_without_a_card(tmp_path):
    """With no card (this machine), the command prints no result and fails."""
    proc = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                           "lc512_dummy.steady", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", ".out", "__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "lc512_dummy.steady", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "control", "altered"])
def test_toy_run_on_the_card(card, toy_root, fault):
    prove = {None: None, "control": control.control_prove, "altered": control.altered_prove}[fault]
    result, _ = harness.run(_cell(toy_root), SEED, 0.5, True, time.time(), device="cuda",
                            prove=prove)
    assert result["correct"] is (fault is None)
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0


@pytest.mark.cuda
def test_toy_untraced_run_on_the_card_reports_the_cards_busy_time(card, toy_root):
    result, record = harness.run(_cell(toy_root), SEED, 0.5, False, time.time(), device="cuda")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"device_busy_ms", "setup_s"}
    assert 0 < result["metrics"]["device_busy_ms"]["value"] * record["window"]["proofs"] <= (
        1e3 * record["trace"]["window_s"])
