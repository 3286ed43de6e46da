"""The readers of the program's spans inside the prover, ``transcript_ms``
and ``device_wait_ms``: None without profiles or without their span's key
(what a program without the spans leaves), the mean over proofs otherwise; and
the toy cell's traced run on the CPU reports both."""

import time

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT

SEED = 2**31 + 29
PROFILES = [
    {"fri": 0.5, "_sync_wait": 0.010, "_transcript": 0.30, "_device_read": 0.040},
    {"fri": 0.6, "_sync_wait": 0.030, "_transcript": 0.50, "_device_read": 0.080},
]


def _reader(name):
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py", name).read


@pytest.mark.parametrize("name,want", [("transcript_ms", 400.0), ("device_wait_ms", 80.0)])
def test_readers_on_hand_made_records(name, want):
    read = _reader(name)
    assert read({"profiles": []}) is None
    key = {"transcript_ms": "_transcript", "device_wait_ms": "_device_read"}[name]
    lacking = [{k: v for k, v in p.items() if k != key} for p in PROFILES]
    assert read({"profiles": lacking}) is None
    assert read({"profiles": PROFILES[:1] + lacking[1:]}) is None
    assert read({"profiles": PROFILES}) == pytest.approx(want)


def test_toy_traced_run_reports_both(toy_root):
    cell = harness.load_cell(toy_root, "toy.steady", bench_dir=toy_root / "portbench")
    result, record = harness.run(cell, SEED, 0.5, True, time.time(), device="cpu")
    assert result["correct"] is True
    metrics = result["metrics"]
    assert {"transcript_ms", "device_wait_ms"} <= set(metrics)
    walls = [1e3 * s for s in record["window"]["prove_s"]]
    assert 0 < metrics["transcript_ms"]["value"] < sum(walls) / len(walls)
    assert 0 < metrics["device_wait_ms"]["value"] < sum(walls) / len(walls)
    assert metrics["transcript_ms"]["unit"] == metrics["device_wait_ms"]["unit"] == "ms"
    for p, wall in zip(record["profiles"], walls):
        assert 1e3 * (p["_transcript"] + p["_device_read"] + p["_sync_wait"]) <= wall
