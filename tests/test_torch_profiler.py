"""The port's profiler switch and record against the JAX package's, on one
small circuit built in both packages: ELP_PROFILE=1 has ``prove`` (without a
``prof``) print one ``ELP_PROFILE`` record whose keys, counts and phase names
are the JAX package's (the port's phases are the JAX package's plus
``witness_upload``), kept in each module's ``last_profile``; ELP_PHASE_LOG=1
prints the phases' starts on stderr in the JAX package's format and order;
switched off, nothing is printed and ``last_profile`` stays.  No proof
changes: each equals, byte for byte, the proof made with the switch off.
``Profiler.count`` and ``finish`` are fed the same calls in both classes,
and ``prove_sharded`` prints one record on a one-rank gloo group.

The port's record also holds its spans inside the prover, which the JAX
package has not: ``_transcript`` and ``_device_read`` in the phases, and the
counts ``transcript``, ``transcript_permutations`` and ``device_read``, each
checked against the prove's own calls; the trace's ``phase:`` spans tile the
prove without overlapping, and a disabled profiler records nothing."""

import json
import re

import pytest
import torch

from eth_lc_plonky2_tpu.prover import profiler as jprofiler
from eth_lc_plonky2_tpu_torch.ops import poseidon as pos
from eth_lc_plonky2_tpu_torch.parallel import distributed as dist
from eth_lc_plonky2_tpu_torch.parallel import prover as pprover
from eth_lc_plonky2_tpu_torch.prover import profiler
from torch_circuits import JAX, PORT, preprocess

torch.set_num_threads(1)

SWITCHES = ("ELP_PROFILE", "ELP_PHASE_LOG")
KEYS = {"total_s", "phases", "counts"}
LOG_LINE = re.compile(r"\[prove \+ *\d+\.\ds\] phase (\w+)")
SPANS = {"_transcript", "_device_read"}  # the port's spans, in the record's phases
COUNTS = {"transcript", "transcript_permutations", "device_read"}


def _circuit(pkg):
    """A chain of multiply-adds long enough that FRI folds twice, with a
    reduced FRI."""
    cfg = pkg.config.CircuitConfig(
        fri=pkg.config.FriConfig(proof_of_work_bits=4, num_query_rounds=4))
    b = pkg.builder.CircuitBuilder(cfg)
    x = b.add_virtual_target()
    acc = x
    while len(b.rows) < 120:
        acc = b.mul_add(acc, x, x)
    b.register_public_input(acc)
    data = b.build()
    w = data.new_witness()
    w.set(x, 3)
    w.generate()
    return data, w


def _text(pkg, proof):
    return json.dumps(pkg.ser.proof_to_dict(proof, include_indices=True))


@pytest.fixture(scope="module")
def both():
    """{pkg name: (pkg, prover data, witness, the proof's JSON with the
    switch off)}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in SWITCHES:
            mp.delenv(name, raising=False)
        for name, pkg in (("jax", JAX), ("port", PORT)):
            data, w = _circuit(pkg)
            pd, _ = preprocess(pkg, data)
            out[name] = (pkg, pd, w, _text(pkg, pkg.pr.prove(pd, w)))
    assert out["jax"][3] == out["port"][3]
    return out


def _device_reads(pd, text: str) -> int:
    """The prove's blocking reads of device data, from its proof's JSON: the
    three commitments' caps, the openings of each batch, each FRI layer's cap,
    the final polynomial, each batch of the grind, the query rows and paths."""
    fri = json.loads(text)["fri"]
    grind_batch = 1 << min(20, pd.data.config.fri.proof_of_work_bits + 3)
    tags = {tag for tag, _ in PORT.pr.opening_point_specs(pd.data)}
    return (3 + len(tags) + len(fri["layer_caps"]) + 1 + int(fri["pow_witness"], 16) // grind_batch
            + 1 + 1)


def _records(out: str) -> list:
    return [json.loads(line[len("ELP_PROFILE "):]) for line in out.splitlines()
            if line.startswith("ELP_PROFILE ")]


def _prove_each(both, capsys) -> dict:
    """{pkg name: (the proof's JSON, stdout, stderr)} of one ``prove``
    without a ``prof`` in each package."""
    capsys.readouterr()
    got = {}
    for name, (pkg, pd, w, _) in both.items():
        text = _text(pkg, pkg.pr.prove(pd, w))
        got[name] = (text,) + tuple(capsys.readouterr())
    return got


def test_switch_on_prints_one_record_like_the_jax_packages(both, monkeypatch, capsys):
    monkeypatch.setenv("ELP_PROFILE", "1")
    monkeypatch.delenv("ELP_PHASE_LOG", raising=False)
    got = _prove_each(both, capsys)
    rec = {}
    for name, mod in (("jax", jprofiler), ("port", profiler)):
        text, out, err = got[name]
        assert text == both[name][3], name  # the proof is the one made with the switch off
        assert err == "", name
        (rec[name],) = _records(out)
        assert set(rec[name]) == KEYS, name
        times = list(rec[name]["phases"].values())
        assert times == sorted(times, reverse=True), name
        assert "_sync_wait" in rec[name]["phases"], name
        assert mod.last_profile == rec[name], name
    assert rec["jax"]["counts"] == {}
    _, pd, _, _ = both["port"]
    counts = rec["port"]["counts"]
    assert set(counts) == COUNTS and counts["device_read"] == _device_reads(pd, got["port"][0])
    assert counts["transcript_permutations"] >= counts["transcript"] > 0
    assert "witness_upload" not in rec["jax"]["phases"] and not SPANS & set(rec["jax"]["phases"])
    assert set(rec["port"]["phases"]) == set(rec["jax"]["phases"]) | {"witness_upload"} | SPANS


@pytest.mark.parametrize("value", [None, "0"])
def test_switch_off_prints_nothing_and_keeps_last_profile(both, monkeypatch, capsys, value):
    if value is None:
        monkeypatch.delenv("ELP_PROFILE", raising=False)
    else:
        monkeypatch.setenv("ELP_PROFILE", value)
    monkeypatch.setenv("ELP_PHASE_LOG", "1")  # no phase is logged while the profiler is off
    kept = {"kept": True}
    monkeypatch.setattr(jprofiler, "last_profile", kept)
    monkeypatch.setattr(profiler, "last_profile", kept)
    got = _prove_each(both, capsys)
    for name in both:
        assert got[name] == (both[name][3], "", ""), name
    assert jprofiler.last_profile is kept and profiler.last_profile is kept


def test_phase_log_lines_match_the_jax_packages(both, monkeypatch, capsys):
    monkeypatch.setenv("ELP_PROFILE", "1")
    monkeypatch.setenv("ELP_PHASE_LOG", "1")
    got = _prove_each(both, capsys)
    names = {}
    for name in both:
        text, out, err = got[name]
        assert text == both[name][3] and len(_records(out)) == 1, name
        lines = err.splitlines()
        assert all(LOG_LINE.fullmatch(line) for line in lines), (name, lines)
        names[name] = [LOG_LINE.fullmatch(line).group(1) for line in lines]
    want = list(names["jax"])
    want.insert(want.index("witness_matrix") + 1, "witness_upload")
    assert names["port"] == want and want[-1] == "None"
    assert want[0] == "witness_matrix" and want.count("None") == 1


@pytest.mark.parametrize("enabled,switch", [(True, None), (True, "1"), (False, None),
                                            (False, "1")])
def test_count_and_finish_agree_with_the_jax_packages(monkeypatch, capsys, enabled, switch):
    monkeypatch.delenv("ELP_PHASE_LOG", raising=False)
    if switch is None:
        monkeypatch.delenv("ELP_PROFILE", raising=False)
    else:
        monkeypatch.setenv("ELP_PROFILE", switch)
    kept = {"kept": True}
    rec, printed = {}, {}
    for name, mod in (("jax", jprofiler), ("port", profiler)):
        monkeypatch.setattr(mod, "last_profile", kept)
        p = mod.Profiler(enabled=enabled)
        p.count("perms")
        p.phase("a")
        p.count("perms", 3)
        p.count("leaves", 2)
        p.phase("b")
        rec[name] = p.finish()
        printed[name] = _records(capsys.readouterr().out)
        assert p.counts == ({"perms": 4, "leaves": 2} if enabled else {}), name
        assert mod.last_profile is (rec[name] if enabled else kept), name
        assert printed[name] == ([rec[name]] if enabled and switch else []), name
    if not enabled:
        assert rec == {"jax": None, "port": None}
        return
    for name in rec:
        assert set(rec[name]) == KEYS and set(rec[name]["phases"]) == {"a", "b", "_sync_wait"}
        assert rec[name]["counts"] == {"perms": 4, "leaves": 2}
        assert rec[name]["total_s"] >= 0.0
    assert rec["port"]["counts"] == rec["jax"]["counts"]


def test_current_reads_the_switch_at_each_call(monkeypatch):
    for value, on in ((None, False), ("", False), ("0", False), ("1", True), ("yes", True)):
        if value is None:
            monkeypatch.delenv("ELP_PROFILE", raising=False)
        else:
            monkeypatch.setenv("ELP_PROFILE", value)
        assert profiler.Profiler.current().enabled is on
        assert jprofiler.Profiler.current().enabled is on


def test_prove_sharded_prints_one_record_on_one_gloo_rank(both, monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("ELP_PROFILE", "1")
    monkeypatch.delenv("ELP_PHASE_LOG", raising=False)
    _, pd, w, want = both["port"]
    capsys.readouterr()
    PORT.pr.prove(pd, w)
    (one,) = _records(capsys.readouterr().out)
    dist.initialize("file://" + str(tmp_path / "store"), 1, 0, device="cpu")
    try:
        proof = pprover.prove_sharded(pd, w, dist.make_global_mesh())
    finally:
        dist.shutdown()
    (rec,) = _records(capsys.readouterr().out)
    assert _text(PORT, proof) == want
    assert set(rec) == KEYS and set(rec["phases"]) == set(one["phases"])
    assert profiler.last_profile == rec


def _traced_prove(pd, w, prof):
    """The proof's JSON and the ``phase:`` events, by start (ns), of one prove
    under a CPU ``torch.profiler`` trace.  The trace's raw events are read:
    ``events()`` takes some 40 s to build the tree of a CPU prove's ops."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as trace:
        text = _text(PORT, PORT.pr.prove(pd, w, prof=prof))
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                     e.name()[len(profiler.TRACE_PREFIX):])
                    for e in trace.profiler.kineto_results.events()
                    if e.name().startswith(profiler.TRACE_PREFIX))
    return text, events


@pytest.mark.parametrize("case", ["permutations", "device_reads", "same_proof", "trace_tiles",
                                  "disabled_traces_nothing", "raise_closes_the_trace"])
def test_spans_inside_the_prover(both, monkeypatch, case):
    monkeypatch.delenv("ELP_PHASE_LOG", raising=False)
    _, pd, w, want = both["port"]
    prof = profiler.Profiler(enabled=case != "disabled_traces_nothing")
    calls = []
    permute_host = pos.permute_host

    def counted(state):
        calls.append(1)
        if case == "raise_closes_the_trace" and len(calls) == 20:
            raise RuntimeError("a permutation fails")
        return permute_host(state)

    monkeypatch.setattr(pos, "permute_host", counted)
    if case == "raise_closes_the_trace":
        with pytest.raises(RuntimeError, match="a permutation fails"):
            PORT.pr.prove(pd, w, prof=prof)
        assert prof._traced is None and prof._spans == []
        assert prof.counts["transcript"] > 0 and "_transcript" in prof.times
        return
    if case in ("trace_tiles", "disabled_traces_nothing"):
        text, events = _traced_prove(pd, w, prof)
    else:
        text = _text(PORT, PORT.pr.prove(pd, w, prof=prof))
    assert text == want  # byte for byte the proof made with the profiler off
    if case == "disabled_traces_nothing":
        assert events == [] and prof.times == {} and prof.counts == {}
        assert prof.span("transcript") is prof.span("device_read")  # one shared no-op context
        return
    times, counts = prof.times, prof.counts
    assert set(counts) == COUNTS and SPANS <= set(times)
    if case == "permutations":
        assert counts["transcript_permutations"] == len(calls) > counts["transcript"]
    elif case == "device_reads":
        assert counts["device_read"] == _device_reads(pd, text)
    elif case == "same_proof":
        phases = sum(v for k, v in times.items() if not k.startswith("_"))
        assert times["_transcript"] + times["_device_read"] + times["_sync_wait"] <= phases
    else:  # the spans never overlap, and tile the prove from its first mark to finish()
        assert events[0][2] == "witness_matrix" and events[-1][2] == "fri_queries"
        assert {"transcript", "device_read"} <= {name for _, _, name in events}
        assert all(b <= a2 for (_, b, _), (a2, _, _) in zip(events, events[1:]))
        covered = sum(b - a for a, b, _ in events)
        assert covered >= 0.99 * (events[-1][1] - events[0][0])
        assert sum(name == "transcript" for _, _, name in events) == counts["transcript"]
