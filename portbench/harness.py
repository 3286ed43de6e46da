"""One run of one cell: find the cell's files by name, set up, warm up, run the
window, judge the proofs, print the result.

Everything that belongs to one configuration, traffic mix or per-layer metric
is a file of its own under the benchmark's directory, found by the name that
``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the configuration as it is run; its ``circuit``
  key names the set-up module ``circuits/<circuit>.py`` (the program's side)
  and the statement module ``reference/<circuit>.py`` (the reference's side);
- ``reference/circuits/<config>.json``: the frozen circuit and verification
  key that the judge holds proofs against;
- ``traffic/<traffic>.json``: the mix's parameters; its ``driver`` key names
  the module ``drivers/<driver>.py`` whose ``drive(...)`` runs the window;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(record)`` ->
  a number, or None where it finds nothing to read.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "eth_lc_plonky2_tpu")
WINDOW = "portbench:window"
WARM = "portbench:warm"
PHASE = "phase:"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object
    end_to_end: list
    per_layer: list
    bench_dir: Path


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from its file, by path (a name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(root: Path, workload: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell named ``workload`` in ``root/BENCHMARK.json``, its files read."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[entry["config"]]["file"])
    traffic = _load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    driver = load_module(bench_dir / "drivers" / f"{traffic['driver']}.py", traffic["driver"])
    return Cell(
        name=workload, chips=entry["chips"], config=config, traffic=traffic, driver=driver,
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"], bench_dir=bench_dir,
    )


def forbidden_modules() -> list:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


class Context:
    """What a set-up module is handed: the device, the circuit cache's
    directory and the log."""

    def __init__(self, device: str, cache_root: Path):
        self.device = device
        self.cache_root = cache_root
        cache_root.mkdir(parents=True, exist_ok=True)

    @staticmethod
    def log(msg: str) -> None:
        print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def _span_profiler():
    """The program's ``Profiler``, enabled, that also opens a
    ``record_function`` span for each phase, so that the trace's idle gaps can
    be labelled by the phase the host was in."""
    import torch

    from eth_lc_plonky2_tpu_torch.prover.profiler import Profiler

    class SpanProfiler(Profiler):
        def __init__(self):
            super().__init__(enabled=True)
            self._span = None

        def phase(self, name):
            super().phase(name)
            if self._span is not None:
                self._span.__exit__(None, None, None)
                self._span = None
            if name is not None:
                self._span = torch.profiler.record_function(PHASE + name)
                self._span.__enter__()

    return SpanProfiler()


class HostWatch:
    """What the host did in the window, for the noise of the host's clock:
    the Python collector's pauses by generation, the process's CPU seconds,
    its context switches and page faults, and the machine's steal time."""

    def __enter__(self):
        import resource

        self._resource = resource
        self.gc_s = [0.0, 0.0, 0.0]
        self.gc_n = [0, 0, 0]
        self._gc_t0 = None
        gc.callbacks.append(self._gc)
        self._u0 = resource.getrusage(resource.RUSAGE_SELF)
        self._steal0 = _steal_ticks()
        self._t0 = time.perf_counter()
        return self

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            g = info["generation"]
            self.gc_s[g] += time.perf_counter() - self._gc_t0
            self.gc_n[g] += 1
            self._gc_t0 = None

    def __exit__(self, *exc):
        wall = time.perf_counter() - self._t0
        gc.callbacks.remove(self._gc)
        u1 = self._resource.getrusage(self._resource.RUSAGE_SELF)
        u0 = self._u0
        steal1 = _steal_ticks()
        self.record = {
            "wall_s": wall, "user_s": u1.ru_utime - u0.ru_utime,
            "sys_s": u1.ru_stime - u0.ru_stime,
            "minor_faults": u1.ru_minflt - u0.ru_minflt,
            "voluntary_switches": u1.ru_nvcsw - u0.ru_nvcsw,
            "involuntary_switches": u1.ru_nivcsw - u0.ru_nivcsw,
            "gc_s": self.gc_s, "gc_n": self.gc_n,
            "steal_s": (None if self._steal0 is None or steal1 is None
                        else (steal1 - self._steal0) / os.sysconf("SC_CLK_TCK")),
        }
        return False


def _steal_ticks():
    """The machine's steal time in clock ticks, summed over its CPUs, or None."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) if fields[0] == "cpu" and len(fields) > 8 else None
    except OSError:
        return None


def _disabled():
    from eth_lc_plonky2_tpu_torch.prover.profiler import Profiler

    return Profiler(enabled=False)


_VERIFY = (
    "import json, sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "from portbench.reference.judge import verify_proof\n"
    "job = json.load(sys.stdin)\n"
    "print(json.dumps(verify_proof(job['frozen'], job['proof'])))\n"
)


def _verify_all(frozen: dict, plain: dict) -> dict:
    """Each proof verified by the frozen verifier in a process of its own, all
    at once (the verifier is pure Python); each process is waited for."""
    root = str(Path(__file__).resolve().parents[1])
    procs = {}
    for i, proof in plain.items():
        procs[i] = subprocess.Popen([sys.executable, "-c", _VERIFY, root], stdin=subprocess.PIPE,
                                    stdout=subprocess.PIPE, text=True)
        procs[i].stdin.write(json.dumps({"frozen": frozen, "proof": proof}))
        procs[i].stdin.close()
    verdicts = {}
    for i, proc in procs.items():
        out = proc.stdout.read()
        proc.stdout.close()
        if proc.wait() != 0:
            verdicts[i] = f"the verifier's process exited with {proc.returncode}"
        else:
            verdicts[i] = json.loads(out)
    return verdicts


def judge(cell: Cell, proofs: list, expected: list, prove_error) -> dict:
    """The numbers compared, each with its limit: every window proof equal to
    the first window proof of its witness, that proof verified by the frozen
    verifier against the frozen circuit and key, and its public inputs the
    statement the reference works out from the inputs."""
    from portbench import proofs as pp
    from portbench.reference import judge as ref

    digests = [pp.digest(p) for _, p in proofs]
    first = {}
    for pos, (i, _) in enumerate(proofs):
        first.setdefault(i, pos)
    mismatched = sum(digests[pos] != digests[first[i]] for pos, (i, _) in enumerate(proofs))
    plain = {i: pp.to_plain(proofs[pos][1]) for i, pos in first.items()}
    frozen = ref.frozen_circuit(cell.config["name"], cell.bench_dir / "reference")
    verdicts = _verify_all(frozen, plain)
    for i, why in verdicts.items():
        if why:
            Context.log(f"witness {i}: the verifier rejects its proof: {why}")
    pi_wrong = [i for i, d in plain.items() if ref.public_inputs(d) != list(expected[i])]
    for i in pi_wrong:
        Context.log(f"witness {i}: public inputs {ref.public_inputs(plain[i])} != the "
                    f"statement's {list(expected[i])}")
    failed_positions = {pos for pos, (i, _) in enumerate(proofs)
                        if digests[pos] != digests[first[i]] or verdicts[i] or i in pi_wrong}
    checks = {
        "prove_errors": {"value": int(prove_error is not None), "limit": 0},
        "proofs_unverified": {"value": sum(1 for v in verdicts.values() if v), "limit": 0},
        "statements_wrong": {"value": len(pi_wrong), "limit": 0},
        "proofs_differing": {"value": mismatched, "limit": 0},
        "witnesses_proved": {"value": len(first), "limit": len(expected)},
    }
    correct = (all(c["value"] <= c["limit"] for k, c in checks.items() if k != "witnesses_proved")
               and checks["witnesses_proved"]["value"] == len(expected))
    return {"correct": correct, "failed": len(failed_positions) + int(prove_error is not None),
            "checks": checks}


def kernel_name(name: str) -> str:
    """A device operation's short name: a kernel of the program by its own name
    (``sponge_kernel``), one of PyTorch's as ``torch:`` and its kernel's name,
    a copy or a set as the trace names it."""
    own = re.search(r"\(anonymous namespace\)::(\w+_kernel)\b", name)
    if own:
        return own.group(1)
    if "at::native::" in name:
        inner = re.search(r"at::native::(?:\(anonymous namespace\)::)?(\w+)", name)
        return "torch:" + inner.group(1)
    return name[:80]


def _trace_record(prof, window_name: str = WINDOW) -> dict:
    """Device busy time, kernel time by name and idle gaps by host phase,
    within the window's span, from a ``torch.profiler`` trace."""
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == window_name and e.device_type.name == "CPU"]
    if not spans:
        return {}
    w0, w1 = spans[0]
    phases = sorted((e.time_range.start, e.time_range.end, e.name[len(PHASE):]) for e in events
                    if e.device_type.name == "CPU" and e.name.startswith(PHASE)
                    and e.time_range.end > w0 and e.time_range.start < w1)
    kernel_s, kernel_n, intervals = {}, {}, []
    for e in events:
        if e.device_type.name == "CPU" or e.name.startswith((PHASE, "portbench:", "ProfilerStep")):
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        name = kernel_name(e.name)
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) / 1e6
        kernel_n[name] = kernel_n.get(name, 0) + 1
        intervals.append((a, b))
    intervals.sort()
    busy, gaps, cursor = 0.0, [], w0
    for a, b in intervals:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if w1 > cursor:
        gaps.append((cursor, w1))
    idle_by_phase = {}
    starts = [p[0] for p in phases]
    for a, b in gaps:
        mid = (a + b) / 2
        k = bisect.bisect_right(starts, mid) - 1
        label = phases[k][2] if k >= 0 and phases[k][1] >= mid else "between_phases"
        idle_by_phase[label] = idle_by_phase.get(label, 0.0) + (b - a) / 1e6
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6, "kernel_s": kernel_s,
            "kernel_launches": kernel_n, "idle_by_phase": idle_by_phase}


def _families(per_layer: list, bench_dir: Path) -> set:
    names = set()
    for m in per_layer:
        module = load_module(bench_dir / "metrics" / f"{m['name']}.py", m["name"])
        names.update(getattr(module, "KERNELS", ()))
    return names


def prepare(cell: Cell, seed: int, device: str = "cuda") -> tuple:
    """The cell's set-up for ``seed``: (context, the set-up module's dict with
    ``pd``, ``witnesses``, ``raws``, ``circuit_s``, ``witness_gen_s``)."""
    ctx = Context(device, cell.bench_dir / ".cache" / "circuits")
    kind = cell.config["circuit"]
    setup_mod = load_module(cell.bench_dir / "circuits" / f"{kind}.py", kind)
    return ctx, setup_mod.setup(cell.config, cell.traffic, seed, ctx)


def statements(cell: Cell, raws: list) -> list:
    """The public inputs the reference works out from each witness's raw
    inputs."""
    kind = cell.config["circuit"]
    statement = load_module(cell.bench_dir / "reference" / f"{kind}.py", "statement_" + kind)
    return [statement.expected_public_inputs(raw) for raw in raws]


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_process: float,
        device: str = "cuda", out_dir: Path | None = None, prove=None) -> tuple:
    """Set up, warm up, run the window and judge it: (result dict, record).
    ``prove`` stands in for the program's ``prove`` in the window (the
    control and the faults of the tests)."""
    import torch

    from eth_lc_plonky2_tpu_torch.prover import prove as pr

    from portbench import program

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    prove = prove or pr.prove
    ctx, prepared = prepare(cell, seed, device)
    pd, witnesses, raws = prepared["pd"], prepared["witnesses"], prepared["raws"]
    for w in witnesses:  # every shape the window uses, and every table the prover caches
        pr.prove(pd, w, prof=_disabled())
    sync()
    setup_s = time.time() - t_process
    ctx.log(f"set-up {setup_s:.3f} s; window of {seconds} s begins")
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    record = {"setup": {"setup_s": setup_s, "circuit_s": prepared["circuit_s"],
                        "witness_gen_s": prepared["witness_gen_s"]},
              "shapes": program.shapes(pd)}
    # On the card the window is always traced, for the card's busy time; only
    # --trace 1 marks the program's phases, each ending in a synchronize.
    if trace or on_card:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=activities) as prof:
            with record_function(WARM):  # a trace loses the first device records after a long host phase
                prove(pd, witnesses[0], prof=_disabled())
                sync()
            with record_function(WINDOW), HostWatch() as host:
                window = cell.driver.drive(prove, pd, witnesses, seconds, sync,
                                           _span_profiler if trace else _disabled)
        record["trace"] = _trace_record(prof)
        del prof
    else:
        with HostWatch() as host:
            window = cell.driver.drive(prove, pd, witnesses, seconds, sync, _disabled)
    record["host"] = host.record
    record["host"]["gc_tracked_objects"] = len(gc.get_objects())
    ctx.log("host in the window: " + json.dumps(record["host"]))
    proofs, window_s, error = window["proofs"], window["seconds"], window["error"]
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_modules()
    if found:
        raise ImportError(f"modules of JAX or the JAX package are loaded: {found}")
    record["profiles"] = [dict(p.times) for p in window["profilers"]] if trace else []
    record["proofs"] = [{"witness": i, "pow_witness": int(p.fri_proof.pow_witness)}
                        for i, p in proofs]
    record["window"] = {"seconds": window_s, "proofs": len(proofs), "error": error,
                        "prove_s": window["prove_s"]}
    if error:
        ctx.log(f"a prove raised: {error}")

    # the judge runs after the window, with the prover's state freed
    del pd, witnesses, prepared, window
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    verdict = judge(cell, proofs, statements(cell, raws), error)
    record["judge_s"] = time.perf_counter() - t0
    ctx.log(f"judged {len(proofs)} proofs in {record['judge_s']:.3f} s")
    result = _result(cell, record, verdict, proofs, error, window_s, setup_s, trace,
                     _device(cell.chips, memory_peak, on_card))
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{cell.name}.seed{seed}.trace{int(trace)}.{int(t_process)}.json"
        with open(path, "w") as f:
            json.dump({"result": result, "record": record}, f, default=str)
    return result, record


def _result(cell, record, verdict, proofs, error, window_s, setup_s, trace, device) -> dict:
    if trace:
        metrics = {}
        for m in cell.per_layer:
            module = load_module(cell.bench_dir / "metrics" / f"{m['name']}.py", m["name"])
            value = module.read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        busy_s = record.get("trace", {}).get("busy_s", 0.0)
        measured = {"device_busy_ms": 1e3 * busy_s / len(proofs) if proofs and busy_s > 0 else None,
                    "setup_s": setup_s}
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if measured.get(m["name"]) is not None}
    result = {
        "correct": verdict["correct"],
        "attempted": len(proofs) + int(error is not None),
        "failed": verdict["failed"],
        "metrics": metrics,
        "device": device,
    }
    if trace and record.get("trace"):
        t = record["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        listed = _families(cell.per_layer, cell.bench_dir)
        ops = sorted(t["kernel_s"].items(), key=lambda kv: -kv[1])
        unassigned = {n for n, _ in ops
                      if n not in listed and not n.startswith(("Memcpy", "Memset"))}
        if unassigned:
            Context.log(f"kernels no family lists: {sorted(unassigned)}")
        result["breakdown"] = {
            "device_ops": [["unassigned:" + n if n in unassigned else n, s]
                           for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in sorted(t["idle_by_phase"].items(),
                                                     key=lambda kv: -kv[1])[:10]],
        }
    result["checks"] = verdict["checks"]
    return result


def _device(chips: int, memory_peak: int, on_card: bool) -> dict:
    import torch

    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(memory_peak)}
