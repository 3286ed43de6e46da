"""Per-phase prover profiling.

Port of ``eth_lc_plonky2_tpu/prover/profiler.py``.  Enable with
ELP_PROFILE=1 (or hand ``prove`` a ``Profiler(enabled=True)``): ``prove()``
and ``fri_prove`` then record the wall clock of each phase in ``times``,
ending every phase in ``torch.cuda.synchronize()`` where there is a card, so
that work still queued on the device is not counted with the next phase; the
time spent in those waits is also summed under ``_sync_wait`` (a share of the
phases, not a phase).  ``finish()`` returns the record, keeps it in
``last_profile`` and, when ELP_PROFILE is set, prints it as one
``ELP_PROFILE <json>`` line on stdout; ELP_PHASE_LOG=1 as well prints each
phase's start on stderr.

``span(name)`` marks a stretch of host work that runs inside the phases, where
no phase mark can isolate it: the transcript's permutations (``transcript``)
and the host's blocking reads of device data (``device_read``).  It never
synchronizes.  Its host seconds are summed under ``times["_" + name]`` (like
``_sync_wait``, a share of the phases, not a phase: no key that starts with
``_`` is summed as a phase) and its entries under ``counts[name]``.  Spans may
nest.

Enabled, the profiler also opens ``torch.profiler.record_function`` spans
named ``phase:<label>`` that tile the host's time on the trace's clock: the
current phase, or while a span is open the innermost span, each closed before
the next opens.  No two of them overlap, so a trace's idle gaps can be
labelled by what the host was doing.  ``close()`` closes the open one; a
prove closes it on an exception too.

The phases are the JAX package's and one more, ``witness_upload`` (the witness
matrix's copy to the device), which the JAX package counts in
``witness_matrix``.  Disabled, a phase mark costs one attribute test, and
``span`` returns one shared no-op context after one attribute test.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch

last_profile: dict | None = None
TRACE_PREFIX = "phase:"
_NO_SPAN = contextlib.nullcontext()


def _switch(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0")


class Profiler:
    """No-op unless enabled; prove() drives it via phase()."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._t0 = time.perf_counter()
        self._start = None
        self._name = None
        self._spans: list[str] = []  # the open spans, innermost last
        self._traced = None  # the open record_function span

    @classmethod
    def current(cls) -> "Profiler":
        """A profiler that is enabled when ELP_PROFILE is set (and not "0")."""
        return cls(enabled=_switch("ELP_PROFILE"))

    def phase(self, name: str | None):
        """End the previous phase (waiting for the device) and start ``name``."""
        if not self.enabled:
            return
        now_sync = time.perf_counter()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        if self._name is not None:
            self.times[self._name] = self.times.get(self._name, 0.0) + (now - self._start)
            self.times["_sync_wait"] = self.times.get("_sync_wait", 0.0) + (now - now_sync)
        if _switch("ELP_PHASE_LOG"):
            print(f"[prove +{now - self._t0:7.1f}s] phase {name}", file=sys.stderr, flush=True)
        self._name = name
        self._start = now
        if not self._spans:
            self._trace(name)

    def span(self, name: str):
        """A context that adds its host seconds to ``times["_" + name]`` and 1
        to ``counts[name]``, and labels the trace ``phase:<name>`` while it is
        open; the shared no-op context when disabled."""
        if not self.enabled:
            return _NO_SPAN
        return self._opened(name)

    @contextlib.contextmanager
    def _opened(self, name: str):
        self._spans.append(name)
        self._trace(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            key = "_" + name
            self.times[key] = self.times.get(key, 0.0) + (time.perf_counter() - t0)
            self.counts[name] = self.counts.get(name, 0) + 1
            self._spans.pop()
            self._trace(self._spans[-1] if self._spans else self._name)

    def _trace(self, label: str | None):
        """Close the open trace span and open ``phase:<label>`` (none for
        None)."""
        if self._traced is not None:
            self._traced.__exit__(None, None, None)
            self._traced = None
        if label is not None:
            self._traced = torch.profiler.record_function(TRACE_PREFIX + label)
            self._traced.__enter__()

    def close(self):
        """Close the open trace span (after ``finish`` there is none)."""
        self._trace(None)

    def count(self, name: str, inc: int = 1):
        if self.enabled:
            self.counts[name] = self.counts.get(name, 0) + inc

    def finish(self) -> dict | None:
        """End the last phase and return the record: the total, the phases by
        time (longest first) and the counts."""
        global last_profile
        if not self.enabled:
            return None
        self.phase(None)
        self._name = None
        total = time.perf_counter() - self._t0
        out = {
            "total_s": round(total, 3),
            "phases": {k: round(v, 4) for k, v in sorted(self.times.items(), key=lambda kv: -kv[1])},
            "counts": self.counts,
        }
        last_profile = out
        if _switch("ELP_PROFILE"):
            print("ELP_PROFILE " + json.dumps(out), flush=True)
        return out
