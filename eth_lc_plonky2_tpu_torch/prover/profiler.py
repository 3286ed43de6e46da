"""Per-phase prover profiling.

Port of ``eth_lc_plonky2_tpu/prover/profiler.py``: hand ``prove`` a
``Profiler(enabled=True)`` and ``prove()`` and ``fri_prove`` record the wall
clock of each phase in its ``times``, ending every phase in
``torch.cuda.synchronize()`` where there is a card, so that work still queued
on the device is not counted with the next phase.  Disabled, a phase mark
costs one attribute test.
"""

from __future__ import annotations

import time

import torch


class Profiler:
    """No-op unless enabled; prove() drives it via phase()."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.times: dict[str, float] = {}
        self._start = None
        self._name = None

    def phase(self, name: str | None):
        """End the previous phase (waiting for the device) and start ``name``."""
        if not self.enabled:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        if self._name is not None:
            self.times[self._name] = self.times.get(self._name, 0.0) + (now - self._start)
        self._name = name
        self._start = now

    def finish(self):
        """End the last phase."""
        self.phase(None)
