"""A closed loop of one prover: the witnesses proved in turn, back to back,
until the window's seconds have passed and each witness has been proved; the
last proof started inside the window is waited for."""

from __future__ import annotations

import time


def drive(prove, pd, witnesses: list, seconds: float, sync, new_profiler) -> dict:
    """``proofs`` as (witness index, proof), the window's ``seconds``, the
    ``error`` that stopped it or None, each proof's ``profiler`` and its
    ``prove_s``."""
    proofs, profilers, times, error = [], [], [], None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k = 0
    while True:
        i = k % len(witnesses)
        prof = new_profiler()
        t1 = time.perf_counter()
        try:
            proof = prove(pd, witnesses[i], prof=prof)
            sync()
        except Exception as e:  # the run reports it as a failed proof
            error = f"{type(e).__name__}: {e}"
            break
        proofs.append((i, proof))
        times.append(time.perf_counter() - t1)
        profilers.append(prof)
        k += 1
        if time.perf_counter() >= deadline and k >= len(witnesses):
            break
    return {"proofs": proofs, "seconds": time.perf_counter() - t0, "error": error,
            "profilers": profilers, "prove_s": times}
