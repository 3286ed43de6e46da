"""Host/device pipeline overlap: the streaming prover.

Port of ``eth_lc_plonky2_tpu/prover/pipeline.py``.  In the production
serving shape — one resident circuit proving a stream of light-client
updates — the host-side witness pass (the generator sweeps over the
(rows x wires) matrix) would serialize with device work if each update
were proven sequentially.  `prove_stream` double-buffers: witness
generation for update k+1 runs in a worker thread while the caller's
thread proves update k, so steady-state throughput approaches
max(prove, witness) instead of their sum.

The worker does host work only: it calls ``make_witness``, which builds a
``Witness`` with numpy and Python, and touches no CUDA state; every
tensor, upload and kernel launch stays on the caller's thread, inside
``prove``.  Proofs are yielded strictly in input order and are
byte-identical to sequential `prove` calls (same witness values, same
transcript).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

from . import prove as pr


def prove_stream(
    pd: pr.ProverData,
    witness_inputs: Iterable,
    make_witness: Callable,
    prefetch: int = 1,
) -> Iterator[pr.Proof]:
    """Prove a stream of updates with witness generation overlapped.

    witness_inputs: iterable of per-update inputs (e.g. the
    witness_kwargs dicts the CLI assembles).
    make_witness(pd.data, item) -> generated Witness for one update.
    prefetch: how many witnesses may be in flight ahead of the prover.

    Yields Proof objects in input order; an error raised by the worker
    is raised here, after the proofs of the items before it.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
    _END = object()
    errors: list = []

    def worker():
        try:
            for item in witness_inputs:
                q.put(make_witness(pd.data, item))
        except BaseException as e:  # surface in the consumer
            errors.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        w = q.get()
        if w is _END:
            break
        yield pr.prove(pd, w)
    t.join()
    if errors:
        raise errors[0]
