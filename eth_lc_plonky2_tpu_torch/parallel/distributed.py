"""Start a multi-process prover: one process a rank, on torch.distributed.

Port of ``eth_lc_plonky2_tpu/parallel/distributed.py``.  Every rank runs the
same ``prove_sharded`` in lockstep on the same host words, as the JAX
package's multi-controller program does, and the exchanges between them are
the ``Mesh``'s collectives.

Usage, one call a process before any other work:

    from eth_lc_plonky2_tpu_torch.parallel import distributed as dist
    dist.initialize()             # ELP_* or torchrun's variables
    mesh = dist.make_global_mesh()

``initialize`` takes the coordinator's address (``host:port``, or an
``init_method`` URL such as ``tcp://host:port`` or ``file:///path``), the
process count and this process's index, from its arguments, else from
ELP_COORDINATOR, ELP_NUM_PROCESSES and ELP_PROCESS_ID, else from
torch.distributed's own ``env://`` variables (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK: what ``torchrun`` sets).  It picks NCCL for the card and
gloo for ``device="cpu"`` unless a backend is named; without a card the
default raises, and a failed initialisation raises.
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as tdist

from ..ops import goldilocks as gl
from .mesh import Mesh

TIMEOUT = datetime.timedelta(seconds=1800)  # a collective that waits longer raises
_state: dict = {}


def _init_method(address: str | None) -> str:
    if address is None:
        return "env://"
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, device: str = "cuda",
               backend: str | None = None) -> None:
    """Join the job: explicit arguments, then the ELP_* variables, then
    ``env://``.  ``device`` is where this rank's tensors live: "cuda" (this
    rank's card, ``cuda:<local rank>``; NCCL), "cuda:<i>" (that card: ranks
    may share one, and then name gloo) or "cpu" (gloo)."""
    coordinator_address = coordinator_address or os.environ.get("ELP_COORDINATOR")
    if num_processes is None and os.environ.get("ELP_NUM_PROCESSES"):
        num_processes = int(os.environ["ELP_NUM_PROCESSES"])
    if process_id is None and os.environ.get("ELP_PROCESS_ID"):
        process_id = int(os.environ["ELP_PROCESS_ID"])
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"]) if "WORLD_SIZE" in os.environ else None
    if process_id is None:
        process_id = int(os.environ["RANK"]) if "RANK" in os.environ else None
    if num_processes is None or process_id is None:
        raise ValueError("the process count and this process's index are not given (arguments, "
                         "ELP_NUM_PROCESSES / ELP_PROCESS_ID or WORLD_SIZE / RANK)")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    tdist.init_process_group(backend, init_method=_init_method(coordinator_address),
                             world_size=num_processes, rank=process_id,
                             timeout=TIMEOUT, **kwargs)
    _state["device"] = dev


def make_global_mesh() -> Mesh:
    """The 1-D mesh over every rank of the job, on the device that
    ``initialize`` chose for this rank."""
    if not tdist.is_initialized():
        raise RuntimeError("call initialize() first")
    return Mesh(_state["device"])


def is_multiprocess() -> bool:
    return tdist.is_initialized() and tdist.get_world_size() > 1


def fetch(t: torch.Tensor, mesh: Mesh, axis: int) -> np.ndarray:
    """Device -> host as u64 words of the whole tensor: ``t`` is this rank's
    block of ``axis``, and the blocks of every rank are gathered in rank order
    first, so that every rank's transcript sees the same words."""
    return gl.to_u64(torch.cat(list(mesh.all_gather(t)), dim=axis))


def spawn_ranks(target, size: int, args: tuple = ()) -> tuple:
    """Start ``size`` spawned processes, ``target(rank, size, *args, queue)``
    each, where a rank puts ``(rank, results)`` on ``queue`` before it exits:
    (the processes, the queue).  ``collect_ranks`` reads them."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, size, *args, queue)) for r in range(size)]
    for p in procs:
        p.start()
    return procs, queue


def collect_ranks(procs: list, queue, timeout_s: float) -> dict:
    """{rank: results} of the ranks ``spawn_ranks`` started.  A rank that
    exits with a non-zero code or without its results raises at once, and so
    do ranks that have not all put their results within ``timeout_s``; every
    process is ended before this returns."""
    import queue as queue_mod

    results: dict = {}
    deadline = time.monotonic() + timeout_s
    silent = False  # a rank exited without results at the last look
    try:
        while len(results) < len(procs):
            try:
                rank, out = queue.get(timeout=2)
                results[rank] = out
            except queue_mod.Empty:
                # a rank's results are in the pipe before it exits: one more
                # wait after a rank exited without them reads what it put
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes) or silent \
                        or time.monotonic() > deadline:
                    raise RuntimeError(f"the ranks failed or did not finish: exit codes {codes}, "
                                       f"results from {sorted(results)}") from None
                silent = any(c == 0 and r not in results for r, c in enumerate(codes))
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        raise RuntimeError(f"rank exit codes {codes}")
    return results


def shutdown() -> None:
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _state.clear()
