"""Start a row mesh of local processes and run one function on every rank.

:func:`run_ranks` spawns ``world_size`` processes on this host, joins them
into one process group through :func:`~.mesh.initialize_distributed`
(gloo on the CPU, NCCL on cards, one card per rank) and calls
``fn(mesh, *args)`` on each.  It returns every rank's result in rank
order, and raises, killing every rank, when a rank fails or the run
outlasts ``timeout``, so that a rank stuck in a collective never hangs its
caller.  ``fn`` must be importable by name (a module-level function):
spawned processes start from a fresh import.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import socket
import time
import traceback

from .._util import DEFAULT_DEVICE

__all__ = ["free_port", "run_ranks"]


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, port, device, timeout, fn, args, results):
    import torch
    import torch.distributed as dist

    from .mesh import initialize_distributed, make_row_mesh

    torch.set_num_threads(1)  # ranks share the host's cores
    try:
        initialize_distributed("127.0.0.1", port, world_size, rank, rank, device=device,
                               timeout=datetime.timedelta(seconds=timeout))
        results.put((rank, True, fn(make_row_mesh(), *args)))
    except BaseException:  # reported to the parent, which stops every rank
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, device: str = DEFAULT_DEVICE,
              timeout: float = 300.0):
    """``[fn(mesh, *args) on rank r for r in range(world_size)]``, each rank
    a spawned process with one CPU thread (NCCL ranks, one card each, unless
    ``device="cpu"`` asks for gloo ranks).  Raises RuntimeError
    with the failing rank's traceback, or TimeoutError after ``timeout``
    seconds; either way every rank is killed first."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [
        ctx.Process(target=_rank_main, daemon=True,
                    args=(r, world_size, port, device, timeout, fn, args, results))
        for r in range(world_size)
    ]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} did not finish "
                                   f"within {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in out]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} of {fn.__name__} died with exit code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if any(p.is_alive() for p in procs):
        raise RuntimeError(f"a rank of {fn.__name__} could not be stopped")
    return [out[r] for r in range(world_size)]
