"""Exchange volumes, matvec throughput and profiling hooks.

Counterpart of ``lanczos_tpu/utils/metrics.py``:

* :func:`exchange_stats` — per-matvec exchange volume of a sharded
  operator, the same counts as the JAX package's;
* :func:`operator_nnz` — nonzeros of an operator;
* :func:`benchmark_matvec` / :class:`MatvecStats` — matvec time on the
  card, CUDA events around a run of launches after a
  ``torch.cuda.synchronize()`` (the JAX package differenced two chain
  lengths through a scalar readback, an answer to its TPU runtime);
* :func:`profile_trace` — a ``torch.profiler`` trace around a block.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os

import numpy as np
import torch

from .._util import as_torch_dtype, to_numpy
from ..ops.operators import EllOperator, LinearOperator, StencilOperator

__all__ = [
    "MatvecStats",
    "benchmark_matvec",
    "exchange_stats",
    "matvec_stats",
    "operator_nnz",
    "profile_trace",
]


def exchange_stats(op, num_devices: int) -> dict:
    """Per-matvec exchange volume of an operator row-sharded over
    ``num_devices`` ranks: per-rank received elements, bytes, and their
    fraction of the operator dimension M (the reference's writeup bounds
    the surface share at 7-14% for 40-point boxes, notes.tex:332).

    * a StencilOperator (or its z-slab form): 2*halo boundary planes;
    * an EllOperator (or its all-gather form): M - M/D;
    * an EllHaloOperator: the (D, E) export table, (D-1)*E received;
    * a sharded CompositeV2, or its host plan
      (``parallel/composite2.py:plan_composite_v2``): the level halo planes
      plus the planned surface runs (its ``exchange_elements()``).
    """
    from ..parallel.distributed import (
        EllHaloOperator,
        ShardedEllOperator,
        ShardedStencilOperator,
    )

    itemsize = torch.empty(0, dtype=as_torch_dtype(op.dtype)).element_size()
    m = int(op.shape[0])
    if isinstance(op, (StencilOperator, ShardedStencilOperator)):
        halo = max(abs(off[0]) for off in op.offsets)
        recv = 2 * halo * int(np.prod(op.grid_shape[1:]))
        kind = "stencil-zslab-ppermute"
    elif isinstance(op, EllHaloOperator):
        recv = (num_devices - 1) * int(op.export_ids.shape[1])
        kind = "ell-halo-table"
    elif isinstance(op, (EllOperator, ShardedEllOperator)):
        recv = m - m // num_devices
        kind = "ell-allgather"
    elif callable(getattr(op, "exchange_elements", None)):
        recv = int(op.exchange_elements()["total"])
        kind = "composite-v2-surface-runs"
    else:
        raise TypeError(f"no exchange model for {type(op).__name__}")
    return {
        "kind": kind,
        "per_device_recv_elements": int(recv),
        "per_device_recv_bytes": int(recv) * itemsize,
        "fraction_of_m": recv / m,
        "num_devices": int(num_devices),
        "operator_dim": m,
    }


def operator_nnz(op: LinearOperator) -> int:
    """Nonzero count of the operator (stencil taps count once per point)."""
    if isinstance(op, EllOperator):
        return int(np.count_nonzero(to_numpy(op.vals)))
    if isinstance(op, StencilOperator):
        m = op.shape[0]
        k = len(op.offsets)
        has_sep_diag = op.diag is not None and not any(not any(o) for o in op.offsets)
        return m * (k + (1 if has_sep_diag else 0))
    from ..ops.composite import CompositeOperator

    if isinstance(op, CompositeOperator):
        interior = sum(lv.nbox * lv.m**3 * 27 for lv in op.levels)  # taps incl. centre
        return interior + int(np.count_nonzero(to_numpy(op.ifc_vals)))
    raise TypeError(type(op).__name__)


@dataclasses.dataclass
class MatvecStats:
    seconds_per_matvec: float
    effective_gbps: float
    nnz_per_s: float
    m: int
    nnz: int
    device: str
    #: seconds per matvec in each timed sample (empty when not timed here)
    samples: tuple = ()

    def __str__(self):
        return (
            f"SpMV: {self.seconds_per_matvec*1e3:.5f} ms, "
            f"{self.effective_gbps:.1f} GB/s effective, "
            f"{self.nnz_per_s/1e9:.2f} Gnnz/s (M={self.m}, nnz={self.nnz}; {self.device})"
        )


def matvec_stats(op: LinearOperator, seconds: float, device: str) -> MatvecStats:
    """The rates of one matvec of ``op`` that takes ``seconds``.

    Effective bandwidth counts the least traffic of a matrix-free stencil
    apply (read x, write y, read diag); for an ELL operator the matrix
    stream too (cols + vals), the dominant term."""
    m = op.shape[0]
    itemsize = torch.empty(0, dtype=op.dtype).element_size()
    if isinstance(op, EllOperator):
        k = op.cols.shape[1]
        bytes_per = m * k * (itemsize + op.cols.element_size()) + 2 * m * itemsize
    else:
        bytes_per = 3 * m * itemsize
    nnz = operator_nnz(op)
    return MatvecStats(
        seconds_per_matvec=seconds,
        effective_gbps=bytes_per / seconds / 1e9,
        nnz_per_s=nnz / seconds,
        m=m,
        nnz=nnz,
        device=device,
    )


def benchmark_matvec(op: LinearOperator, iters: int = 50, samples: int = 20) -> MatvecStats:
    """Time the matvec of a card-resident operator with CUDA events, after
    a ``torch.cuda.synchronize()``: ``iters`` calls captured in a CUDA
    graph, their x rotating through enough vectors to outgrow the 50 MB L2
    (so each call reads x from memory, as in a solve), replays timed with
    CUDA events (``utils/timing.py:graph_ms``), the median of ``samples``
    replays (each in ``.samples``).  That is the device time without the
    wrapper's host work.  An operator on the CPU has no device time and
    raises."""
    from .timing import graph_ms

    dev = op.device
    if dev.type != "cuda":
        raise ValueError(f"benchmark_matvec times the card; the operator is on {dev}")
    n = op.shape[0]
    x_bytes = n * torch.empty(0, dtype=op.dtype).element_size()
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.rand(n, generator=gen, dtype=op.dtype, device=dev)
          for _ in range(min(8, max(1, -(-(100 << 20) // x_bytes))))]
    turn = itertools.cycle(xs)
    torch.cuda.synchronize(dev)
    ms, per_call = graph_ms(lambda: op.matvec(next(turn)), iters, samples)
    return dataclasses.replace(matvec_stats(op, ms / 1e3, torch.cuda.get_device_name(dev)),
                               samples=tuple(t / 1e3 for t in per_call))


@contextlib.contextmanager
def profile_trace(logdir: str):
    """``torch.profiler`` around a block (CPU activity, and the card's when
    one is present); the Chrome trace goes to ``logdir/trace.json``.
    Yields the profiler (``key_averages()``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
