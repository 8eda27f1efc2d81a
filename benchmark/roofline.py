"""The yardstick's arithmetic: the H100's published peaks, the compulsory
bytes of the stencil kernels counted from shapes, and the device time of a
call replayed in a CUDA graph.

A roofline share is the least time the card could take (compulsory bytes
over the published HBM rate) divided by the measured time.  The bytes
depend only on the shapes, not on which kernel computes ``H x``, so a
share keeps measuring the same work after a kernel is replaced.
"""

from __future__ import annotations

import itertools
import statistics

#: NVIDIA H100 SXM5 80 GB data sheet, dense rates at the 700 W limit.
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops": 67e12,
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
}

__all__ = ["PEAKS", "spmv_bytes", "spmm_bytes", "least_ms", "graph_ms", "rotating_inputs"]


def spmv_bytes(points: int, itemsize: int, has_diag: bool = True) -> int:
    """Compulsory bytes of one stencil ``y = H x`` on ``points`` points:
    read x, write y, and read the diagonal where there is one."""
    return points * itemsize * (2 + int(has_diag))


def spmm_bytes(points: int, itemsize: int, b: int, has_diag: bool = True) -> int:
    """Compulsory bytes of one stencil ``Y = H X`` over an (M, b) block:
    read X, write Y (b values a point each), read the diagonal once."""
    return points * itemsize * (2 * b + int(has_diag))


def least_ms(nbytes: int, peak: float = PEAKS["hbm_bytes_per_s"]) -> float:
    """The least time in ms to move ``nbytes`` at the published HBM rate."""
    return nbytes / peak * 1e3


def rotating_inputs(make, nbytes_each: int, l2_bytes: int = 50 << 20):
    """Enough inputs, each made by ``make(i)``, that the other inputs one
    cycle reads between two uses of an input outgrow four times the L2
    (``nbytes_each``: what one call reads and writes), cycled: every call
    reads its input from memory."""
    count = 1 + max(1, -(-(4 * l2_bytes) // nbytes_each))
    return itertools.cycle([make(i) for i in range(count)])


def graph_ms(fn, launches: int = 50, samples: int = 20):
    """Median ms per call over ``samples`` replays of a CUDA graph holding
    ``launches`` calls of ``fn``, timed with CUDA events, and every sample.
    One warm-up call runs on a side stream first, as capture requires."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / launches)
    del graph
    torch.cuda.synchronize()
    return statistics.median(per_call), per_call
