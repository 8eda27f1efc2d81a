"""Device times of CUDA work, for the port's measurement scripts
(``chip_smoke.py``, ``scripts/time_torch_kernels.py``).

* :func:`eager_ms` puts CUDA events around a loop of calls.  It reads the
  device time when the device is the bottleneck, and the host's pace when
  each call's Python and launch work takes longer than its kernels.
* :func:`graph_ms` captures the calls once in a CUDA graph and times its
  replays: the device time of the calls' kernels without their host work,
  plus the gap between two kernels of a graph (time a one-element
  ``fill_`` the same way to read that floor).

Whatever a call reads that changes from call to call (a rotating input) is
fixed when the graph is captured.  :func:`card_label` names the card a
number was taken on.  The module imports torch only, so a script can load
it from a file without importing the package.
"""

import statistics
import subprocess

import torch

__all__ = ["card_label", "eager_ms", "graph_ms"]


def card_label(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (the first card's line),
    or ``"cpu"`` for a CPU ``device``."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def eager_ms(fn, launches=100, samples=5):
    """Median ms per call over ``samples`` runs of ``launches`` calls, timed
    with CUDA events after one warm-up call; also returns every sample."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / launches)
    return statistics.median(per_call), per_call


def graph_ms(fn, launches=50, samples=20):
    """Median ms per call over ``samples`` replays of a CUDA graph that holds
    ``launches`` calls of ``fn``, timed with CUDA events; also returns every
    sample.  One warm-up call runs on a side stream first, as capture
    requires, so that anything ``fn`` builds on its first call is built
    outside the graph."""
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
