"""Restart cycles as CUDA graphs: the port's counterpart of the JAX
package's compiled cycles (``lanczos_tpu/solver/arnoldi.py:_ks_cycle_jit``,
``lanczos_tpu/solver/restart.py:_cycle_jit``,
``lanczos_tpu/solver/block.py:_block_cycle_jit``, ``jax.jit`` with
``static_argnames``) and of the refinement's compiled units
(``lanczos_tpu/solver/refine.py:_deflated_cg``, ``_deflated_bicgstab``,
``_dd_residual_cols``; ``solver/refine.py`` here).

A Krylov–Schur, thick-restart or block cycle is m - l steps, each a matvec
(~28 launches on a CompositeV2) or an SpMM, CGS2's GEMVs and the norms:
thousands of small launches whose host work, eager, outlasts their device
time.
:class:`CycleGraphs` runs such a cycle as one ``torch.cuda.CUDAGraph``
replay, which launches the very kernels of the eager body, in its order and
with its arguments.

* The first cycle of a solver call runs eagerly on a side stream, as
  PyTorch asks before a capture: it fills every kernel's launch cache and
  cuBLAS's handle and workspace for that stream.  So does the first cycle
  after the operator's tensors changed.  A caller whose units differ in
  what they launch (the refinement: a residual on the float64 operator,
  a solve on the float32 one, a narrower tail chunk) asks for
  ``warm_each_key``: the first call of each static key runs eagerly.
* Every later cycle replays a graph captured on that stream the first time
  its static arguments (the caller's key: l, m, reorth_passes, compensated,
  dtype) were seen with the operator's tensors as they are.  The key holds
  the address and version of every buffer of the operator (a stencil's
  weights, which its kernel takes by value at capture; its diag; the
  interface tables), so a change forces an eager cycle and a new capture,
  never a stale replay.
* A graph reads and writes fixed addresses: the cycle's tensor arguments
  are the caller's static buffers (checked at every replay), and its
  outputs belong to the graph, overwritten by the next replay, so the
  caller reads or copies them first.
* The graphs belong to one solver call and go with it, so no graph
  outlives the operator whose pointers it holds.  They share one memory
  pool: what one capture frees, the next may take, which is safe because
  every caller reads a graph's outputs before it runs another.
* The kernel wrappers count a launch where they launch; a capture launches
  nothing, so what a capture added to the counts is taken back, and each
  replay adds it once (:func:`_take_back`, :meth:`_Graph.replay`).

* A row-sharded operator over an NCCL group captures its collectives
  with the cycle: each is a kernel on the group's stream, joined to the
  capturing stream by events, with host-side split lists; the first
  (eager) cycle has run every collective of the cycle, so the
  communicator exists before the capture.  A gloo group's collectives run
  on the host, so its operators (on the CPU) run the eager body.

CPU tensors run the eager body on the current stream.  On a card a
capture that fails raises; nothing falls back to the eager loop.
"""

from __future__ import annotations

import contextlib
import itertools
import time

import torch

__all__ = ["CycleGraphs", "capturable", "cycle_key", "eager", "reset_stats", "stats"]

#: Counts over every solver call since :func:`reset_stats`: the cycles
#: run eagerly by a capturing solver, the graphs captured and their host
#: seconds (capture and instantiation), the replays, the block cycles run
#: again with the breakdown cure (``solver/block.py``), and the static key
#: of every cycle run, eager or replayed.
stats = {"eager": 0, "captures": 0, "capture_s": 0.0, "replays": 0, "redo": 0, "cycles": []}

_eager_only = False


def reset_stats() -> None:
    stats.update(eager=0, captures=0, capture_s=0.0, replays=0, redo=0, cycles=[])


@contextlib.contextmanager
def eager():
    """Within it, solvers run every cycle as the eager body on the current
    stream, as on the CPU: the reference that a measurement holds the
    captured cycles against."""
    global _eager_only
    before, _eager_only = _eager_only, True
    try:
        yield
    finally:
        _eager_only = before


def capturable(op) -> bool:
    """True for an operator whose cycles run as graphs: on a CUDA device,
    unsharded or row-sharded over an NCCL group."""
    if op.device.type != "cuda":
        return False
    mesh = getattr(op, "mesh", None)
    return mesh is None or mesh.backend == "nccl"


def cycle_key(op, static: tuple) -> tuple:
    """The graph cache's key of a cycle with static arguments ``static``:
    (``static``, the operator's identity and the address and version of
    each of its buffers and parameters, its submodules' included)."""
    tensors = itertools.chain(op.named_buffers(), op.named_parameters())
    return static, (id(op), *((name, t.data_ptr(), t._version) for name, t in tensors))


def _wrappers():
    from ..ops.interface_kernel import apply_fused_interface
    from ..ops.stencil_kernels import stencil_spmm, stencil_spmv

    return stencil_spmv, stencil_spmm, apply_fused_interface


def _launch_counts():
    return [(w.launches, dict(w.launches_by_dtype)) for w in _wrappers()]


def _take_back(before):
    """Set the wrappers' counts back to ``before`` (:func:`_launch_counts`)
    and return what was added since, per wrapper (total, by dtype)."""
    added = []
    for w, (n, by) in zip(_wrappers(), before):
        added.append((w.launches - n, {dt: w.launches_by_dtype[dt] - c for dt, c in by.items()}))
        w.launches = n
        w.launches_by_dtype.update(by)
    return added


def _pointers(args) -> tuple:
    return tuple(a.data_ptr() for a in args if isinstance(a, torch.Tensor))


class _Graph:
    """One captured cycle: the graph, the addresses of its tensor
    arguments, its outputs and the kernel launches it holds."""

    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs, self.outputs, self.launches = graph, inputs, outputs, launches

    def replay(self, args):
        if _pointers(args) != self.inputs:
            raise RuntimeError("a captured cycle was given tensors at other addresses than "
                               "at its capture")
        self.graph.replay()
        for w, (n, by) in zip(_wrappers(), self.launches):
            w.launches += n
            for dt, c in by.items():
                w.launches_by_dtype[dt] += c
        stats["replays"] += 1
        return self.outputs


def _capture(body, args, stream, pool=None) -> _Graph:
    """Capture ``body(*args)`` on ``stream`` into memory pool ``pool`` (a
    new one when None); the launch counts are left as they were.
    ``torch.cuda.graph`` would also empty the allocator's cache first,
    which costs the next allocations a ``cudaMalloc`` each, on every
    capture of a solve."""
    graph = torch.cuda.CUDAGraph()
    before = _launch_counts()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            try:
                outputs = body(*args)
            finally:
                graph.capture_end()
    finally:
        launches = _take_back(before)
    return _Graph(graph, _pointers(args), outputs, launches)


class CycleGraphs:
    """The captured cycles of one solver call on ``op`` and the operators
    ``more`` it also applies (see the module docstring).  :meth:`run` runs
    one cycle; with ``warm_each_key`` each static key's first cycle runs
    eagerly."""

    def __init__(self, op, *more, warm_each_key: bool = False):
        self.op = op
        self.ops = tuple({id(o): o for o in (op, *more)}.values())
        self.warm_each_key = warm_each_key
        self.enabled = capturable(op) and not _eager_only
        self.stream = torch.cuda.Stream(device=op.device) if self.enabled else None
        self._graphs = {}
        self._warm = None
        self._warm_keys = set()
        self._pool = None

    def run(self, static: tuple, body, *args):
        """``body(*args)``, one cycle; ``static`` names every argument that
        is not a tensor and shapes the work.  Returns what ``body``
        returns (on the card from the second cycle on: the graph's own
        output tensors)."""
        stats["cycles"].append(static)
        if not self.enabled:
            return body(*args)
        opkey = tuple(cycle_key(o, ())[1] for o in self.ops)
        if opkey != self._warm:
            self._graphs.clear()
            self._warm_keys.clear()
            self._warm, self._pool = opkey, None
            first = True
        else:
            first = self.warm_each_key and static not in self._warm_keys
        if first:
            out = self._eager(body, args)
            self._warm_keys.add(static)
            stats["eager"] += 1
            return out
        entry = self._graphs.get(static)
        if entry is None:
            t0 = time.perf_counter()
            with torch.cuda.device(self.op.device):
                entry = self._graphs[static] = _capture(body, args, self.stream, self._pool)
            self._pool = entry.graph.pool()
            stats["captures"] += 1
            stats["capture_s"] += time.perf_counter() - t0
        with torch.cuda.device(self.op.device):
            return entry.replay(args)

    def _eager(self, body, args):
        current = torch.cuda.current_stream(self.op.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = body(*args)
        current.wait_stream(self.stream)
        return out
