"""A stand-in for CUDA graphs on the CPU (no tests here).

``solver/graphs.py:CycleGraphs`` takes its card path (a side stream, a
first eager cycle, one capture per static key, a replay for every later
cycle) only for CUDA operators.  :func:`install` lets CPU tensors take the
same path: the streams and device switches do nothing, and a capture runs
the cycle's body once and keeps it in a :class:`StubGraph`, whose replay
runs the body again on the same buffers and writes its results into the
outputs returned at capture, as a real replay overwrites the graph's own
outputs.  This module imports torch and the port only (no pytest, no
JAX), so the spawned ranks of the multi-process tests can install it too;
a test file's ``stub_cuda`` fixture is ``install(monkeypatch.setattr)``.
"""

import contextlib

import torch

from lanczos_tpu_torch.solver import graphs


class StubGraph:
    """Stands in for a captured graph.  A cycle reads only what it does
    not write, so running it twice is running it once."""

    def __init__(self, body=None, args=(), outputs=()):
        self.body, self.args, self.outputs = body, args, outputs
        self.replays = 0

    def capture_begin(self, pool=None):
        self.capturing = True

    def capture_end(self):
        self.capturing = False

    def pool(self):
        return None

    def replay(self):
        assert not getattr(self, "capturing", False)
        self.replays += 1
        if self.body is None:
            return
        new = self.body(*self.args)
        for out, val in zip(*(o if isinstance(o, tuple) else (o,) for o in (self.outputs, new))):
            out.copy_(val)


class StubStream:
    def wait_stream(self, other):
        pass


def install(setattr_=setattr):
    """Patch ``graphs`` and ``torch.cuda`` through ``setattr_`` (pytest's
    ``monkeypatch.setattr`` in a test, the builtin in a spawned rank) so
    that every operator takes the card path with stub graphs, and reset
    the counts.  Returns the list that gets every captured ``_Graph``."""
    captured = []

    def capture(body, args, stream, pool=None):
        before = graphs._launch_counts()
        outputs = body(*args)
        g = graphs._Graph(StubGraph(body, args, outputs), graphs._pointers(args), outputs,
                          graphs._take_back(before))
        captured.append(g)
        return g

    setattr_(graphs, "capturable", lambda op: True)
    setattr_(graphs, "_capture", capture)
    setattr_(torch.cuda, "Stream", lambda device=None: StubStream())
    setattr_(torch.cuda, "current_stream", lambda device=None: StubStream())
    setattr_(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    setattr_(torch.cuda, "device", lambda d: contextlib.nullcontext())
    graphs.reset_stats()
    return captured


def replay_counts(eager_stats):
    """(eager cycles, captures, replays) that the card path owes a solve
    whose cycles' static keys were ``eager_stats['cycles']``."""
    keys = eager_stats["cycles"]
    return 1, len(set(keys[1:])), len(keys) - 1
