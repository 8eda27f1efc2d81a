"""Reading a ``torch.profiler`` Chrome trace: the device's kernel intervals,
the host's operations and the benchmark's solve spans, and what the
per-layer metrics and the breakdown take from them.

Times are seconds.  A device interval is a kernel, a copy or a memset on
the card; the union of those intervals inside the solve spans is the time
the device was busy, and the rest of the spans is idle.
"""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass, field

__all__ = ["Trace", "load", "from_events", "union", "clip", "gaps", "SOLVE_SPAN"]

#: The name of the ``record_function`` span around each profiled solve.
SOLVE_SPAN = "bench.solve"

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver"}


@dataclass
class Trace:
    device: list = field(default_factory=list)  # (name, start_s, end_s)
    host: list = field(default_factory=list)  # (name, start_s, end_s)
    solves: list = field(default_factory=list)  # (start_s, end_s)

    @property
    def window_s(self) -> float:
        """From the first solve span's start to the last one's end."""
        if not self.solves:
            return 0.0
        return max(e for _, e in self.solves) - min(s for s, _ in self.solves)

    def busy_s(self) -> float:
        """Seconds inside the solve spans in which the device ran something."""
        return sum(e - s for s, e in clip(union((s, e) for _, s, e in self.device), self.solves))

    def idle_gaps(self):
        """The idle stretches inside the solve spans, (start_s, end_s)."""
        busy = union((s, e) for _, s, e in self.device)
        return [g for span in self.solves for g in gaps(busy, span)]

    def device_ops(self, top: int = 10):
        """[(name, seconds)]: device time per operation name inside the
        solve spans, the ``top`` largest."""
        spans = union(self.solves)
        total = {}
        for name, s, e in self.device:
            t = sum(b - a for a, b in clip([(s, e)], spans))
            if t > 0:
                total[name] = total.get(name, 0.0) + t
        return sorted(total.items(), key=lambda kv: -kv[1])[:top]

    def named_gaps(self, top: int = 10):
        """[(name, seconds)]: the ``top`` longest idle gaps, each named by
        the host operation that overlaps most of it (the shortest such
        operation on a tie), or by "untraced host work" where no operation
        but the solve span covers it."""
        longest = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        host = sorted(self.host, key=lambda h: h[1])
        out = []
        for gs, ge in longest:
            best, best_key = "untraced host work", None
            for name, hs, he in host:
                if hs >= ge:
                    break
                if name == SOLVE_SPAN or he <= gs:
                    continue
                key = (min(he, ge) - max(hs, gs), -(he - hs))
                if best_key is None or key > best_key:
                    best, best_key = name, key
            out.append((best, ge - gs))
        return out


def union(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def clip(intervals, spans):
    """The parts of disjoint sorted ``intervals`` inside the ``spans``."""
    out = []
    for a, b in union(spans):
        for s, e in intervals:
            lo, hi = max(s, a), min(e, b)
            if hi > lo:
                out.append((lo, hi))
    return out


def gaps(busy, span):
    """The stretches of ``span`` not covered by the sorted disjoint ``busy``."""
    a, b = span
    out, t = [], a
    for s, e in busy:
        if e <= t:
            continue
        if s >= b:
            break
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < b:
        out.append((t, b))
    return out


def from_events(events) -> Trace:
    """A Trace from Chrome trace events (``ph`` "X", ``ts``/``dur`` in us)."""
    tr = Trace()
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            tr.device.append((name, s, e))
        elif cat in HOST_CATS:
            if name == SOLVE_SPAN and cat == "user_annotation":
                tr.solves.append((s, e))
            tr.host.append((name, s, e))
    tr.solves.sort()
    return tr


def load(path) -> Trace:
    """A Trace from a Chrome trace file (``.json`` or ``.json.gz``)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        return from_events(json.load(f)["traceEvents"])
