"""The program's spans in the Chrome trace of a ``--trace 1`` run: which
``lt.*`` span launched each device op, and which span each idle gap of the
traced solves waited on.

``core.py`` exports the profiler's trace of the traced solves to
``_traces/<cell>.json`` (``core.TRACE_DIR``).  The program marks the phases
of a solve with ``record_function`` ranges named ``lt.*``
(``lanczos_tpu_torch/_util.py:span``); they land in that trace as
``user_annotation`` events on the host's clock, beside the launch calls
(``cuda_runtime``, ``cuda_driver``) and the device ops, which name each
other by ``args.correlation``.

* A device op (kernel, copy, memset) belongs to the innermost ``lt.*`` span
  whose host interval holds the start of the call that launched it: a
  kernel that runs after its span has closed on the host still belongs to
  it, and a CUDA graph's kernels belong to the span of its
  ``cudaGraphLaunch``.  Spans are matched by time alone, since the harness
  solves on one thread.  An op with no launch call in the trace, or one
  launched outside every span, belongs to ``NONE``.
* An idle gap of a ``bench.solve`` span belongs to the span of the first
  device op after it, the op the device was waiting for.  The gap is
  *host-late* if the call that launched that op returned after the gap
  began, else *queued*.  A gap with no op after it inside its solve belongs
  to ``TAIL``.  The harness's stretch between two traced solves, which
  ``device.idle_pct`` counts as idle, belongs to ``BETWEEN``; so the gaps
  add up to the idle that ``device.idle_pct`` counts.

A trace without ``lt.*`` spans (a program that has none) or without device
ops (a CPU run) gives no reading: :func:`of` returns None.

    python3 benchmark/spans.py benchmark/_traces/<cell>.json

prints one JSON object: per span, its device seconds, ops and idle
(host-late and queued), and the share of busy time attributed to a span.
"""

from __future__ import annotations

import bisect
import gzip
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import core, tracefile  # noqa: E402

__all__ = ["Spans", "from_events", "load", "of", "counters", "steps_per_solve", "family",
           "EIGSH", "RECURRENCE", "RITZ", "NONE", "TAIL", "BETWEEN"]

PREFIX = "lt."
EIGSH = "lt.eigsh"
RECURRENCE = "lt.lanczos.recurrence"
RITZ = "lt.ritz"
#: The counters of ``lanczos_tpu_torch/_util.py:COUNTERS`` the readers take.
CALLS, STEPS = "lt.eigsh.calls", "lt.lanczos.recurrence.steps"
#: Owners of what no span launched, of the idle after a solve's last op,
#: and of the stretch between two traced solves.
NONE, TAIL, BETWEEN = "(none)", "(tail)", "(between)"
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}


def family(name):
    """A test of span names: ``name`` and the spans named under it."""
    return lambda span: span == name or span.startswith(name + ".")


@dataclass
class Spans:
    trace: tracefile.Trace  # the same events as tracefile reads them
    spans: list = field(default_factory=list)  # (name, start_s, end_s)
    ops: list = field(default_factory=list)  # (start_s, end_s, span, launch_end_s | None)
    gaps: list = field(default_factory=list)  # (start_s, end_s, span, host_late)

    def _in_solve(self, t) -> bool:
        return any(a <= t < b for a, b in self.trace.solves)

    def count(self, name) -> int:
        """Spans called ``name`` that start inside a solve."""
        return sum(1 for n, s, _ in self.spans if n == name and self._in_solve(s))

    def device_s(self, which) -> float:
        """Busy seconds inside the solves of the ops whose span ``which``
        accepts (the union of their intervals)."""
        mine = tracefile.union((s, e) for s, e, span, _ in self.ops if which(span))
        return sum(e - s for s, e in tracefile.clip(mine, self.trace.solves))

    def n_ops(self, which) -> int:
        """Ops starting inside a solve whose span ``which`` accepts."""
        return sum(1 for s, _, span, _ in self.ops if which(span) and self._in_solve(s))

    def idle_s(self, which, host_late=None) -> float:
        """Idle seconds of the gaps whose span ``which`` accepts (only the
        host-late ones, or only the queued ones, if ``host_late`` says)."""
        return sum(e - s for s, e, span, late in self.gaps
                   if which(span) and host_late in (None, late))

    def table(self) -> dict:
        """Per span name: device seconds, ops, idle host-late and queued;
        with the solves' totals and the busy share attributed to a span."""
        names = sorted({span for _, _, span, _ in self.ops} | {g[2] for g in self.gaps})
        rows = {}
        for name in names:
            only = (lambda n: lambda span: span == n)(name)
            rows[name] = {"device_s": self.device_s(only), "ops": self.n_ops(only),
                          "idle_host_late_s": self.idle_s(only, True),
                          "idle_queued_s": self.idle_s(only, False),
                          "gaps": sum(1 for g in self.gaps if g[2] == name)}
        busy = self.trace.busy_s()
        spanned = self.device_s(lambda span: span != NONE)
        return {"solves": len(self.trace.solves), "eigsh_spans": self.count(EIGSH),
                "wall_s": sum(b - a for a, b in self.trace.solves),
                "window_s": self.trace.window_s, "busy_s": busy,
                "idle_s": self.idle_s(lambda span: True),
                "attributed_share": spanned / busy if busy else None, "spans": rows}


def _innermost(spans, times):
    """For each of ``times``, the name of the innermost of the nested
    ``spans`` (name, start, end; outer first on a tie) whose closed interval
    holds it, or NONE."""
    marks = [(s, 0, i) for i, (_, s, _) in enumerate(spans)]
    marks += [(e, 2, i) for i, (_, _, e) in enumerate(spans)]
    marks += [(t, 1, q) for q, t in enumerate(times)]
    out, open_ = [NONE] * len(times), []
    for _, kind, i in sorted(marks):
        if kind == 0:
            open_.append(i)
        elif kind == 2:
            open_.remove(i)
        elif open_:
            out[i] = spans[open_[-1]][0]
    return out


def from_events(events) -> Spans:
    """Spans from Chrome trace events (``ph`` "X", ``ts``/``dur`` in us)."""
    sp = Spans(tracefile.from_events(events))
    launches, device = {}, []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        cat, name = ev.get("cat", ""), ev.get("name", "")
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name.startswith(PREFIX):
            sp.spans.append((name, s, e))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = (s, e)
        elif cat in tracefile.DEVICE_CATS:
            device.append((s, e, corr))
    # A launch call may follow its op in the file: join once all are read.
    device = sorted(((s, e, launches.get(corr)) for s, e, corr in device),
                    key=lambda d: (d[0], d[1]))
    sp.spans.sort(key=lambda x: (x[1], -x[2]))
    launched = [i for i, (_, _, lc) in enumerate(device) if lc is not None]
    owner = dict(zip(launched, _innermost(sp.spans, [device[i][2][0] for i in launched])))
    sp.ops = [(s, e, owner.get(i, NONE), lc[1] if lc else None)
              for i, (s, e, lc) in enumerate(device)]
    starts = [o[0] for o in sp.ops]
    busy = tracefile.union((s, e) for s, e, _, _ in sp.ops)
    for a, b in sp.trace.solves:
        for gs, ge in tracefile.gaps(busy, (a, b)):
            i = bisect.bisect_left(starts, ge)
            if i < len(starts) and starts[i] < b:
                _, _, span, launch_end = sp.ops[i]
                sp.gaps.append((gs, ge, span, launch_end is not None and launch_end > gs))
            else:
                sp.gaps.append((gs, ge, TAIL, False))
    sp.gaps += [(e, s, BETWEEN, False)
                for (_, e), (s, _) in zip(sp.trace.solves, sp.trace.solves[1:]) if s > e]
    return sp


_cache = {}


def load(path) -> Spans:
    """Spans from a Chrome trace file (``.json`` or ``.json.gz``), parsed
    once per process for a given path and modification time."""
    key = (str(path), Path(path).stat().st_mtime_ns)
    if key not in _cache:
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as f:
            events = json.load(f)["traceEvents"]
        _cache.clear()
        _cache[key] = from_events(events)
    return _cache[key]


def of(rec):
    """The Spans of a traced run's record, or None where there is nothing to
    read: no trace, no device op, or no ``lt.eigsh`` span in a solve."""
    if rec.get("trace") is None:
        return None
    path = Path(core.TRACE_DIR) / f"{rec['cell']}.json"
    if not path.is_file():
        return None
    sp = load(path)
    if not sp.ops or not sp.trace.solves or not sp.count(EIGSH):
        return None
    return sp


def counters():
    """A metric's probe: the program's ``COUNTERS`` after the window, or
    None for a program that has none."""
    from lanczos_tpu_torch import _util

    found = getattr(_util, "COUNTERS", None)
    return None if found is None else dict(found)


def steps_per_solve(rec, metric):
    """Recurrence steps per ``eigsh`` call over the process, from the
    counters that ``metric``'s probe read; None without them."""
    c = (rec.get("probes") or {}).get(metric)
    if not c or not c.get(CALLS) or not c.get(STEPS):
        return None
    return c[STEPS] / c[CALLS]


def main(argv=None):
    (path,) = sys.argv[1:] if argv is None else argv
    print(json.dumps(load(path).table(), indent=1))


if __name__ == "__main__":
    main()
