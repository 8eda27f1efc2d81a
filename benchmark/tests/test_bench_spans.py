"""``benchmark/spans.py`` on synthetic Chrome events with correlation ids:
device ops given to the span that launched them, idle gaps to the span of
the op after them, and the five readers of the program's spans."""

import json

import pytest

from benchmark import core, manifest, spans, tracefile

US = 1e-6


def ev(cat, name, ts, dur, corr=None):
    out = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        out["args"] = {"correlation": corr, "External id": corr + 1000}
    return out


def launch(corr, ts, name="cudaLaunchKernel"):
    return ev("cuda_runtime", name, ts, 1, corr)


def span(name, ts, end):
    return ev("user_annotation", name, ts, end - ts)


# One solve [0, 100] us.  Busy: [5, 15] [20, 30] [32, 40] [41, 44] [46.5, 48]
# [55, 65] [66, 80] [82, 84] [88, 92] = 62.5 us; idle 37.5 us.
EVENTS = [
    span(tracefile.SOLVE_SPAN, 0, 100),
    span("lt.eigsh", 1, 99),
    span("lt.lanczos.start", 2, 10),
    launch(1, 3),
    ev("kernel", "fill", 5, 10, 1),  # runs on after its span closed at 10
    span("lt.lanczos.recurrence", 10, 50),
    launch(2, 11), ev("kernel", "gemv", 20, 10, 2),
    launch(3, 13), ev("kernel", "gemv", 32, 8, 3),
    launch(10, 15, "cudaGraphLaunch"),
    ev("kernel", "graph_a", 41, 2, 10), ev("kernel", "graph_b", 43, 1, 10),
    ev("kernel", "spmv", 46.5, 1.5, 4), launch(4, 45),  # the call after its op in the file
    span("lt.ritz", 50, 70),
    span("lt.ritz.eigh", 51, 60),
    launch(5, 52), ev("kernel", "syevd", 55, 10, 5),
    span("lt.ritz.rotate", 60, 64),
    launch(6, 61), ev("kernel", "gemm", 66, 14, 6),  # starts after both its spans closed
    span("lt.select", 70, 85),
    ev("cuda_runtime", "cudaMemcpyAsync", 71, 1, 7), ev("gpu_memcpy", "Memcpy DtoH", 82, 2, 7),
    span("lt.acceptance", 85, 95),
    launch(8, 86), ev("kernel", "spmm", 88, 4, 8),
    ev("kernel", "after", 200, 10, 99),  # outside the solve, with no launch call
]

# Each gap, the span it waited on, and whether the host was late.
GAPS = [(0, 5, "lt.lanczos.start", True), (15, 20, spans.RECURRENCE, False),
        (30, 32, spans.RECURRENCE, False), (40, 41, spans.RECURRENCE, False),
        (44, 46.5, spans.RECURRENCE, True), (48, 55, "lt.ritz.eigh", True),
        (65, 66, "lt.ritz.rotate", False), (80, 82, "lt.select", False),
        (84, 88, "lt.acceptance", True), (92, 100, spans.TAIL, False)]


@pytest.fixture
def sp():
    return spans.from_events(EVENTS)


def owners(sp):
    return {round(s / US, 3): span for s, _, span, _ in sp.ops}


def test_ops_go_to_the_innermost_span_of_their_launch(sp):
    got = owners(sp)
    assert got[5] == "lt.lanczos.start"  # still running when its span had closed
    assert got[66] == "lt.ritz.rotate"  # started after lt.ritz.rotate and lt.ritz closed
    assert got[55] == "lt.ritz.eigh"  # nested: the inner span, not lt.ritz
    assert got[41] == got[43] == spans.RECURRENCE  # a graph's kernels: its launch's span
    assert got[46.5] == spans.RECURRENCE  # its launch call came later in the file
    assert got[82] == "lt.select" and got[88] == "lt.acceptance"
    assert got[200] == spans.NONE


def test_gaps_go_to_the_next_op_host_late_or_queued(sp):
    got = [(round(s / US, 3), round(e / US, 3), span, late) for s, e, span, late in sp.gaps]
    assert got == GAPS


def shifted(events, us, corr):
    """The events moved by ``us`` microseconds, correlation ids by ``corr``."""
    out = []
    for e in events:
        e = {**e, "ts": e["ts"] + us}
        if "args" in e:
            e["args"] = {**e["args"], "correlation": e["args"]["correlation"] + corr}
        out.append(e)
    return out


# A second solve [300, 400] us; the op at 200 us now runs between the solves.
TWO = EVENTS + shifted([e for e in EVENTS if e["name"] != "after"], 300, 100)


@pytest.mark.parametrize("events, solves", [(EVENTS, 1), (TWO, 2)])
def test_recurrence_and_edge_idle_add_up_to_the_idle_device_idle_pct_counts(events, solves):
    sp = spans.from_events(events)
    total = sp.trace.window_s - sp.trace.busy_s()  # device.idle_pct's idle
    in_solves = sum(e - s for s, e in sp.trace.idle_gaps())
    assert in_solves == pytest.approx(solves * 37.5 * US)
    assert total == pytest.approx(in_solves + (solves - 1) * 200 * US)  # all of [100, 300]
    rec = spans.family(spans.RECURRENCE)
    inside, edges = sp.idle_s(rec), sp.idle_s(lambda s: not rec(s))
    assert inside == pytest.approx(solves * 10.5 * US)
    assert edges == pytest.approx(solves * 27 * US + (solves - 1) * 200 * US)
    assert inside + edges == pytest.approx(total, rel=1e-12)
    assert sp.idle_s(rec, host_late=True) == pytest.approx(solves * 2.5 * US)
    assert sp.idle_s(spans.BETWEEN.__eq__) == pytest.approx((solves - 1) * 200 * US)


def test_device_time_ops_and_counts(sp):
    assert sp.device_s(spans.family(spans.RECURRENCE)) == pytest.approx(22.5 * US)
    assert sp.n_ops(spans.family(spans.RECURRENCE)) == 5
    assert sp.device_s(spans.family(spans.RITZ)) == pytest.approx(24 * US)
    assert sp.count(spans.EIGSH) == 1 and sp.count(spans.RITZ) == 1
    table = sp.table()
    assert table["attributed_share"] == pytest.approx(1.0)
    assert table["busy_s"] == pytest.approx(62.5 * US)
    assert table["spans"]["lt.ritz.eigh"]["idle_host_late_s"] == pytest.approx(7 * US)
    assert sum(r["ops"] for r in table["spans"].values()) == 10  # the op at 200 us is outside


def test_an_op_launched_outside_every_span():
    sp = spans.from_events([span(tracefile.SOLVE_SPAN, 0, 10), span("lt.eigsh", 1, 5),
                            launch(1, 2), ev("kernel", "a", 3, 2, 1),
                            launch(2, 6), ev("kernel", "b", 7, 1, 2),
                            ev("kernel", "untraced", 8.5, 0.5, 3)])
    assert [o[2] for o in sp.ops] == ["lt.eigsh", spans.NONE, spans.NONE]
    assert sp.table()["attributed_share"] == pytest.approx(2 / 3.5)


PER_STEP = ("recurrence.span_device_ms_per_step", "recurrence.kernels_per_step")
READERS = PER_STEP + ("recurrence.idle_ms_per_solve", "ritz.span_device_ms_per_solve",
                      "eigsh.edge_idle_ms_per_solve")


def record(tmp_path, monkeypatch, events, counters=True):
    monkeypatch.setattr(core, "TRACE_DIR", tmp_path)
    (tmp_path / "synthetic.json").write_text(json.dumps({"traceEvents": events}))
    probe = {spans.CALLS: 4, spans.STEPS: 20} if counters else None
    return {"cell": "synthetic", "trace": tracefile.from_events(events),
            "probes": {name: probe for name in PER_STEP}}


def read(name, rec):
    return manifest.module("metrics", name).read(rec)


def test_the_readers_on_a_recorded_record(tmp_path, monkeypatch):
    rec = record(tmp_path, monkeypatch, EVENTS)  # 5 steps a solve, 1 traced solve
    assert read("recurrence.span_device_ms_per_step", rec) == pytest.approx(22.5e-3 / 5)
    assert read("recurrence.kernels_per_step", rec) == pytest.approx(1.0)
    assert read("recurrence.idle_ms_per_solve", rec) == pytest.approx(10.5e-3)
    assert read("ritz.span_device_ms_per_solve", rec) == pytest.approx(24e-3)
    assert read("eigsh.edge_idle_ms_per_solve", rec) == pytest.approx(27e-3)
    idle_ms = 1e3 * read("device.idle_pct", rec) / 100 * rec["trace"].window_s  # one solve
    both = read("recurrence.idle_ms_per_solve", rec) + read("eigsh.edge_idle_ms_per_solve", rec)
    assert both == pytest.approx(idle_ms, rel=1e-9)


def test_the_readers_on_two_solves(tmp_path, monkeypatch):
    rec = record(tmp_path, monkeypatch, TWO)
    assert read("recurrence.span_device_ms_per_step", rec) == pytest.approx(22.5e-3 / 5)
    assert read("recurrence.kernels_per_step", rec) == pytest.approx(1.0)
    assert read("ritz.span_device_ms_per_solve", rec) == pytest.approx(24e-3)
    idle_ms = 1e3 * read("device.idle_pct", rec) / 100 * rec["trace"].window_s / 2
    both = read("recurrence.idle_ms_per_solve", rec) + read("eigsh.edge_idle_ms_per_solve", rec)
    assert both == pytest.approx(idle_ms, rel=1e-9)
    assert read("eigsh.edge_idle_ms_per_solve", rec) == pytest.approx(27e-3 + 100e-3)


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_nothing_without_spans_or_counters(tmp_path, monkeypatch, name):
    no_spans = [e for e in EVENTS if not e["name"].startswith("lt.")]
    assert read(name, record(tmp_path, monkeypatch, no_spans)) is None
    assert read(name, {"cell": "synthetic", "trace": None, "probes": {}}) is None
    if name in PER_STEP:
        assert read(name, record(tmp_path, monkeypatch, EVENTS, counters=False)) is None


def test_the_probe_reads_the_programs_counters():
    import torch

    import lanczos_tpu_torch as lt

    before = spans.counters()
    lt.eigsh(torch.diag(torch.arange(1.0, 31.0, dtype=torch.float64)), k=2, n=12)
    after = spans.counters()
    assert after[spans.CALLS] - before.get(spans.CALLS, 0) == 1
    assert after[spans.STEPS] - before.get(spans.STEPS, 0) == 11


def test_a_traced_cpu_run_reads_no_device_spans(tiny_root, tmp_path, monkeypatch):
    monkeypatch.setattr(core, "TRACE_DIR", tmp_path)
    line, code = core.run("regular_n160.eigsh_k20", 2**33 + 7, 0.1, True, root=tiny_root,
                          device="cpu", log=lambda msg: None)
    assert code == 0 and line["correct"]
    assert not set(READERS) & set(line["metrics"])
    sp = spans.load(tmp_path / "regular_n160.eigsh_k20.json")
    assert sp.count(spans.EIGSH) == 2 and not sp.ops  # the spans are there; no device ops
