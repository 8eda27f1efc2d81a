"""The interval arithmetic behind device.idle_pct and
recurrence.device_ms_per_step, and the window's accounting, on synthetic
events."""

import importlib

import pytest

from benchmark import manifest, tracefile


def ev(cat, name, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


def synthetic():
    return tracefile.from_events([
        ev("user_annotation", tracefile.SOLVE_SPAN, 0, 100),
        ev("user_annotation", tracefile.SOLVE_SPAN, 200, 100),
        ev("kernel", "gemv", 10, 20),
        ev("kernel", "gemv", 20, 20),  # overlaps the first: counted once
        ev("kernel", "spmv", 50, 10),
        ev("gpu_memcpy", "Memcpy DtoH", 290, 20),  # half outside the span
        ev("kernel", "between", 150, 10),  # between the spans: not counted
        ev("gpu_user_annotation", tracefile.SOLVE_SPAN, 0, 100),  # no device work
        ev("cpu_op", "aten::copy_", 60, 30),
        ev("cpu_op", "aten::mm", 65, 5),
        ev("cpu_op", "aten::empty", 210, 80),
    ])


def test_union_clip_gaps():
    assert tracefile.union([(3, 4), (0, 2), (1, 3), (5, 5)]) == [(0, 4)]
    assert tracefile.clip([(0, 4), (6, 9)], [(1, 7)]) == [(1, 4), (6, 7)]
    assert tracefile.gaps([(1, 2), (3, 4)], (0, 5)) == [(0, 1), (2, 3), (4, 5)]
    assert tracefile.gaps([], (0, 5)) == [(0, 5)]


def test_busy_idle_and_breakdown():
    tr = synthetic()
    assert [t for span in tr.solves for t in span] == pytest.approx([0.0, 100e-6, 200e-6, 300e-6])
    assert tr.window_s == pytest.approx(300e-6)
    # busy: [10, 40] + [50, 60] + [290, 300] = 50 us
    assert tr.busy_s() == pytest.approx(50e-6)
    gaps = sorted(tr.idle_gaps())
    assert list(gaps[0]) == pytest.approx([0.0, 10e-6])
    assert sum(b - a for a, b in gaps) == pytest.approx(150e-6)
    ops = dict(tr.device_ops())
    assert ops["gemv"] == pytest.approx(40e-6) and "between" not in ops
    assert ops["Memcpy DtoH"] == pytest.approx(10e-6)
    named = tr.named_gaps(top=2)
    # [200, 290] is the longest gap, covered by aten::empty; then [60, 100],
    # most of it under aten::copy_.
    assert named[0][0] == "aten::empty" and named[0][1] == pytest.approx(90e-6)
    assert named[1][0] == "aten::copy_" and named[1][1] == pytest.approx(40e-6)


def read(name, rec):
    return manifest.module("metrics", name).read(rec)


def test_trace_metrics():
    rec = {"trace": synthetic(), "traffic": {"kwargs": {"n": 5}}}
    assert read("device.idle_pct", rec) == pytest.approx(100 * (1 - 50 / 300))
    assert read("recurrence.device_ms_per_step", rec) == pytest.approx(50e-3 / (2 * 5))
    rec["traffic"] = {"kwargs": {"k": 8}}
    assert read("recurrence.device_ms_per_step", rec) is None
    assert read("device.idle_pct", {"trace": None}) is None


def test_window_metrics():
    walls = [1.0, 1.1, 0.9, 1.0, 3.0]
    rec = {"solves": [{"wall_s": w, "traced": i == 0} for i, w in enumerate(walls)],
           "window_s": 7.5, "window_peak_bytes": 3 * 2**30, "setup": {"total_s": 9.0}}
    assert read("solve_s", rec) == pytest.approx(1.5)
    assert read("solve_p95_s", rec) == pytest.approx(3.0 - 0.05 * 4 * (3.0 - 1.1))
    assert read("peak_mem_gib", rec) == pytest.approx(3.0)
    assert read("setup_s", rec) == 9.0


def test_window_holds_whole_solves(tiny_root):
    from benchmark import core

    logged = []
    line, code = core.run("regular_n160.eigsh_k20", 7, 0.3, False, root=tiny_root,
                          device="cpu", log=logged.append)
    assert code == 0 and line["correct"]
    window = next(m for m in logged if m.startswith("window:"))
    walls = [float(w) for w in window.split("walls [")[1].split("]")[0].split(",")]
    n, seconds = int(window.split()[1]), float(window.split()[4])
    assert line["attempted"] == n == len(walls) >= 1
    assert seconds >= 0.3 and sum(walls) <= seconds
    assert sum(walls[:-1]) < 0.3  # it ends with the first solve that crosses 0.3 s
    assert line["metrics"]["solve_s"]["value"] == pytest.approx(seconds / n, rel=1e-5)  # logged to 1 us
    assert importlib.import_module("benchmark.core").forbidden_modules() == []
