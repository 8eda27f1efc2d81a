"""The reader of ``ritz.columns_per_solve``: the program's Ritz column and
call counters from a probe dict, and the probe against the program
itself."""

import pytest

from benchmark import manifest, spans

NAME = "ritz.columns_per_solve"


def read(rec):
    return manifest.module("metrics", NAME).read(rec)


@pytest.mark.parametrize("probe, want", [
    ({"lt.ritz.columns": 3 * 20, spans.CALLS: 3}, 20.0),  # the selected pairs only
    ({"lt.ritz.columns": 3 * 400, spans.CALLS: 3}, 400.0),  # every Ritz vector
    ({"lt.ritz.columns": 10}, None),  # no calls counted
    ({spans.CALLS: 4, spans.STEPS: 20}, None),  # a program without the column counter
    ({}, None),
    (None, None),
])
def test_ritz_columns_per_solve_reads_the_counters(probe, want):
    rec = {"cell": "synthetic", "trace": None, "probes": {NAME: probe}}
    got = read(rec)
    assert got == want if want is None else got == pytest.approx(want)
    assert read({"probes": {}}) is None


def test_ritz_columns_per_solve_probe_reads_the_programs_counters():
    import torch

    import lanczos_tpu_torch as lt

    mod = manifest.module("metrics", NAME)
    before = mod.probe(None)
    lt.eigsh(torch.diag(torch.arange(1.0, 31.0, dtype=torch.float64)), k=2, n=12)
    after = mod.probe(None)
    columns = after["lt.ritz.columns"] - before.get("lt.ritz.columns", 0)
    calls = after[spans.CALLS] - before.get(spans.CALLS, 0)
    assert (columns, calls) == (2, 1)  # the two selected pairs, not all twelve
    assert read({"probes": {NAME: after}}) == pytest.approx(
        after["lt.ritz.columns"] / after[spans.CALLS])
