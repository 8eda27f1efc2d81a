"""The reader of ``recurrence.basis_reads_per_step``: the program's sweep
and step counters from a probe dict, and the probe against the program
itself."""

import pytest

from benchmark import manifest, spans

NAME = "recurrence.basis_reads_per_step"


def read(rec):
    return manifest.module("metrics", NAME).read(rec)


@pytest.mark.parametrize("probe, want", [
    ({"lt.cgs2.basis_reads": 2 * 399 + 1, spans.STEPS: 399}, 2 + 1 / 399),  # lagged
    ({"lt.cgs2.basis_reads": 3 * 399, spans.STEPS: 399}, 3.0),  # the three-sweep kernel
    ({"lt.cgs2.basis_reads": 10}, None),  # no steps counted
    ({spans.CALLS: 4, spans.STEPS: 20}, None),  # a program without the sweep counter
    ({}, None),
    (None, None),
])
def test_basis_reads_per_step_reads_the_counters(probe, want):
    rec = {"cell": "synthetic", "trace": None, "probes": {NAME: probe}}
    got = read(rec)
    assert got == want if want is None else got == pytest.approx(want)
    assert read({"probes": {}}) is None


def test_basis_reads_per_step_probe_reads_the_programs_counters():
    import torch

    import lanczos_tpu_torch as lt

    mod = manifest.module("metrics", NAME)
    before = mod.probe(None)
    lt.eigsh(torch.diag(torch.arange(1.0, 31.0, dtype=torch.float64)), k=2, n=12)
    after = mod.probe(None)
    reads = after["lt.cgs2.basis_reads"] - before.get("lt.cgs2.basis_reads", 0)
    steps = after[spans.STEPS] - before.get(spans.STEPS, 0)
    assert (reads, steps) == (2 * 11 + 1, 11)  # two sweeps a step, one to close
    assert read({"probes": {NAME: after}}) == pytest.approx(
        after["lt.cgs2.basis_reads"] / after[spans.STEPS])
