"""The reader of ``recurrence.cgs2_fused_share``: the program's CGS2
counters from a probe dict, and the probe against the program itself."""

import pytest

from benchmark import manifest, spans


def read(name, rec):
    return manifest.module("metrics", name).read(rec)


@pytest.mark.parametrize("probe, want", [
    ({"lt.cgs2.calls": 800, "lt.cgs2.fused": 800}, 1.0),
    ({"lt.cgs2.calls": 800, "lt.cgs2.fused": 200}, 0.25),
    ({"lt.cgs2.calls": 800}, 0.0),  # a CPU run: every call took the loop
    ({spans.CALLS: 4, spans.STEPS: 20}, None),  # a program without the CGS2 counters
    ({}, None),
    (None, None),
])
def test_cgs2_fused_share_reads_the_counters(probe, want):
    rec = {"cell": "synthetic", "trace": None,
           "probes": {"recurrence.cgs2_fused_share": probe}}
    got = read("recurrence.cgs2_fused_share", rec)
    assert got == want if want is None else got == pytest.approx(want)
    assert read("recurrence.cgs2_fused_share", {"probes": {}}) is None


def test_cgs2_fused_share_probe_reads_the_programs_counters():
    import torch

    import lanczos_tpu_torch as lt

    mod = manifest.module("metrics", "recurrence.cgs2_fused_share")
    before = mod.probe(None)
    lt.eigsh(torch.diag(torch.arange(1.0, 31.0, dtype=torch.float64)), k=2, n=12)
    after = mod.probe(None)
    assert after["lt.cgs2.calls"] - before.get("lt.cgs2.calls", 0) == 11  # one a step
    assert after.get("lt.cgs2.fused", 0) == before.get("lt.cgs2.fused", 0)  # CPU tensors
    rec = {"probes": {"recurrence.cgs2_fused_share": after}}
    assert read("recurrence.cgs2_fused_share", rec) == pytest.approx(
        after.get("lt.cgs2.fused", 0) / after["lt.cgs2.calls"])
