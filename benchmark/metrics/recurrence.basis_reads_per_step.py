"""Sweeps over the Lanczos basis per recurrence step:
``COUNTERS["lt.cgs2.basis_reads"]`` (the sweeps over V[:j] each CGS2 call
makes: 3 a step for two passes of the plain recurrence's kernel, 2 for
the lagged one and 1 more to close each segment) over
``COUNTERS["lt.lanczos.recurrence.steps"]``, process totals after the
window (warm-up solves included; inside a CUDA graph a call counts once,
at its capture).  None for a program without the counter."""

from benchmark import spans

READS = "lt.cgs2.basis_reads"


def probe(ctx):
    return spans.counters()


def read(rec):
    c = (rec.get("probes") or {}).get("recurrence.basis_reads_per_step")
    if not c or not c.get(READS) or not c.get(spans.STEPS):
        return None
    return c[READS] / c[spans.STEPS]
