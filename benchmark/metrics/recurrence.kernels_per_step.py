"""Device ops (kernels, copies, memsets) launched in the program's
recurrence span (``lt.lanczos.recurrence``) per Lanczos step of the traced
solves, steps counted as in ``recurrence.span_device_ms_per_step``.  None
for a program without the spans or counters."""

from benchmark import spans


def probe(ctx):
    return spans.counters()


def read(rec):
    sp = spans.of(rec)
    steps = spans.steps_per_solve(rec, "recurrence.kernels_per_step")
    if sp is None or not steps:
        return None
    return sp.n_ops(spans.family(spans.RECURRENCE)) / (sp.count(spans.EIGSH) * steps)
