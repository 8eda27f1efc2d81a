"""Device-busy milliseconds per Lanczos step inside the program's
recurrence span (``lt.lanczos.recurrence``): the union of the intervals of
the device ops launched in that span during the traced solves, over their
steps (traced ``lt.eigsh`` spans times the steps per ``eigsh`` call, from
the program's counters).  The start, the Ritz step, the selection and the
acceptance check are left out, as ``recurrence.device_ms_per_step`` does
not leave them.  None for a program without the spans or counters."""

from benchmark import spans


def probe(ctx):
    return spans.counters()


def read(rec):
    sp = spans.of(rec)
    steps = spans.steps_per_solve(rec, "recurrence.span_device_ms_per_step")
    if sp is None or not steps:
        return None
    return 1e3 * sp.device_s(spans.family(spans.RECURRENCE)) / (sp.count(spans.EIGSH) * steps)
