"""Idle milliseconds per traced solve that the device spent waiting for an
op launched in the program's recurrence span (``lt.lanczos.recurrence``):
the gaps ``device.idle_pct`` counts, each given to the span of the first
op after it (``benchmark/spans.py``).  None for a program without the
spans."""

from benchmark import spans


def read(rec):
    sp = spans.of(rec)
    if sp is None:
        return None
    return 1e3 * sp.idle_s(spans.family(spans.RECURRENCE)) / len(sp.trace.solves)
