"""Idle milliseconds per traced solve outside the recurrence: the gaps
``device.idle_pct`` counts that ``benchmark/spans.py`` gives to any span
but ``lt.lanczos.recurrence`` (the start, the Ritz step, the selection,
the acceptance check, ops launched outside every span, the tail after a
solve's last op, and the harness's stretch between the traced solves).
With ``recurrence.idle_ms_per_solve`` it sums to the idle that
``device.idle_pct`` counts.  None for a program without the spans."""

from benchmark import spans


def read(rec):
    sp = spans.of(rec)
    if sp is None:
        return None
    rest = spans.family(spans.RECURRENCE)
    return 1e3 * sp.idle_s(lambda span: not rest(span)) / len(sp.trace.solves)
