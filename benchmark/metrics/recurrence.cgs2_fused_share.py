"""The share of the program's CGS2 calls (``solver/lanczos.py:
_orthogonalize``) that ran the CUDA kernel (``ops/cgs2_kernels.py:cgs2``):
``COUNTERS["lt.cgs2.fused"]`` over ``COUNTERS["lt.cgs2.calls"]``, process
totals after the window (warm-up solves included; inside a CUDA graph a
call counts once, at its capture).  None for a program without the
counters."""

from benchmark import spans

CALLS, FUSED = "lt.cgs2.calls", "lt.cgs2.fused"


def probe(ctx):
    return spans.counters()


def read(rec):
    c = (rec.get("probes") or {}).get("recurrence.cgs2_fused_share")
    if not c or not c.get(CALLS):
        return None
    return c.get(FUSED, 0) / c[CALLS]
