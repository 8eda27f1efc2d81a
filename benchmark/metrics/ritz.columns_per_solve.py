"""Ritz vectors rotated per solve: ``COUNTERS["lt.ritz.columns"]`` (the
columns each ``ritz_vectors`` call rotates: the k selected pairs in
``eigsh``, all n in ``ritz_from_factorization``) over
``COUNTERS["lt.eigsh.calls"]``, process totals after the window (warm-up
solves included).  On the card every rotation runs the rotation kernel
(``ops/ritz_kernels.py``, one launch per 24 columns, counted in
``COUNTERS["lt.ritz.launches"]``), so there the columns counted are the
kernel's.  None for a program without the counter."""

from benchmark import spans

COLUMNS = "lt.ritz.columns"


def probe(ctx):
    return spans.counters()


def read(rec):
    c = (rec.get("probes") or {}).get("ritz.columns_per_solve")
    if not c or not c.get(COLUMNS) or not c.get(spans.CALLS):
        return None
    return c[COLUMNS] / c[spans.CALLS]
