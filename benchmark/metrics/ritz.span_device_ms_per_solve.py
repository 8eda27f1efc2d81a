"""Device-busy milliseconds per traced solve of the ops launched in the
program's Ritz span (``lt.ritz``, with ``lt.ritz.eigh`` and
``lt.ritz.rotate`` inside it): the float64 eigh of T, the (M, n) x (n, n)
rotation and beta_n.  None for a program without the spans."""

from benchmark import spans


def read(rec):
    sp = spans.of(rec)
    if sp is None:
        return None
    return 1e3 * sp.device_s(spans.family(spans.RITZ)) / len(sp.trace.solves)
