"""The window's wall time over the solves completed in it (host clock):
a user's time to a spectrum."""


def read(rec):
    return rec["window_s"] / len(rec["solves"])
