"""Device-busy milliseconds per Krylov step of the profiled solves: the
union of the trace's device intervals inside the solve spans over the
solves' steps (the traffic's ``n``); none for an entry with no fixed
depth."""


def read(rec):
    tr, steps = rec["trace"], rec["traffic"]["kwargs"].get("n")
    if tr is None or not steps or not tr.solves or not tr.device:
        return None
    return 1e3 * tr.busy_s() / (len(tr.solves) * steps)
