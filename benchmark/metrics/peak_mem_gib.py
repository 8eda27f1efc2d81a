"""``torch.cuda.max_memory_allocated()`` over the window, in GiB (the
counter is reset when set-up ends); none on the CPU."""


def read(rec):
    peak = rec["window_peak_bytes"]
    return None if peak is None else peak / 2**30
