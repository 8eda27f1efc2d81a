"""The 95th percentile of the window's per-solve walls (host clock, from
the call into the entry point to ``torch.cuda.synchronize()`` after it;
numpy's linear interpolation between order statistics)."""

import numpy as np


def read(rec):
    return float(np.percentile([s["wall_s"] for s in rec["solves"]], 95))
