"""Block-ELL helpers of the composite operators.

Counterpart of the part of ``lanczos_tpu/ops/composite.py`` that CompositeV2
uses (``ops/composite2.py``): ``IFC_W``, ``_block_ell`` and
``_block_ell_buckets``, the bucketed block-ELL tail of interface rows that
no strided class covers.  Host numpy; the buckets are placed on the
operator's device.  The v1 ``CompositeOperator`` and its sharded form are
not yet ported (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["IFC_W"]

#: Width of the aligned x blocks the tail rows gather (``IFC_W`` of the JAX
#: package, kept so that both packages bucket the same rows the same way).
IFC_W = 32


def _block_ell(cols: np.ndarray, vals: np.ndarray, emask: np.ndarray):
    """Group each ELL row's (col, val) entries into IFC_W-aligned blocks.

    Returns (blk_ids (R, B), blk_w (R, B, IFC_W)): per row, the sorted
    unique aligned block indices its columns fall into, with values
    scattered onto their lane positions.  sum_k val_k x[col_k] then equals
    sum_b dot(blk_w[b], x_blocks[blk_ids[b]]), i.e. the SpMV needs only
    whole-block gathers.  Padding blocks have id 0 and zero weights.
    """
    r, k = cols.shape
    bid = cols // IFC_W
    lane = cols % IFC_W
    big = bid.max() + 1 if r else 1
    keyed = np.where(emask, bid, big)  # push padding entries to the end
    order = np.argsort(keyed, axis=1, kind="stable")
    b_s = np.take_along_axis(keyed, order, 1)
    l_s = np.take_along_axis(lane, order, 1)
    v_s = np.take_along_axis(vals, order, 1)
    m_s = np.take_along_axis(emask, order, 1)

    new = m_s.copy()
    new[:, 1:] &= b_s[:, 1:] != b_s[:, :-1]
    bpos = np.cumsum(new, axis=1) - 1  # block slot per entry
    nblk = new.sum(axis=1)
    b = max(int(nblk.max()), 1)

    blk_ids = np.zeros((r, b), dtype=np.int64)
    blk_w = np.zeros((r, b, IFC_W), dtype=np.float64)
    rr, cc = np.nonzero(m_s)
    blk_ids[rr, bpos[rr, cc]] = b_s[rr, cc]
    np.add.at(blk_w, (rr, bpos[rr, cc], l_s[rr, cc]), v_s[rr, cc])
    return blk_ids, blk_w, nblk


def _block_ell_buckets(ifc_rows, cols, vals, emask, dtype, device, max_buckets=4):
    """Bucket interface rows by real block count to avoid fetching padding.

    Chooses bucket boundaries over the (few) distinct block counts to
    minimize total fetched blocks sum_b R_b * B_b, then emits per-bucket
    (rows, blk_ids, blk_w) trimmed to the bucket's max count, as tensors on
    ``device`` (indices int64, weights in ``dtype``).
    """
    blk_ids, blk_w, nblk = _block_ell(cols, vals, emask)
    order = np.argsort(nblk, kind="stable")
    sorted_n = nblk[order]
    r = len(order)

    # Recursively split the segment whose best single cut saves the most
    # fetched blocks, until max_buckets.
    segs = [(0, r)]
    for _ in range(max_buckets - 1):
        best = None
        for si, (lo, hi) in enumerate(segs):
            seg = sorted_n[lo:hi]
            if len(seg) == 0 or seg[0] == seg[-1]:
                continue
            cost0 = len(seg) * seg[-1]
            # best single split inside this segment
            for cut in np.unique(seg)[:-1]:
                idx = int(np.searchsorted(seg, cut, side="right"))
                cost = idx * cut + (len(seg) - idx) * seg[-1]
                gain = cost0 - cost
                if best is None or gain > best[0]:
                    best = (gain, si, lo + idx)
        if best is None or best[0] <= 0:
            break
        _, si, mid = best
        lo, hi = segs[si]
        segs[si : si + 1] = [(lo, mid), (mid, hi)]

    buckets = []
    for lo, hi in segs:
        if hi == lo:
            continue
        sel = order[lo:hi]
        bmax = max(int(nblk[sel].max()), 1)
        buckets.append(
            (
                torch.as_tensor(ifc_rows[sel], dtype=torch.int64, device=device),
                torch.as_tensor(blk_ids[sel, :bmax], dtype=torch.int64, device=device),
                torch.as_tensor(blk_w[sel, :bmax], dtype=dtype, device=device),
            )
        )
    return tuple(buckets)
