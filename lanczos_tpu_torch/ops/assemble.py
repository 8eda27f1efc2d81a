"""Host-side sparse assembly: COO triplets -> padded ELL, format conversions.

Counterpart of ``lanczos_tpu/ops/assemble.py``.  Assembly is O(nnz)
vectorized numpy on the host; the resulting ELL arrays are placed on the
target device once and stay there for the whole Krylov run.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._util import DEFAULT_DEVICE, as_numpy_dtype, as_torch_dtype, to_numpy
from .operators import EllOperator, StencilOperator

__all__ = [
    "ell_from_coo",
    "ell_from_scipy",
    "stencil_to_ell",
    "coo_sum_duplicates",
]


def coo_sum_duplicates(rows, cols, vals, m):
    """Merge duplicate (row, col) entries by summation. Returns sorted COO."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    key = rows * m + cols
    order = np.argsort(key, kind="stable")
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    unique_mask = np.empty(len(key), dtype=bool)
    unique_mask[0:1] = True
    unique_mask[1:] = key[1:] != key[:-1]
    group_ids = np.cumsum(unique_mask) - 1
    out_vals = np.zeros(group_ids[-1] + 1 if len(group_ids) else 0, dtype=vals.dtype)
    np.add.at(out_vals, group_ids, vals)
    return rows[unique_mask], cols[unique_mask], out_vals


def ell_from_coo(
    rows,
    cols,
    vals,
    m: int,
    dtype=torch.float32,
    k_pad: Optional[int] = None,
    sum_duplicates: bool = True,
    device=DEFAULT_DEVICE,
) -> EllOperator:
    """Build a padded-ELL operator from COO triplets.

    Rows with fewer than K entries are padded with (col=row, val=0).  K is the
    max row length, optionally rounded up to ``k_pad``.
    """
    np_dtype = as_numpy_dtype(dtype)
    if sum_duplicates and len(np.atleast_1d(rows)):
        rows, cols, vals = coo_sum_duplicates(rows, cols, vals, m)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)

    counts = np.bincount(rows, minlength=m)
    k = int(counts.max()) if len(counts) else 1
    if k_pad is not None:
        k = max(k, int(k_pad))
    k = max(k, 1)

    order = np.argsort(rows, kind="stable")
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]

    from ..native import pack_ell_native

    packed = pack_ell_native(rows_s, cols_s, vals_s, m, k)
    if packed is not None:
        ell_cols, ell_vals = packed
    else:
        # numpy path (no C++ compiler): each entry's position in its row.
        row_starts = np.concatenate([[0], np.cumsum(counts)])
        pos_in_row = np.arange(len(rows_s)) - row_starts[rows_s]
        ell_cols = np.tile(np.arange(m, dtype=np.int64)[:, None], (1, k))
        ell_vals = np.zeros((m, k), dtype=np_dtype)
        ell_cols[rows_s, pos_in_row] = cols_s
        ell_vals[rows_s, pos_in_row] = vals_s

    return EllOperator(
        cols=torch.as_tensor(ell_cols, device=device),
        vals=torch.as_tensor(ell_vals, dtype=as_torch_dtype(dtype), device=device),
    )


def ell_from_scipy(
    A, dtype=None, k_pad: Optional[int] = None, device=DEFAULT_DEVICE
) -> EllOperator:
    """Convert a scipy sparse matrix to a padded-ELL operator."""
    coo = A.tocoo()
    if dtype is None:
        dtype = coo.data.dtype
    if coo.shape[0] != coo.shape[1]:
        raise ValueError(f"operator must be square, got {coo.shape}")
    return ell_from_coo(
        coo.row, coo.col, coo.data, coo.shape[0], dtype=dtype, k_pad=k_pad,
        device=device,
    )


def stencil_to_ell(op: StencilOperator) -> EllOperator:
    """Materialize a StencilOperator as padded ELL (vectorized, O(M*k)),
    on the operator's device.

    Every row has the same k-tap structure, so no COO sort/dedup is needed
    (the diagonal merges into the stencil's center tap).
    """
    grid_shape = op.grid_shape
    m = int(np.prod(grid_shape))
    ndim = len(grid_shape)
    gs = np.asarray(grid_shape, dtype=np.int64)
    # coords[a] of every flat index, slow->fast: flat = sum_a c[a]*stride[a].
    coords = np.stack(
        np.unravel_index(np.arange(m, dtype=np.int64), grid_shape), axis=0
    )  # (ndim, M)
    strides = np.ones(ndim, dtype=np.int64)
    for a in range(ndim - 2, -1, -1):
        strides[a] = strides[a + 1] * grid_shape[a + 1]

    offsets = np.asarray(op.offsets, dtype=np.int64)  # (k, ndim)
    weights = to_numpy(op.weights)
    k = offsets.shape[0]

    ell_cols = np.empty((m, k), dtype=np.int64)
    for j in range(k):  # k is small (<= 27); each pass is vectorized over M
        nbr = (coords + offsets[j][:, None]) % gs[:, None]  # (ndim, M)
        ell_cols[:, j] = strides @ nbr
    ell_vals = np.broadcast_to(weights, (m, k)).copy()

    center = [j for j in range(k) if not offsets[j].any()]
    if op.diag is not None:
        diag = to_numpy(op.diag)
        if center:
            ell_vals[:, center[0]] += diag
        else:
            ell_cols = np.concatenate(
                [ell_cols, np.arange(m, dtype=np.int64)[:, None]], axis=1
            )
            ell_vals = np.concatenate([ell_vals, diag[:, None]], axis=1)

    return EllOperator(
        cols=torch.as_tensor(ell_cols, device=op.device),
        vals=torch.as_tensor(ell_vals, device=op.device),
    )
