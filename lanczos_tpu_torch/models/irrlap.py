"""Least-squares Laplacian weights for arbitrary point clouds (any dimension).

Counterpart of ``lanczos_tpu/models/irrlap.py``: host numpy, copied as it
is, so both packages give bit-identical weights.

Re-implements the moment-matrix method of the reference's IrrLap.py
(the reference's Python/Irregular/IrrLap.py:36-125; the method's source is
papers/IrregularLaplacian.pdf) in vectorized batch form, generalized from the
reference's 3D-only matrix to d dimensions (the reference's gen-2 lattice is
2/3/6-D, Lattice.py, but its weight generator never was).

Given K neighbor offsets x_i (relative to the center point, in fine-grid
units), with distance weighting w_i = 1/|x_i|^4 (IrrLap.py:59: w=1/r**2 where
r is the SQUARED distance), build the quadratic-fit basis

    b(x) = [x_0..x_{d-1},  x_a x_b for a <= b]      (d + d(d+1)/2 terms;
                                                     9 in 3D, the reference's
                                                     IrrLap.py:64-98 matrix)

and the symmetric moment matrix M = sum_i w_i b(x_i) b(x_i)^T.  The Laplacian
functional extracts the trace of the fitted Hessian: with e = sum_a e_{x_a^2},

    weights_i = w_i * (b(x_i) . M^{-1} e)        (IrrLap.py:100-122)

The resulting weights satisfy the moment conditions sum_i v_i p(x_i) =
(Laplacian p)(0) for every polynomial p with p(0)=0 up to degree 2 — tested
against the analytic 27-point stencil like the reference's self-check
(IrrLap.py:153-169).

The reference memoizes by a collision-prone hand-rolled hash of the point
list (IrrLap.py:20-34); here deduplication is exact: clouds are grouped by a
canonical byte key and each unique cloud is solved once (numpy batch, fp64).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["laplacian_weights", "laplacian_weights_batch", "WeightCache"]


@lru_cache(maxsize=None)
def _basis_layout(nd: int) -> Tuple[Tuple[Tuple[int, int], ...], np.ndarray]:
    """Quadratic-term index pairs (a, b) a<=b, and the Laplacian extraction
    vector over the full basis [linear terms | quadratic terms]."""
    pairs = tuple((a, b) for a in range(nd) for b in range(a, nd))
    e = np.zeros(nd + len(pairs))
    for j, (a, b) in enumerate(pairs):
        if a == b:
            e[nd + j] = 1.0
    return pairs, e


def _quad_basis(points: np.ndarray) -> np.ndarray:
    """(..., K, d) offsets -> (..., K, d + d(d+1)/2) quadratic basis.

    Column order (3D): gradient x,y,z then Hessian (0,0),(0,1),(0,2),(1,1),
    (1,2),(2,2) — the reference's IrrLap.py:64-98 layout."""
    nd = points.shape[-1]
    pairs, _ = _basis_layout(nd)
    cols = [points[..., a] for a in range(nd)]
    cols += [points[..., a] * points[..., b] for a, b in pairs]
    return np.stack(cols, axis=-1)


def laplacian_weights_batch(
    points: np.ndarray, mask: Optional[np.ndarray] = None
) -> np.ndarray:
    """Weights for a batch of point clouds.

    points: (B, K, d) float/int offsets; mask: (B, K) bool of valid entries
    (padded entries and the origin get weight 0, matching the reference's
    r=0 -> weight 0 behavior, IrrLap.py:56-57).
    Returns (B, K) weights.
    """
    pts = np.asarray(points, dtype=np.float64)
    nd = pts.shape[-1]
    _, e_lap = _basis_layout(nd)
    r2 = np.sum(pts * pts, axis=-1)  # (B, K) squared distances
    valid = r2 > 0
    if mask is not None:
        valid = valid & np.asarray(mask, dtype=bool)
    with np.errstate(divide="ignore"):
        w = np.where(valid, 1.0 / np.where(valid, r2, 1.0) ** 2, 0.0)  # 1/r^4

    basis = _quad_basis(pts)  # (B, K, nb)
    bw = basis * w[..., None]
    moment = np.einsum("bki,bkj->bij", bw, basis)  # (B, nb, nb), symmetric

    rhs = np.broadcast_to(e_lap, moment.shape[:-2] + e_lap.shape)
    try:
        mit = np.linalg.solve(moment, rhs[..., None])[..., 0]  # (B, nb)
    except np.linalg.LinAlgError:
        # Singular moment matrix (degenerate cloud): least-squares fallback.
        mit = np.stack(
            [np.linalg.lstsq(m, e_lap, rcond=None)[0] for m in moment]
        )
    # The quadratic fit f ~ g.x + x^T C x has C_aa = (1/2) d^2f/dx_a^2, so the
    # extracted functional is half the Laplacian; the factor 2 restores
    # sum_i v_i x_a x_b = 2 delta_ab.  (The reference compensates with an
    # explicit *2 in MatrixWrite.py:30 but NOT in Irr3Ddeuteron.py:22 — its
    # irregular driver solves with T halved; we take the *2 as the intended
    # semantics since it is what makes the one-big-box lattice reproduce the
    # regular 27-point Hamiltonian, notes.tex:334.)
    return 2.0 * np.einsum("bki,bi->bk", bw, mit)  # 2 w_i * (b(x_i) . mit)


def laplacian_weights(points: np.ndarray) -> np.ndarray:
    """Single-cloud convenience wrapper: (K, d) -> (K,)."""
    return laplacian_weights_batch(points[None])[0]


class WeightCache:
    """Exact-key memoization of clouds -> weights (replaces the reference's
    collision-prone HashList memo table, IrrLap.py:19-45)."""

    def __init__(self):
        self._table: Dict[bytes, np.ndarray] = {}

    def __len__(self):
        return len(self._table)

    def get(self, points: np.ndarray) -> np.ndarray:
        key = np.ascontiguousarray(points, dtype=np.int64).tobytes()
        out = self._table.get(key)
        if out is None:
            out = laplacian_weights(points)
            self._table[key] = out
        return out
