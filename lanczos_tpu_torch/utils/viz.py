"""Figures for checking a lattice or a solve by eye (matplotlib, host only).

Counterpart of ``lanczos_tpu/utils/viz.py``: the same four functions, the
same figures.  Each returns a matplotlib ``Figure`` instead of showing it,
so it works headless (Agg) and in notebooks alike.  Arrays may be numpy
arrays or tensors on any device; lattices are the port's
``IrregularLattice``.  matplotlib is imported only when a function is
called: no solver path imports this module, and the package imports
without matplotlib.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .._util import to_numpy

__all__ = [
    "plot_lattice",
    "plot_neighbors",
    "plot_eigenvectors_1d",
    "plot_convergence",
]


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_lattice(lat, axis: int = 2, slice_coord: int = 0, ax=None):
    """Scatter of the lattice points in a 2D slice, colored by spacing.

    For 2D lattices plots everything; for 3D+ plots the points whose
    ``axis`` coordinate equals ``slice_coord`` (the reference's
    visualize_Lattice.py:28-36 scatter).
    """
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    coords = lat.coords
    if lat.ndim > 2:
        sel = coords[:, axis] == slice_coord
        coords = coords[:, [a for a in range(lat.ndim) if a != axis]][sel]
        spac = lat.spacings[lat.box_of_point[sel]]
    else:
        spac = lat.spacings[lat.box_of_point]
    for a in np.unique(spac):
        pts = coords[spac == a]
        ax.scatter(pts[:, 0], pts[:, 1], s=6, label=f"a={a}")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(f"lattice N={lat.n_fine}, {lat.num_points} points")
    return ax.figure


def plot_neighbors(lat, point: int, d: int = 1, axis: int = 2, ax=None):
    """Scatter a point's neighbor stencil in the slice through the point
    (the reference's Test_Plot_GetNearbyPoints, testing.py:31-71)."""
    from ..models.lattice import find_neighbors

    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    nbrs, rels = find_neighbors(lat, d, np.array([point]))
    nbrs, rels = nbrs[0], rels[0]
    keep = nbrs >= 0
    p = lat.coords[point]
    in_plane = keep & (rels[:, axis] == 0) if lat.ndim > 2 else keep
    others = [a for a in range(lat.ndim) if a != axis][:2] if lat.ndim > 2 else [0, 1]
    pts = (p + rels[in_plane])[:, others]
    ax.scatter(pts[:, 0], pts[:, 1], s=24, label="neighbors")
    ax.scatter([p[others[0]]], [p[others[1]]], s=60, marker="*", label="center")
    ax.set_aspect("equal")
    ax.legend(fontsize=8)
    ax.set_title(f"point {point}: {int(keep.sum())} neighbors (D={d})")
    return ax.figure


def plot_eigenvectors_1d(grid_coords, eigenvectors, eigenvalues=None, k: int = 4, ax=None):
    """Overlay the lowest-k 1D eigenvectors (Regular/1Dbox.py:35-40)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(7, 4))
    x = to_numpy(grid_coords)
    vecs = to_numpy(eigenvectors)
    vals = None if eigenvalues is None else to_numpy(eigenvalues)
    for i in range(min(k, vecs.shape[1])):
        label = f"state {i}"
        if vals is not None:
            label += f" (E={float(vals[i]):.4g})"
        ax.plot(x, vecs[:, i], label=label)
    ax.legend(fontsize=8)
    ax.set_xlabel("x")
    ax.set_ylabel("amplitude")
    return ax.figure


def plot_convergence(residual_history: Sequence[float], ax=None):
    """Residual-vs-iteration semilog plot (the reference only prints)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 4))
    ax.semilogy(to_numpy(residual_history))
    ax.set_xlabel("iteration")
    ax.set_ylabel("residual")
    ax.grid(True, which="both", alpha=0.3)
    return ax.figure
