"""Box-decomposed multi-resolution lattice, as arrays, in any dimension.

Counterpart of ``lanczos_tpu/models/lattice.py``: host numpy, the same
arrays.  The potential that sets the spacings is the port's own (a function
of CPU float64 tensors, e.g. :func:`deuteron_potential_3d`), and the native
neighbor engine is the port's own copy (``lanczos_tpu_torch/native``).

TPU-first redesign of the reference's irregular-grid layer
(the reference's Python/Irregular/IrrGrid.py gen-1 (3D) and Lattice.py gen-2
(2/3/6-D)).  The reference walks a per-point object graph (Box instances,
dict-keyed neighbor displacement tables, three-case Python branching per
point, IrrGrid.py:67-138); here the whole lattice is a handful of flat arrays
and the neighbor search is vectorized over all points at once:

* an occupancy grid maps every fine-grid coordinate to its point index (or
  -1), collapsing the reference's box-hopping coordinate conversions into one
  gather;
* the three cases of the reference's search reduce to two vectorized paths:
  a fast path (all nearby boxes share the point's spacing: neighbors are the
  aligned (2D+1)^nd sub-lattice stencil) and an edge path (any differing
  spacing nearby: scan the fine cube of radius D*local_a, keep points that
  exist AND whose mirror image through the center exists — the reference's
  mirror-symmetry filter, IrrGrid.py:125-137 / symetry.py:6-36);
* spacing selection reproduces CalculatePointDensity (IrrGrid.py:309-337):
  per-box a ~ sqrt(E_max/E), E = max deviation of the potential from the
  target energies E0, rounded up to a power of two and clamped to
  N_per_box // 8, with the same ``overwrite_spacing`` debug mode
  (IrrGrid.py:330-334);
* dimension is a parameter (``ndim``), covering the reference's gen-2 scope
  (Lattice.py:67 handles dims {2,3,6}; its 6-D index arithmetic bug in
  tools2.py:27-34 is documented in SURVEY.md and does not carry over — the
  ravel here is positional by construction).

Conventions mirrored from the reference: fine spacing s = L/(N-1)
(IrrGrid.py:62), potential centered at L/2 (IrrGrid.py:63), axis-0-fastest
point ordering within each box (IrrGrid.py:32), periodic boundary conditions,
flat index = sum_a c_a * N^a.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

# Above this many fine-grid cells the dense occupancy array (8 B/cell) is
# replaced by a sorted-index table: 2**28 cells = 2 GB, the practical dense
# ceiling; any 6-D lattice beyond N=25 crosses it (the reference's dense-array
# equivalent is what made its gen-2 6-D line unrunnable at scale).
DENSE_OCCUPANCY_LIMIT = 2**28

__all__ = [
    "IrregularLattice",
    "DENSE_OCCUPANCY_LIMIT",
    "potential_spacings",
    "build_lattice",
    "find_neighbors",
    "mirror_symmetric_filter",
]


def mirror_symmetric_filter(points: np.ndarray) -> np.ndarray:
    """Keep only points whose mirror image through the origin across every
    axis-combination also exists in the cloud.

    Standalone form of the reference's FindMirrorSymetricPoints
    (the reference's Python/Irregular/symetry.py:6-36; the same idea runs
    inline in GetNearbyPoints, IrrGrid.py:125-137): a cloud closed under all
    sign-flip combinations has vanishing odd moments, which keeps the
    least-squares Laplacian fit well-posed.  Vectorized: set membership via
    byte-keyed lookup instead of the reference's O(P^2) list scans.
    """
    pts = np.asarray(points, dtype=np.int64)
    nd = pts.shape[1]
    have = {row.tobytes() for row in pts}
    keep = np.ones(len(pts), dtype=bool)
    for signs in itertools.product((1, -1), repeat=nd):
        if all(s == 1 for s in signs):
            continue
        flipped = pts * np.asarray(signs, dtype=np.int64)
        keep &= np.fromiter(
            (row.tobytes() in have for row in flipped), bool, len(pts)
        )
    return pts[keep]


@dataclasses.dataclass(frozen=True)
class IrregularLattice:
    """Flat-array lattice description.

    coords:        (P, nd) int fine-grid coordinates of every lattice point.
    box_of_point:  (P,) box id owning each point.
    spacings:      (nr_boxes,) spacing a_b (units of the fine grid).
    occupancy:     (N^nd,) flat map fine coord -> point idx, -1 where empty
                   (flat index = sum_a c_a * N^a, axis 0 fastest), or None
                   when N^nd exceeds DENSE_OCCUPANCY_LIMIT — high-dimension
                   lattices (the reference's gen-2 6-D scope, Lattice.py:67)
                   would need terabytes dense; lookups then go through a
                   sorted flat-index table (sorted_flat/sorted_order) via
                   binary search, O(log P) per coord, vectorized.
    """

    n_fine: int
    length: float
    box_depth: int
    spacings: np.ndarray
    coords: np.ndarray
    box_of_point: np.ndarray
    occupancy: Optional[np.ndarray]
    box_starts: np.ndarray
    ndim: int = 3
    sorted_flat: Optional[np.ndarray] = None
    sorted_order: Optional[np.ndarray] = None

    @property
    def num_points(self) -> int:
        return self.coords.shape[0]

    @property
    def n_per_box(self) -> int:
        return self.n_fine // self.box_depth

    @property
    def s(self) -> float:
        # Fine-grid physical spacing (IrrGrid.py:62).
        return self.length / (self.n_fine - 1)

    @property
    def potential_center(self) -> float:
        return self.length / 2.0

    @property
    def strides(self) -> np.ndarray:
        return self.n_fine ** np.arange(self.ndim, dtype=np.int64)

    def physical_coords(self) -> np.ndarray:
        """(P, nd) physical coordinates centered on the potential
        (IrrHamiltonian.py:32: coords*s - center)."""
        return self.coords * self.s - self.potential_center

    def flat_index(self, coords: np.ndarray) -> np.ndarray:
        c = np.mod(coords, self.n_fine)
        return c @ self.strides

    def lookup(self, coords: np.ndarray) -> np.ndarray:
        """Point index at the given fine coords (-1 where no point exists)."""
        f = self.flat_index(coords)
        if self.occupancy is not None:
            return self.occupancy[f]
        pos = np.minimum(
            np.searchsorted(self.sorted_flat, f), len(self.sorted_flat) - 1
        )
        return np.where(self.sorted_flat[pos] == f, self.sorted_order[pos], -1)


def _box_corners(box_depth: int, npb: int, ndim: int) -> np.ndarray:
    """(nb, nd) fine-grid corner of every box; box id = sum_a b_a * bd^a
    (axis 0 fastest, the reference's [[i,j,k] for k for j for i] order)."""
    axes = [range(box_depth)] * ndim
    # itertools.product varies the LAST factor fastest; we want axis 0
    # fastest, so build tuples reversed.
    corners = np.array(
        [t[::-1] for t in itertools.product(*axes[::-1])], dtype=np.int64
    )
    return corners * npb


def potential_spacings(
    n_fine: int,
    length: float,
    box_depth: int,
    potential: Callable,
    *,
    ndim: int = 3,
    target_energies: Sequence[float] = (-1.626, 10.286),
    samples: Optional[int] = None,
    overwrite_spacing: bool = False,
    power_of_two: bool = True,
    balance: bool = True,
) -> np.ndarray:
    """Per-box spacing from the potential's local scale.

    Implements CalculatePointDensity (IrrGrid.py:309-337): sample the
    potential on a samples^nd grid per box, E_b = max over the target
    energies E0 of max|V - E0|, a_factor = sqrt(max_b E_b / E_b), rounded UP
    to a power of two (the writeup's spacing rule a ~ 1/sqrt(E),
    notes.tex:244-281) and clamped to n_per_box // 8 so no box drops below
    8 points per dimension.  ``power_of_two=False`` keeps the reference's
    exact clamp ``min(int(2^ceil), n_per_box//8)`` which can produce a
    non-power value (e.g. 5); True (default) clamps to the largest power of
    two <= the cap, the gen-2 constraint (Lattice.py:30-33).

    ``balance=True`` (default) additionally enforces 2:1 grading: adjacent
    boxes ((3^nd - 1)-neighborhood, periodic) may differ by at most a factor
    of 2 in spacing.  The reference has no such constraint and can produce
    1->4 jumps, at which the least-squares interface stencils lose
    definiteness and the kinetic operator grows large spurious
    interface-localized eigenmodes (observed empirically on the N=120
    deuteron lattice; the reference never validated this regime).  2:1
    grading is the standard AMR cure.
    """
    assert n_fine % box_depth == 0
    npb = n_fine // box_depth
    s = length / (n_fine - 1)
    center = length / 2.0
    nb = box_depth**ndim

    if overwrite_spacing:
        # Debug mode (IrrGrid.py:330-334): uniform 2 with a fine center box.
        a = np.ones(nb, dtype=np.int64)
        if nb > 2:
            a[:] = 2
            a[nb // 2] = 1
        return a

    if samples is None:
        # ~101^3 total potential evaluations per box regardless of dimension.
        samples = max(5, int(round(101 ** (3.0 / ndim))))
    corners = _box_corners(box_depth, npb, ndim)
    lin = np.linspace(0, length / box_depth, samples)
    grids = np.meshgrid(*([lin] * ndim), indexing="ij")
    off = corners * s - center  # (nb, nd)
    e0 = np.asarray(target_energies, dtype=np.float64)
    # Sampled on the host in float64, one box at a time (S^nd points each):
    # box corner offset + in-box sample per axis.
    e_box = np.empty(nb)
    for b in range(nb):
        coords = [torch.from_numpy(grids[a] + off[b, a]) for a in range(ndim)]
        pot = np.asarray(potential(*coords), dtype=np.float64)
        e_box[b] = np.abs(pot[..., None] - e0).max()
    a_factor = np.sqrt(e_box.max() / e_box)
    a = 2 ** np.ceil(np.log2(a_factor))
    cap = max(npb // 8, 1)
    if power_of_two:
        cap = 2 ** int(np.floor(np.log2(cap)))
    a = np.minimum(a.astype(np.int64), cap)
    a = np.maximum(a, 1)
    if balance:
        a = _balance_spacings(a, box_depth, ndim)
    return a


def _balance_spacings(a: np.ndarray, box_depth: int, ndim: int = 3) -> np.ndarray:
    """Enforce 2:1 grading across the periodic (3^nd - 1)-neighborhood."""
    a = a.copy()
    bd = box_depth
    idx = np.arange(bd**ndim)
    bcoord = [(idx // bd**k) % bd for k in range(ndim)]
    for _ in range(bd * ndim):  # more than enough sweeps to reach the fixpoint
        changed = False
        for disp in itertools.product((-1, 0, 1), repeat=ndim):
            if not any(disp):
                continue
            nbr = sum(
                ((bcoord[k] + disp[k]) % bd) * bd**k for k in range(ndim)
            )
            cap = 2 * a[nbr]
            over = a > cap
            if over.any():
                a[over] = cap[over]
                changed = True
        if not changed:
            break
    return a


def build_lattice(
    n_fine: int,
    length: float,
    box_depth: int,
    spacings: Optional[np.ndarray] = None,
    *,
    ndim: int = 3,
    potential: Optional[Callable] = None,
    overwrite_spacing: bool = False,
    **spacing_kwargs,
) -> IrregularLattice:
    """Construct the lattice arrays (vectorized; replaces IrrGrid.SetupBoxes
    and the gen-2 Lattice.setup_boxes, any dimension)."""
    if n_fine % box_depth != 0:
        raise ValueError(
            f"n_fine={n_fine} must be a multiple of box_depth={box_depth}"
        )
    npb = n_fine // box_depth
    nb = box_depth**ndim
    if spacings is None:
        if overwrite_spacing or potential is None:
            spacings = potential_spacings(
                n_fine, length, box_depth, potential or (lambda *c: 0 * c[0]),
                ndim=ndim, overwrite_spacing=True,
            )
        else:
            spacings = potential_spacings(
                n_fine, length, box_depth, potential,
                ndim=ndim, overwrite_spacing=False, **spacing_kwargs,
            )
    spacings = np.asarray(spacings, dtype=np.int64)
    assert spacings.shape == (nb,)
    if np.any(npb % spacings):
        raise ValueError(
            f"every spacing must divide n_per_box={npb}, got {spacings}"
        )

    corners = _box_corners(box_depth, npb, ndim)
    counts = (npb // spacings) ** ndim
    box_starts = np.concatenate([[0], np.cumsum(counts)])
    total = int(box_starts[-1])

    coords = np.empty((total, ndim), dtype=np.int64)
    box_of_point = np.empty(total, dtype=np.int32)
    for b in range(nb):
        a = int(spacings[b])
        n_loc = npb // a
        r = np.arange(n_loc, dtype=np.int64) * a
        # Axis 0 fastest (IrrGrid.py:32): [[i,j,k] for k for j for i].
        grids = np.meshgrid(*([r] * ndim), indexing="ij")
        pts = np.stack([g.ravel() for g in grids[::-1]], axis=1)
        coords[box_starts[b] : box_starts[b + 1]] = pts + corners[b]
        box_of_point[box_starts[b] : box_starts[b + 1]] = b

    strides = n_fine ** np.arange(ndim, dtype=np.int64)
    flat = coords @ strides
    if n_fine**ndim <= DENSE_OCCUPANCY_LIMIT:
        occupancy = np.full(n_fine**ndim, -1, dtype=np.int64)
        occupancy[flat] = np.arange(total)
        sorted_flat = sorted_order = None
    else:
        occupancy = None
        sorted_order = np.argsort(flat, kind="stable")
        sorted_flat = flat[sorted_order]

    return IrregularLattice(
        n_fine=n_fine,
        length=length,
        box_depth=box_depth,
        spacings=spacings,
        coords=coords,
        box_of_point=box_of_point,
        occupancy=occupancy,
        box_starts=box_starts,
        ndim=ndim,
        sorted_flat=sorted_flat,
        sorted_order=sorted_order,
    )


def _box_of_coord(lat: IrregularLattice, coords: np.ndarray) -> np.ndarray:
    bd = lat.box_depth
    c = np.mod(coords, lat.n_fine) // lat.n_per_box
    return c @ (bd ** np.arange(lat.ndim, dtype=np.int64))


def _local_max_spacing(lat: IrregularLattice, idx: np.ndarray, d: int):
    """For each point: (max spacing among boxes its +-D*a cube touches,
    GCD of the touched spacings, whether any touched box has a different
    spacing).

    Vectorized version of IsCloseToEdge / IsCloseToEdgeWithDifferentSpacing +
    the "FINDING BIGGEST LOCAL a" step (IrrGrid.py:102-107, 219-242).

    The GCD (not the minimum) is the exact step for the edge scan: a
    neighbor in a box with spacing a_t sits at an offset that is a multiple
    of gcd(a_own, a_t), so scanning the GCD sublattice misses nothing even
    for non-power-of-two spacing mixes like {2, 3}.  For power-of-two
    spacings gcd == min, so the common case costs the same."""
    p = lat.coords[idx]  # (Q, nd)
    a_own = lat.spacings[lat.box_of_point[idx]]  # (Q,)
    reach = (d * a_own)[:, None]  # (Q, 1)
    a_max = a_own.copy()
    a_gcd = a_own.copy()
    differs = np.zeros(len(idx), dtype=bool)
    for disp in itertools.product((-1, 0, 1), repeat=lat.ndim):
        dv = np.asarray(disp, dtype=np.int64)
        touched = _box_of_coord(lat, p + dv * reach)
        a_t = lat.spacings[touched]
        a_max = np.maximum(a_max, a_t)
        a_gcd = np.gcd(a_gcd, a_t)
        differs |= a_t != a_own
    return a_max, a_gcd, differs


def _displacements(d: int, ndim: int) -> np.ndarray:
    """Nonzero displacement tuples in [-d, d]^nd, axis order matching the
    reference's itertools.product scan (component 0 slowest)."""
    return np.array(
        [v for v in itertools.product(range(-d, d + 1), repeat=ndim) if any(v)],
        dtype=np.int64,
    )


def find_neighbors(
    lat: IrregularLattice,
    d: int,
    idx: Optional[np.ndarray] = None,
    *,
    chunk: int = 4096,
    backend: str = "auto",
) -> Tuple[np.ndarray, np.ndarray]:
    """Neighbor point indices within grid distance D (excluding self).

    Returns (neighbors (Q, K) padded with -1, rel_offsets (Q, K, nd)
    fine-grid relative positions).  Semantics follow GetNearbyPoints
    (IrrGrid.py:67-138): interior / same-spacing points get the aligned
    (2D+1)^nd - 1 stencil at their own spacing; points near a box with a
    different spacing search the fine cube of radius D * local_a and keep
    only mirror-symmetric existing points.

    backend: "auto" (native C++ engine when available, else numpy),
    "native" (require the C++ engine), or "numpy".  The native engine
    covers the 3D case (the reference's production line); other dimensions
    always use the numpy path.
    """
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend in ("auto", "native") and lat.ndim == 3:
        from ..native import find_neighbors_native

        out = find_neighbors_native(lat, d, idx)
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError(
                "native neighbor engine unavailable (g++ build failed, or the"
                " lattice exceeds the dense-occupancy limit)"
            )
    elif backend == "native":
        raise RuntimeError(f"native neighbor engine supports 3D only, lattice is {lat.ndim}D")
    if idx is None:
        idx = np.arange(lat.num_points)
    idx = np.asarray(idx)
    q = len(idx)
    nd = lat.ndim
    a_own = lat.spacings[lat.box_of_point[idx]]
    local_a, local_agcd, differs = _local_max_spacing(lat, idx, d)

    disp_unit = _displacements(d, nd)  # ((2d+1)^nd - 1, nd)
    s_fast = disp_unit.shape[0]

    # Every lattice coordinate is a multiple of its box spacing (box corners
    # are multiples of n_per_box, which every spacing divides), so any
    # neighbor's offset from the query point is a multiple of the GCD of the
    # touched spacings: the edge scan steps by that GCD instead of 1.
    # Identical results to the fine scan (skipped offsets can never hit a
    # point), but (a_max/gcd)^nd fewer candidates — the difference between
    # intractable (17^6) and cheap (5^6) in 6-D.
    ratio = d * local_a // np.maximum(local_agcd, 1)
    k_edge = int((2 * ratio.max() + 1) ** nd - 1) if differs.any() else 0
    k = max(s_fast, k_edge)

    nbrs = np.full((q, k), -1, dtype=np.int64)
    rels = np.zeros((q, k, nd), dtype=np.int64)

    # Fast path: aligned sub-lattice stencil at own spacing.
    fast = ~differs
    if fast.any():
        fi = np.nonzero(fast)[0]
        p = lat.coords[idx[fi]]  # (F, nd)
        offs = disp_unit[None] * a_own[fi, None, None]  # (F, S, nd)
        found = lat.lookup(p[:, None, :] + offs)
        assert (found >= 0).all(), "aligned stencil point missing from lattice"
        nbrs[fi, :s_fast] = found
        rels[fi, :s_fast] = offs

    # Edge path: cube scan + mirror filter, grouped by (radius, step).
    if differs.any():
        ei_all = np.nonzero(differs)[0]
        rs = d * local_a
        key = rs * (local_a.max() + 1) + local_agcd
        for kk in np.unique(key[ei_all]):
            sel = ei_all[key[ei_all] == kk]
            r = int(rs[sel[0]])
            step = int(local_agcd[sel[0]])
            cube = step * _displacements(r // step, nd)  # (C, nd)
            for lo in range(0, len(sel), chunk):
                ii = sel[lo : lo + chunk]
                p = lat.coords[idx[ii]]  # (B, nd)
                cand = p[:, None, :] + cube[None]  # (B, C, nd)
                exist = lat.lookup(cand)
                mirror_ok = lat.lookup(p[:, None, :] - cube[None]) >= 0
                keep = (exist >= 0) & mirror_ok  # (B, C)
                counts = keep.sum(axis=1)
                assert counts.max() <= k
                # Scatter kept candidates left-packed into the output rows.
                brow, bcol = np.nonzero(keep)  # row-major: per-row consecutive
                pos = np.arange(len(brow)) - np.repeat(
                    np.cumsum(counts) - counts, counts
                )
                nbrs[ii[brow], pos] = exist[brow, bcol]
                rels[ii[brow], pos] = cube[bcol]

    # Trim the padding to the true max degree.
    k_true = int((nbrs >= 0).sum(axis=1).max()) if q else 0
    return nbrs[:, :k_true], rels[:, :k_true]
