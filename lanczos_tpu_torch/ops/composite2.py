"""Composite multi-level operator, generation 2 (CompositeV2): region-native
layout, per-level stencil kernels, and strided interface classes.

Counterpart of ``lanczos_tpu/ops/composite2.py``, the irregular lattice's
production format:

* REGION-NATIVE VECTOR LAYOUT.  Each spacing level occupies a rectangular
  region of its coarse grid (its bounding box, or the full periodic torus
  when the level wraps); the operator's vectors are the flat concatenation
  of these regions, dead slots included.  Each level is a contiguous slice.
* One regular-grid stencil per level: the port's StencilOperator, so the
  CUDA stencil SpMV/SpMM kernels (``ops/stencil_kernels.py``) on a card.
  Rows whose stencil would read a site the level does not own are interface
  rows; their stencil value is masked off (``keep``) and replaced.  Dead
  slots are annihilated by the same mask: A e_dead = 0 exactly, so the v2
  matrix has an eigenvalue 0 of multiplicity M - P.  A Krylov start vector
  must be multiplied by ``live``: then the whole basis stays exactly zero
  on the dead slots and that 0 never enters the computation.
* Interface rows grouped by stencil SIGNATURE into classes that tile
  rectangular affine grids; each tap of a class is one strided slice of its
  source level's region.  Every class is applied by one launch of the CUDA
  interface kernel (``ops/interface_kernel.py``; its plain version on the
  CPU), at any stride: the operator always carries the kernel's tables, so
  the JAX package's ``fuse_interface`` switch and its fallback classes have
  no counterpart here.
* Rows that defy the affine detection fall back to a bucketed block-ELL
  tail (``ops/composite.py``), plain PyTorch gathers (:func:`ell_tail`), as
  in the JAX package.

The operator is numerically the padded-ELL assembly's operator from the
same rows (tests/test_torch_composite2.py holds it against both packages).
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .._util import DEFAULT_DEVICE, as_numpy_dtype, as_torch_dtype
from .composite import IFC_W, _block_ell_buckets
from .interface_kernel import FusedInterface, apply_fused_interface
from .operators import LinearOperator, StencilOperator

__all__ = ["CompositeV2", "build_composite_v2", "ell_tail"]


def ell_tail(x, ifc_buckets, y):
    """Add the block-ELL tail (the interface rows no strided class covers)
    into ``y`` in place and return it; plain PyTorch gathers.

    ``x``/``y``: the flat (M,) vector or (M, b) block in region-native layout.
    """
    m = y.shape[0]
    pad = (-m) % IFC_W
    xp = torch.nn.functional.pad(x, (0, 0) * (x.ndim - 1) + (0, pad)) if pad else x
    xb = xp.reshape(-1, IFC_W, *x.shape[1:])
    spec = "rbw,rbw->r" if x.ndim == 1 else "rbw,rbwc->rc"
    for rows, blk_ids, blk_w in ifc_buckets:
        y.index_add_(0, rows, torch.einsum(spec, blk_w, xb[blk_ids]))
    return y


# ---------------------------------------------------------------------------
# Host-side geometry helpers (the JAX package's, unchanged)


def _try_grid(coords: np.ndarray):
    """If coords (R, 3) form a full rectangular affine grid, return
    (origin (3,), steps (3,), shape (3,)); else None.  Column order is the
    lattice's (x, y, z)."""
    origin = coords.min(axis=0)
    steps = np.ones(3, dtype=np.int64)
    shape = np.ones(3, dtype=np.int64)
    pos = np.zeros_like(coords)
    for a in range(3):
        u = np.unique(coords[:, a])
        shape[a] = len(u)
        if len(u) > 1:
            d = np.diff(u)
            if (d != d[0]).any():
                return None
            steps[a] = d[0]
        pos[:, a] = np.searchsorted(u, coords[:, a])
    if int(np.prod(shape)) != len(coords):
        return None
    key = (pos[:, 2] * shape[1] + pos[:, 1]) * shape[0] + pos[:, 0]
    if len(np.unique(key)) != len(coords):
        return None
    return origin, steps, shape


def _detect_grids(coords: np.ndarray, max_pieces: int = 256) -> list:
    """Decompose a point set into full rectangular affine grids.

    Returns [(sel, origin, steps, shape), ...] with ``sel`` index arrays into
    ``coords``; pieces that would exceed ``max_pieces`` are returned with
    ``origin=None`` (callers route those to the ELL fallback).

    Split strategy: value GAPS first (separates e.g. the two opposite faces
    of a mirror-symmetric class, which share a signature but sit apart);
    when gaps are uniform, PEEL the two extremal slabs off the axis with the
    most distinct values — a box-shell class (the dominant interface shape)
    then decomposes into its 6 faces + 12 edges + 8 corners, each a grid.
    """
    out = []
    stack = [np.arange(len(coords))]
    while stack:
        sel = stack.pop()
        sub = coords[sel]
        g = _try_grid(sub)
        if g is not None:
            out.append((sel, *g))
            continue
        if len(out) + len(stack) >= max_pieces:
            out.append((sel, None, None, None))  # give up -> fallback
            continue
        naxis = [len(np.unique(sub[:, a])) for a in range(3)]
        a = int(np.argmax(naxis))
        u = np.unique(sub[:, a])
        d = np.diff(u)
        if len(u) > 1 and (d > d.min()).any():
            cuts = u[1:][d > d.min()]
            groups = np.searchsorted(cuts, sub[:, a], side="right")
            for gid in np.unique(groups):
                stack.append(sel[groups == gid])
        else:
            # Peel {a = min}, {a = max}, middle; each piece loses distinct
            # values along a, so this terminates.
            lo = sub[:, a] == u[0]
            hi = sub[:, a] == u[-1]
            stack.append(sel[lo])
            if u[0] != u[-1]:
                stack.append(sel[hi])
            mid = ~(lo | hi)
            if mid.any():
                stack.append(sel[mid])
    return out


def _transpose_rows(nbrs: np.ndarray, rels: np.ndarray, weights: np.ndarray):
    """Transpose assembled rows: directed edge (i -> j, w) becomes (j -> i, w)
    with the negated relative displacement.  Vectorized (argsort-by-dest +
    bincount placement); returns (nbrsT, relsT, weightsT) in the same padded
    row format (width = max in-degree).

    This is the assembly-time route to A^T for the genuinely non-symmetric
    irregular LSQ Laplacian (reference two-sided recurrence needs H^T p every
    step, the reference's Irregular/IrrLanczos.py:127)."""
    p, k = nbrs.shape
    flat_n = nbrs.reshape(-1)
    valid = flat_n >= 0
    src = np.repeat(np.arange(p, dtype=np.int64), k)[valid]
    dst = flat_n[valid]
    w = weights.reshape(-1)[valid]
    r = rels.reshape(p * k, -1)[valid]
    order = np.argsort(dst, kind="stable")
    dst, src, w, r = dst[order], src[order], w[order], r[order]
    counts = np.bincount(dst, minlength=p)
    kt = int(counts.max()) if len(counts) else 0
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(len(dst)) - starts[dst]
    nbrsT = np.full((p, kt), -1, dtype=nbrs.dtype)
    relsT = np.zeros((p, kt, rels.shape[2]), dtype=rels.dtype)
    weightsT = np.zeros((p, kt), dtype=weights.dtype)
    nbrsT[dst, pos] = src
    relsT[dst, pos] = -r
    weightsT[dst, pos] = w
    return nbrsT, relsT, weightsT


def _axis_wrap_start(lo: int, hi: int, n: int):
    """Uniform periodic wrap check for a tap along one axis: source values
    span [lo, hi].  Returns the wrapped start or None on mixed wrap."""
    if 0 <= lo and hi < n:
        return lo
    if -n <= lo and hi < 0:
        return lo + n
    if n <= lo and hi < 2 * n:
        return lo - n
    return None


# ---------------------------------------------------------------------------
# Operator


class CompositeV2(LinearOperator):
    """H = diag + per-level regular stencils + strided interface classes.

    Vector layout: flat concatenation of the per-level grid regions (levels
    ascending by spacing; within a region raster order, z slowest, x
    fastest).  Dead slots carry exact zeros; scatter/gather lattice-order
    vectors through ``idx_map`` (returned by build_composite_v2) and mask
    start vectors with ``live``.

    Buffers: ``diag`` (M,), ``keep`` (M,) 1 on live non-interface rows,
    ``live`` (M,) 1 on slots holding a lattice point, and the ELL tail
    buckets (``ifc_buckets``); ``level_ops`` is a ModuleList of the levels'
    StencilOperators, ``fused`` the FusedInterface (the interface kernel's
    tables and the classes' tap weights, ``grid_w``), ``transpose_op`` A^T
    as a second CompositeV2 or None.

    Static geometry (plain attributes, as in the JAX package):

    level_meta[l] = (a, grid_shape (3), start) — region slice
        [start, start + prod(grid_shape)) of the operator vector.
    grid_meta[i]  = (row_level, out_start (3), interior (3), acc_shape (3),
        taps) with each tap (src_level, start (3), limit (3), stride (3)) —
        a strided slice of the source level's region, weighted by
        ``grid_w[i]``'s entry; the class result enters the row level's
        region at out_start with step interior + 1.
    """

    def __init__(
        self,
        diag: torch.Tensor,
        keep: torch.Tensor,
        live: torch.Tensor,
        level_ops: Sequence[StencilOperator],
        grid_w: Sequence[torch.Tensor],
        ifc_buckets,
        level_meta,
        grid_meta,
        symmetric: bool = False,
        transpose_op: Optional["CompositeV2"] = None,
    ):
        super().__init__()
        self.register_buffer("diag", diag)
        self.register_buffer("keep", keep)
        self.register_buffer("live", live)
        self.level_ops = nn.ModuleList(level_ops)
        self.fused = FusedInterface(grid_meta, level_meta, grid_w, diag.dtype, diag.device)
        self._n_buckets = len(ifc_buckets)
        for i, (rows, blk_ids, blk_w) in enumerate(ifc_buckets):
            self.register_buffer(f"bucket{i}_rows", rows)
            self.register_buffer(f"bucket{i}_ids", blk_ids)
            self.register_buffer(f"bucket{i}_w", blk_w)
        self.level_meta = tuple(level_meta)
        self._level_slices = tuple(
            slice(start, start + int(np.prod(gshape))) for _, gshape, start in self.level_meta
        )
        self.grid_meta = tuple(grid_meta)
        self.symmetric = symmetric
        self.transpose_op = transpose_op

    @property
    def grid_w(self) -> Tuple[torch.Tensor, ...]:
        return self.fused.grid_w

    @property
    def ifc_buckets(self):
        return tuple(
            (getattr(self, f"bucket{i}_rows"), getattr(self, f"bucket{i}_ids"),
             getattr(self, f"bucket{i}_w"))
            for i in range(self._n_buckets)
        )

    @property
    def shape(self):
        p = self.diag.shape[0]
        return (p, p)

    @property
    def dtype(self):
        return self.diag.dtype

    def _compose(self, x: torch.Tensor) -> torch.Tensor:
        """A x for a flat (M,) vector or an (M, b) block."""
        x = x.contiguous()
        block = x.ndim == 2
        y = torch.empty_like(x)
        for sl, op in zip(self._level_slices, self.level_ops):
            keep = self.keep[sl, None] if block else self.keep[sl]
            # The mask zeroes interface rows (replaced below) and dead slots
            # (annihilated).
            y[sl] = (op.matmat(x[sl]) if block else op.matvec(x[sl])) * keep
        diag = self.diag[:, None] if block else self.diag
        # Interface rows' stencil output is masked to exactly zero above, so
        # adding the interface contribution equals writing it in place.
        y = apply_fused_interface(self.fused, x, y) + diag * x
        return ell_tail(x, self.ifc_buckets, y) if self._n_buckets else y

    def matvec(self, x):
        return self._compose(x)

    def matmat(self, X):
        """Y = A X for an (M, b) block: one stencil SpMM launch per level
        and one interface launch for all b columns."""
        return self._compose(X)

    def rmatvec(self, x):
        if self.symmetric:
            return self.matvec(x)
        if self.transpose_op is not None:
            return self.transpose_op.matvec(x)
        raise NotImplementedError(
            "CompositeV2.rmatvec needs symmetric=True or a transpose "
            "operator (build_composite_v2(..., build_transpose=True))"
        )

    def transpose(self) -> "CompositeV2":
        """A^T in the same v2 format (same region layout/idx_map)."""
        if self.symmetric:
            return self
        if self.transpose_op is not None:
            return self.transpose_op
        raise NotImplementedError(
            "transpose not materialized: pass build_transpose=True to "
            "build_composite_v2"
        )


# ---------------------------------------------------------------------------
# Builder


def build_composite_v2(
    lat,
    nbrs: np.ndarray,
    rels: np.ndarray,
    weights: np.ndarray,
    diag: np.ndarray,
    scale: float,
    dtype=torch.float32,
    interior_weights=None,
    symmetric: bool = False,
    min_grid_rows: int = 16,
    build_transpose: bool = False,
    extra_interface: Optional[np.ndarray] = None,
    device=DEFAULT_DEVICE,
) -> Tuple[CompositeV2, np.ndarray]:
    """Build the v2 composite operator from assembled rows (inputs in
    lattice point order, off-diagonal values ``scale * weights``, ``diag``
    ready-made), on ``device``.

    Returns (op, idx_map): ``idx_map`` (P,) gives each lattice point's slot
    in the operator's region-native vector — scatter with
    ``v_op = zeros(op.shape[0]); v_op[idx_map] = v_lat`` and gather with
    ``v_lat = v_op[idx_map]``.

    ``interior_weights``: optional ``a -> (26,)`` shared aligned-stencil
    weights (product order over (dx, dy, dz), centre excluded, offsets scaled
    by ``a``).  ``symmetric=True`` asserts H == H^T so rmatvec can alias
    matvec.  ``build_transpose=True`` (non-symmetric operators) materializes
    A^T as a second CompositeV2 from the transposed rows; that build widens
    the interface set by one in-edge ring (an interior-classified row of A^T
    may receive an in-edge from an interface row of A).
    ``extra_interface``: optional (P,) bool mask forcing rows onto the
    interface path (used internally by the transpose build).
    """
    dtype = as_torch_dtype(dtype)
    from ..models.irrlap import laplacian_weights
    from ..models.lattice import _local_max_spacing

    if lat.ndim != 3:
        raise ValueError("composite operator requires a 3D lattice")
    p = lat.num_points
    n = lat.n_fine
    bd = lat.box_depth
    npb = lat.n_per_box
    spac = np.asarray(lat.spacings, dtype=np.int64)
    spac_of_point = spac[lat.box_of_point]

    uniq_a = [int(a) for a in np.unique(spac)]
    level_of_a = {a: i for i, a in enumerate(uniq_a)}

    # ---- per-level regions and the lattice -> region-slot index map.
    level_meta = []
    level_org = []  # (3,) absolute level-unit origin of each region (z, y, x)
    start = 0
    for a in uniq_a:
        m = npb // a
        boxes = np.nonzero(spac == a)[0]
        bc = np.stack(
            [(boxes // bd**k) % bd for k in range(3)], axis=1
        )  # (nbox, 3) columns (bx, by, bz)
        occ = np.zeros((bd, bd, bd), dtype=bool)
        occ[bc[:, 2], bc[:, 1], bc[:, 0]] = True
        # Region: full axis when the level's boxes span it (periodic wrap
        # through the domain boundary must land inside the region); else the
        # bounding box.
        org = np.zeros(3, dtype=np.int64)  # (z, y, x) level units
        ext = np.zeros(3, dtype=np.int64)
        for ax in range(3):  # axis 0 = z in occ
            proj = occ.any(axis=tuple(i for i in range(3) if i != ax))
            bmin = int(np.argmax(proj))
            bmax = bd - 1 - int(np.argmax(proj[::-1]))
            if bmin == 0 and bmax == bd - 1:
                org[ax], ext[ax] = 0, bd * m
            else:
                org[ax], ext[ax] = bmin * m, (bmax - bmin + 1) * m
        level_meta.append((a, tuple(int(v) for v in ext), start))
        level_org.append(org)
        start += int(np.prod(ext))
    m_op = start

    # lattice point -> operator slot
    idx_map = np.empty(p, dtype=np.int64)
    for li, ((a, ext, st), org) in enumerate(zip(level_meta, level_org)):
        sel = np.nonzero(spac_of_point == a)[0]
        lc = lat.coords[sel] // a  # columns (x, y, z)
        gz = lc[:, 2] - org[0]
        gy = lc[:, 1] - org[1]
        gx = lc[:, 0] - org[2]
        # Cheap host-side bounds check on ALL axes (ADVICE r3: a
        # wrap-spanning bounding box would otherwise scatter silently).
        assert (gz >= 0).all() and (gz < ext[0]).all()
        assert (gy >= 0).all() and (gy < ext[1]).all()
        assert (gx >= 0).all() and (gx < ext[2]).all()
        idx_map[sel] = st + (gz * ext[1] + gy) * ext[2] + gx

    # ---- per-level interior stencil operators (27-pt, centre weight 0).
    offs26 = np.array(
        [v for v in itertools.product((-1, 0, 1), repeat=3) if any(v)],
        dtype=np.int64,
    )  # product order over (dx, dy, dz)
    offs27_zyx = tuple(
        (dz, dy, dx) for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3)
    )
    level_ops = []
    for a, gshape, st in level_meta:
        if interior_weights is not None:
            w26 = np.asarray(interior_weights(int(a)), dtype=np.float64)
        else:
            w26 = laplacian_weights((offs26 * a).astype(np.float64))
        w_of = {tuple(o): scale * w for o, w in zip(map(tuple, offs26), w26)}
        w27 = np.array(
            [w_of.get((dx, dy, dz), 0.0) for dz, dy, dx in offs27_zyx]
        )
        counts = np.array([sum(o != 0 for o in off) for off in offs27_zyx])
        graded = None
        lad = []
        for c in range(4):
            wc = w27[counts == c]
            if len(wc) and np.ptp(wc) == 0.0:
                lad.append(float(wc[0]))
            else:
                lad = None
                break
        if lad is not None:
            graded = tuple(lad)
        level_ops.append(
            StencilOperator(
                weights=torch.as_tensor(w27, dtype=dtype, device=device),
                diag=None,
                grid_shape=gshape,
                offsets=offs27_zyx,
                graded=graded,
            )
        )

    # ---- interface rows and their signature classes.
    _, _, differs = _local_max_spacing(lat, np.arange(p), 1)
    deg = (nbrs >= 0).sum(axis=1)
    interface = differs | (deg != 26)
    if extra_interface is not None:
        interface = interface | np.asarray(extra_interface, bool)
    rows_l = np.nonzero(interface)[0]

    grid_meta = []
    grid_w = []
    fallback = []  # lattice row ids

    if len(rows_l):
        # Signature: (own spacing, sorted displacement set, weights, per-tap
        # SOURCE level).  Including the source level splits geometric classes
        # whose taps straddle levels differently by position (e.g. the
        # corner taps of the shell ringing a fine box) into families whose
        # taps each read exactly one level — the precondition for the
        # conv-slab application.
        sigs = {}
        sub_n = nbrs[rows_l]
        sub_r = rels[rows_l]
        sub_w = weights[rows_l]
        msk = sub_n >= 0
        for i in range(len(rows_l)):
            mi = msk[i]
            r = sub_r[i][mi]
            w = sub_w[i][mi]
            lvl = spac_of_point[sub_n[i][mi]]
            order = np.lexsort((r[:, 0], r[:, 1], r[:, 2]))
            key = (
                int(spac_of_point[rows_l[i]]),
                r[order].astype(np.int32).tobytes(),
                w[order].astype(np.float64).tobytes(),
                lvl[order].astype(np.int32).tobytes(),
            )
            sigs.setdefault(key, []).append(i)

        for (a_row, rbytes, wbytes, lbytes), members in sigs.items():
            members = np.asarray(members)
            taps_rel = np.frombuffer(rbytes, dtype=np.int32).reshape(-1, 3)
            taps_w = np.frombuffer(wbytes, dtype=np.float64)
            taps_lvl = np.frombuffer(lbytes, dtype=np.int32)
            coords = lat.coords[rows_l[members]]
            lr = level_of_a[a_row]
            org_r = level_org[lr]
            gshape_r = level_meta[lr][1]
            for sel, origin, steps, shape in _detect_grids(coords):
                if origin is None or len(sel) < min_grid_rows:
                    fallback.extend(rows_l[members[sel]].tolist())
                    continue
                # Per-tap placement: grid-relative strided slice of the
                # source level's region.
                ok = True
                taps = []
                for t in range(len(taps_rel)):
                    rel = taps_rel[t].astype(np.int64)
                    a_src = int(taps_lvl[t])
                    ls = level_of_a[a_src]
                    start3 = np.zeros(3, dtype=np.int64)
                    stride3 = np.zeros(3, dtype=np.int64)
                    for ax in range(3):  # 0=z -> coords column 2-ax
                        col = 2 - ax
                        lo = int(origin[col] + rel[col])
                        hi = lo + int(shape[col] - 1) * int(steps[col])
                        s = _axis_wrap_start(lo, hi, n)
                        st = int(steps[col]) if shape[col] > 1 else a_src
                        if s is None or s % a_src or st % a_src:
                            ok = False
                            break
                        start3[ax] = s // a_src - level_org[ls][ax]
                        stride3[ax] = st // a_src
                        if start3[ax] < 0 or (
                            start3[ax] + (shape[col] - 1) * stride3[ax]
                            >= level_meta[ls][1][ax]
                        ):
                            ok = False
                            break
                    if not ok:
                        break
                    limit = tuple(
                        int(start3[ax] + (shape[2 - ax] - 1) * stride3[ax] + 1)
                        for ax in range(3)
                    )
                    taps.append(
                        (
                            ls,
                            tuple(int(v) for v in start3),
                            limit,
                            tuple(int(v) for v in stride3),
                        )
                    )
                if not ok:
                    fallback.extend(rows_l[members[sel]].tolist())
                    continue
                acc_shape = tuple(int(shape[2 - ax]) for ax in range(3))
                out_start = []
                interior = []
                for ax in range(3):
                    col = 2 - ax
                    o = int(origin[col]) // a_row - int(org_r[ax])
                    st = (int(steps[col]) // a_row) if shape[col] > 1 else 1
                    out_start.append(o)
                    interior.append(st - 1)
                    assert 0 <= o and o + (shape[col] - 1) * st < gshape_r[ax]
                grid_meta.append(
                    (
                        lr,
                        tuple(out_start),
                        tuple(interior),
                        acc_shape,
                        tuple(taps),
                    )
                )
                grid_w.append(torch.as_tensor(scale * taps_w, dtype=dtype, device=device))

    # ---- masks and diagonal in region layout.
    dt_np = as_numpy_dtype(dtype)
    live = np.zeros(m_op, dtype=dt_np)
    live[idx_map] = 1.0
    keep = np.zeros(m_op, dtype=dt_np)
    keep[idx_map] = 1.0
    if len(rows_l):
        keep[idx_map[rows_l]] = 0.0
    diag_op = np.zeros(m_op, dtype=dt_np)
    diag_op[idx_map] = diag

    # ---- ELL fallback buckets (region-slot indexing, no diagonal, add).
    if fallback:
        fb = np.asarray(sorted(fallback), dtype=np.int64)
        k_fb = int(deg[fb].max())
        r = len(fb)
        cols = np.tile(idx_map[fb][:, None], (1, k_fb))
        vals = np.zeros((r, k_fb), dtype=np.float64)
        emask = np.zeros((r, k_fb), dtype=bool)
        sn = nbrs[fb]
        sw = weights[fb]
        mask = sn >= 0
        rr, cc = np.nonzero(mask)
        pos = np.concatenate([[0], np.cumsum(mask.sum(axis=1))])
        within = np.arange(len(rr)) - pos[rr]
        cols[rr, within] = idx_map[sn[rr, cc]]
        vals[rr, within] = scale * sw[rr, cc]
        emask[rr, within] = True
        buckets = _block_ell_buckets(idx_map[fb], cols, vals, emask, dtype, device)
    else:
        buckets = ()

    op_t = None
    if build_transpose and not symmetric:
        # Interface dilation: any row receiving an in-edge from an interface
        # row of A cannot use the aligned interior stencil in A^T.
        dil = interface.copy()
        in_from_ifc = nbrs[interface]
        dil[in_from_ifc[in_from_ifc >= 0]] = True
        nbrsT, relsT, weightsT = _transpose_rows(nbrs, rels, weights)
        op_t, idx_map_t = build_composite_v2(
            lat, nbrsT, relsT, weightsT, diag, scale, dtype=dtype,
            interior_weights=interior_weights, symmetric=False,
            min_grid_rows=min_grid_rows, build_transpose=False, extra_interface=dil, device=device,
        )
        assert (idx_map_t == idx_map).all()  # same lattice, same layout

    op = CompositeV2(
        diag=torch.as_tensor(diag_op, device=device),
        keep=torch.as_tensor(keep, device=device),
        live=torch.as_tensor(live, device=device),
        level_ops=level_ops,
        grid_w=grid_w,
        ifc_buckets=buckets,
        level_meta=level_meta,
        grid_meta=grid_meta,
        symmetric=symmetric,
        transpose_op=op_t,
    )
    return op, idx_map
