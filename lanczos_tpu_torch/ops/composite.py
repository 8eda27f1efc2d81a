"""Composite multi-level operator (v1) and the block-ELL helpers.

Counterpart of ``lanczos_tpu/ops/composite.py``:

* :class:`CompositeOperator` (``build_composite``): H = diag + one aligned
  27-point stencil per spacing level, applied to each level's dense stack
  of (nbox, m, m, m) box subgrids with halos taken from same-level
  neighbour boxes (``_halo_pad``, ``_stencil27``), plus the exact
  interface rows as bucketed block-ELL gathers.  Vectors are in the
  lattice's level-major point order (``perm``).  The JAX package built it
  to avoid element gathers on the TPU; on the card CompositeV2 with the
  interface kernel serves the irregular solves, and this operator is plain
  PyTorch (no Pallas kernel is reached here in the JAX package either).
* :func:`shard_composite` / :class:`ShardedComposite` /
  :class:`ShardedCompositeOperator`: each level's boxes split contiguously
  over D ranks (ghost-padded to equal counts), device-major vectors; the
  cross-rank halos come from one all-gather of a per-box FACE table per
  level (``_face_pack``, ``_halo_pad_from_faces``), and the interface rows
  from an all-gathered x.
* ``IFC_W``, ``_block_ell`` and ``_block_ell_buckets``: the bucketed
  block-ELL tail that CompositeV2 (``ops/composite2.py``) also uses.

Host numpy for the builds; tensors are placed on the operator's device.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

import numpy as np
import torch
from torch import nn

from .._util import DEFAULT_DEVICE, as_torch_dtype, to_numpy
from .operators import LinearOperator, RowShardedOperator

__all__ = [
    "IFC_W",
    "LevelBlock",
    "CompositeOperator",
    "build_composite",
    "ShardedComposite",
    "ShardedCompositeOperator",
    "shard_composite",
]

#: Width of the aligned x blocks the interface rows gather (``IFC_W`` of
#: the JAX package, kept so that both packages bucket the same rows the
#: same way).
IFC_W = 32

#: The 26 nonzero offsets of {-1,0,1}^3 in itertools.product order, as
#: (dx, dy, dz): component 0 indexes the LAST array axis.
_DIRS = tuple(v for v in itertools.product((-1, 0, 1), repeat=3) if any(v))


class LevelBlock(nn.Module):
    """One spacing level: a dense stack of same-size box subgrids.

    ``adjacency[b, d]`` = index (within this level) of the box in direction
    d (``_DIRS``) of box b, or -1 when that neighbour has a different
    spacing (its halo face is zero-filled; rows that would read it are
    interface rows and get overwritten).  ``weights`` (27,) the aligned
    stencil in product order over (dx, dy, dz), centre included (0).
    """

    def __init__(self, adjacency: torch.Tensor, weights: torch.Tensor, start: int,
                 nbox: int, m: int):
        super().__init__()
        self.register_buffer("adjacency", adjacency.to(torch.int64))
        self.register_buffer("weights", weights)
        self.start, self.nbox, self.m = int(start), int(nbox), int(m)


def _src_dst(d: int, m: int):
    """(source slice in the neighbour box, target slice in the haloed box)
    along one axis: the +1 neighbour's plane 0 lands at m+1, the -1
    neighbour's plane m-1 at 0, no offset copies the interior."""
    if d == 1:
        return slice(0, 1), slice(m + 1, m + 2)
    if d == -1:
        return slice(m - 1, m), slice(0, 1)
    return slice(0, m), slice(1, m + 1)


def _halo_pad(xl: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """(nbox, m, m, m) -> (nbox, m+2, m+2, m+2) with 26-direction halos.

    Each direction's halo is a face/edge/corner slab of the adjacent box
    (sliced, then taken over the box axis), zeroed where adjacency is -1.
    Array axes are (z, y, x) slow->fast; direction tuples are (dx, dy, dz).
    """
    nbox, m = xl.shape[0], xl.shape[1]
    out = xl.new_zeros((nbox, m + 2, m + 2, m + 2))
    out[:, 1:-1, 1:-1, 1:-1] = xl
    for d, (dx, dy, dz) in enumerate(_DIRS):
        nbr = adj[:, d]
        valid = (nbr >= 0).to(xl.dtype)[:, None, None, None]
        sz, tz = _src_dst(dz, m)
        sy, ty = _src_dst(dy, m)
        sx, tx = _src_dst(dx, m)
        out[:, tz, ty, tx] = xl[:, sz, sy, sx][nbr.clamp(min=0)] * valid
    return out


def _stencil27(hal: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Apply the {-1,0,1}^3 stencil to haloed boxes; weights in product
    order over (dx, dy, dz), centre included."""
    m = hal.shape[1] - 2
    y = None
    for k, (dx, dy, dz) in enumerate(itertools.product((-1, 0, 1), repeat=3)):
        term = weights[k] * hal[:, 1 + dz:1 + dz + m, 1 + dy:1 + dy + m, 1 + dx:1 + dx + m]
        y = term if y is None else y + term
    return y


def _x_blocks(x: torch.Tensor) -> torch.Tensor:
    """x padded to a multiple of IFC_W and cut into (-1, IFC_W) blocks."""
    pad = (-x.shape[0]) % IFC_W
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    return xp.reshape(-1, IFC_W)


class CompositeOperator(LinearOperator):
    """H = diag + per-level aligned stencils + exact interface rows.

    Vector ordering is the lattice's level-major point order (see
    :func:`build_composite`); eigenvectors come out in that order.
    Buffers: ``diag`` (P,); ``ifc_rows`` (R,), ``ifc_cols``/``ifc_vals``
    (R, K) the interface rows' padded ELL (diagonal merged, 0 on pad); the
    same rows in bucketed block-ELL form (``ifc_buckets``: per bucket
    rows (Rb,), block ids (Rb, Bb), lane weights (Rb, Bb, IFC_W)).
    """

    def __init__(self, diag, levels, ifc_rows, ifc_cols, ifc_vals, ifc_buckets):
        super().__init__()
        self.register_buffer("diag", diag)
        self.levels = nn.ModuleList(levels)
        self.register_buffer("ifc_rows", ifc_rows.to(torch.int64))
        self.register_buffer("ifc_cols", ifc_cols.to(torch.int64))
        self.register_buffer("ifc_vals", ifc_vals)
        self._n_buckets = len(ifc_buckets)
        for i, (rows, blk_ids, blk_w) in enumerate(ifc_buckets):
            self.register_buffer(f"bucket{i}_rows", rows)
            self.register_buffer(f"bucket{i}_ids", blk_ids)
            self.register_buffer(f"bucket{i}_w", blk_w)

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

    def _interior(self, x):
        """(D + sum_l S_l) x: the diagonal plus every level's stencil
        (block-diagonal by level and symmetric)."""
        y = self.diag * x
        for lv in self.levels:
            n = lv.nbox * lv.m**3
            xl = x[lv.start:lv.start + n].reshape(lv.nbox, lv.m, lv.m, lv.m)
            y[lv.start:lv.start + n] += _stencil27(_halo_pad(xl, lv.adjacency),
                                                   lv.weights).reshape(-1)
        return y

    def matvec(self, x):
        # The composite stencil everywhere, then the interface rows
        # overwritten with their exact rows (diagonal included).
        y = self._interior(x)
        xb = _x_blocks(x)
        for rows, blk_ids, blk_w in self.ifc_buckets:
            y[rows] = torch.einsum("rbw,rbw->r", blk_w, xb[blk_ids])
        return y

    def rmatvec(self, x):
        # H^T x = (D + sum S) M_int x + ELL^T M_ifc x (D, S symmetric); the
        # ELL^T term is the block scatter-add dual of the matvec's gather.
        u = x.clone()
        u[self.ifc_rows] = 0.0
        y = self._interior(u)
        yb = torch.zeros_like(_x_blocks(y))
        for rows, blk_ids, blk_w in self.ifc_buckets:
            yb.index_add_(0, blk_ids.reshape(-1),
                          (blk_w * x[rows][:, None, None]).reshape(-1, IFC_W))
        return y + yb.reshape(-1)[:x.shape[0]]


def build_composite(
    lat,
    nbrs: np.ndarray,
    rels: np.ndarray,
    weights: np.ndarray,
    diag: np.ndarray,
    scale: float,
    dtype=torch.float32,
    interior_weights=None,
    device=DEFAULT_DEVICE,
) -> Tuple[CompositeOperator, np.ndarray]:
    """Build the composite operator from assembled LSQ rows, on ``device``.

    Inputs are in the LATTICE's point order: off-diagonal values are
    ``scale * weights`` and the diagonal vector is passed ready-made.
    Returns (operator, perm), ``perm`` mapping lattice order -> operator
    (level-major) order: operator_vector = lattice_vector[perm].

    ``interior_weights``: optional ``a -> (26,)`` shared aligned-stencil
    weights (offset product order, centre excluded, offsets scaled by the
    level spacing ``a``) that every interior row at spacing ``a`` carries;
    default the LSQ Laplacian weights.  Requires a 3D lattice.  Interface
    rows are those whose neighbour cloud is not the aligned own-spacing
    26-stencil.
    """
    from ..models.irrlap import laplacian_weights
    from ..models.lattice import _local_max_spacing

    dtype = as_torch_dtype(dtype)
    if lat.ndim != 3:
        raise ValueError("composite operator requires a 3D lattice")
    p = lat.num_points
    bd = lat.box_depth
    nb = bd**3
    npb = lat.n_per_box
    spac = np.asarray(lat.spacings, dtype=np.int64)

    # ---- level-major permutation of points (boxes sorted by spacing).
    box_order = np.argsort(spac, kind="stable")
    counts = (npb // spac) ** 3
    starts = np.concatenate([[0], np.cumsum(counts)])  # lattice box offsets
    perm = np.concatenate(
        [np.arange(starts[b], starts[b + 1]) for b in box_order]
    )
    inv = np.empty(p, dtype=np.int64)
    inv[perm] = np.arange(p)

    # ---- which rows are interface rows: not the aligned 26-stencil.
    _, _, differs = _local_max_spacing(lat, np.arange(p), 1)
    deg = (nbrs >= 0).sum(axis=1)
    interface = differs | (deg != 26)

    # ---- per-level blocks, in permuted space.
    levels = []
    new_start = 0
    bcoord = np.stack(
        [(np.arange(nb) // bd**k) % bd for k in range(3)], axis=1
    )  # (nb, 3) component 0 fastest
    dirs = np.asarray(_DIRS, dtype=np.int64)
    offs = np.array(list(itertools.product((-1, 0, 1), repeat=3)), dtype=np.int64)
    nz = np.any(offs != 0, axis=1)
    for a in np.unique(spac):
        boxes = box_order[spac[box_order] == a]
        nbox = len(boxes)
        m = int(npb // a)
        rank = {int(b): i for i, b in enumerate(boxes)}
        adj = np.full((nbox, 26), -1, dtype=np.int64)
        for i, b in enumerate(boxes):
            for d, disp in enumerate(dirs):
                nc = (bcoord[b] + disp) % bd
                nbid = int(nc @ (bd ** np.arange(3)))
                if spac[nbid] == a:
                    adj[i, d] = rank[nbid]
        # Aligned stencil weights at this spacing: offsets (dx,dy,dz)*a in
        # product order, centre included as a 0 placeholder (the diagonal
        # is ``diag``).
        if interior_weights is not None:
            w26 = np.asarray(interior_weights(int(a)), dtype=np.float64)
        else:
            w26 = laplacian_weights((offs[nz] * a).astype(np.float64))
        w27 = np.zeros(27)
        w27[nz] = scale * w26
        levels.append(LevelBlock(
            torch.as_tensor(adj, device=device),
            torch.as_tensor(w27, dtype=dtype, device=device),
            start=new_start, nbox=nbox, m=m,
        ))
        new_start += nbox * m**3
    assert new_start == p

    # ---- interface rows in permuted space, padded ELL with diagonal merged.
    rows_l = np.nonzero(interface)[0]
    if len(rows_l):
        k_if = int(deg[rows_l].max()) + 1  # +1 for the diagonal column
        r = len(rows_l)
        cols = np.tile(inv[rows_l][:, None], (1, k_if))
        vals = np.zeros((r, k_if), dtype=np.float64)
        emask = np.zeros((r, k_if), dtype=bool)
        emask[:, 0] = True
        vals[:, 0] = diag[rows_l]
        sub_n = nbrs[rows_l]
        sub_w = weights[rows_l]
        mask = sub_n >= 0
        rr, cc = np.nonzero(mask)
        pos = np.concatenate([[0], np.cumsum(mask.sum(axis=1))])
        within = np.arange(len(rr)) - pos[rr]
        cols[rr, 1 + within] = inv[sub_n[rr, cc]]
        vals[rr, 1 + within] = scale * sub_w[rr, cc]
        emask[rr, 1 + within] = True
        ifc_rows = inv[rows_l]
        buckets = _block_ell_buckets(ifc_rows, cols, vals, emask, dtype, device)
    else:
        ifc_rows = np.zeros(0, dtype=np.int64)
        cols = np.zeros((0, 1), dtype=np.int64)
        vals = np.zeros((0, 1), dtype=np.float64)
        buckets = ()

    op = CompositeOperator(
        diag=torch.as_tensor(diag[perm], dtype=dtype, device=device),
        levels=levels,
        ifc_rows=torch.as_tensor(ifc_rows, device=device),
        ifc_cols=torch.as_tensor(cols, device=device),
        ifc_vals=torch.as_tensor(vals, dtype=dtype, device=device),
        ifc_buckets=buckets,
    )
    return op, perm


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


# ---------------------------------------------------------------------------
# Sharded composite: each level's box stack split contiguously over the D
# ranks (ghost-padded so every rank holds c_l = ceil(nbox_l / D) boxes per
# level); the global vector is device-major, rank d owning one contiguous
# (P_loc,) slice with its boxes of every level.  Cross-rank halos ride ONE
# all-gather of a per-box FACE TABLE per level: each box publishes its 6
# face planes, and every face/edge/corner halo slab a neighbour needs is a
# slice of one published face.  Interface rows are applied by their owning
# rank through block-ELL gathers against an all-gathered x.

_FACE_SPECS = (
    # (axis of xl sliced, index) for faces 0..5: x-min, x-max, y-min,
    # y-max, z-min, z-max.  xl axes are (box, z, y, x).
    (3, 0),
    (3, -1),
    (2, 0),
    (2, -1),
    (1, 0),
    (1, -1),
)


def _face_pack(xl: torch.Tensor) -> torch.Tensor:
    """(nbox, m, m, m) -> (nbox, 6, m, m): the 6 face planes of every box."""
    return torch.stack([xl.select(ax, idx % xl.shape[ax]) for ax, idx in _FACE_SPECS], dim=1)


def _halo_pad_from_faces(xl: torch.Tensor, adj: torch.Tensor,
                         faces_g: torch.Tensor) -> torch.Tensor:
    """(c, m, m, m) -> (c, m+2, m+2, m+2) with halos from a global face table.

    ``adj[b, d]``: LEVEL-GLOBAL rank of box b's neighbour in direction d
    (-1 when the neighbour has a different spacing).  ``faces_g``:
    (nbox_pad, 6, m, m) all-gathered face table in global box order.
    """
    c, m = xl.shape[0], xl.shape[1]
    out = xl.new_zeros((c, m + 2, m + 2, m + 2))
    out[:, 1:-1, 1:-1, 1:-1] = xl

    def tgt(d):
        return _src_dst(d, m)[1]

    def src(d):
        # the neighbour's plane nearest to me: +1 dir -> its min plane
        return _src_dst(d, m)[0]

    for d, (dx, dy, dz) in enumerate(_DIRS):
        nbr = adj[:, d]
        valid = (nbr >= 0).to(xl.dtype)[:, None, None, None]
        safe = nbr.clamp(min=0)
        if dx != 0:
            face = faces_g[:, 0 if dx == 1 else 1][safe]  # (c, z, y)
            slab = face[:, src(dz), :][:, :, src(dy)][:, :, :, None]
        elif dy != 0:
            face = faces_g[:, 2 if dy == 1 else 3][safe]  # (c, z, x)
            slab = face[:, src(dz), :][:, :, None, :]
        else:
            face = faces_g[:, 4 if dz == 1 else 5][safe]  # (c, y, x)
            slab = face[:, None, :, :]
        out[:, tgt(dz), tgt(dy), tgt(dx)] = slab * valid
    return out


@dataclasses.dataclass(frozen=True)
class ShardedComposite:
    """Host-side container of the device-major sharded composite, every
    rank's arrays (numpy), FLAT over ranks (first dim D * <local>).

    ``P_loc`` is the per-rank vector length; the global sharded vector is
    (D * P_loc,).  ``to_sharded``/``from_sharded`` map level-major
    composite vectors into/out of the sharded layout; :meth:`as_operator`
    gives one rank's operator.
    """

    num_devices: int
    P_loc: int
    level_meta: Tuple[Tuple[int, int, int], ...]  # (c_local_boxes, m, start_local)
    level_adj: Tuple[np.ndarray, ...]  # each (D*c_l, 26), level-global ids
    level_weights: Tuple[torch.Tensor, ...]  # each (27,)
    diag: np.ndarray  # (D*P_loc,)
    keep: np.ndarray  # (D*P_loc,) 1 except interface rows & ghost slots
    ifc_rows: np.ndarray  # (D*R,) LOCAL row ids (0 for padding)
    ifc_blk_ids: np.ndarray  # (D*R, B) into the padded global block table
    ifc_blk_w: np.ndarray  # (D*R, B, IFC_W)
    idx_map: np.ndarray  # level-major index -> sharded global index
    dtype: torch.dtype

    @property
    def shape(self):
        p = self.diag.shape[0]
        return (p, p)

    def to_sharded(self, x_levelmajor: np.ndarray) -> np.ndarray:
        out = np.zeros(self.num_devices * self.P_loc, np.asarray(x_levelmajor).dtype)
        out[self.idx_map] = x_levelmajor
        return out

    def from_sharded(self, x_sharded: np.ndarray) -> np.ndarray:
        return np.asarray(x_sharded)[self.idx_map]

    def live_mask(self) -> np.ndarray:
        """1.0 on live slots, 0.0 on ghost padding (mask start vectors with
        this: ghost components would otherwise ride along in the basis as
        spurious null-space directions)."""
        live = np.zeros(self.num_devices * self.P_loc, dtype=np.float64)
        live[self.idx_map] = 1.0
        return live

    def as_operator(self, mesh) -> "ShardedCompositeOperator":
        if mesh.size != self.num_devices:
            raise ValueError(f"sharded for {self.num_devices} ranks, the mesh has {mesh.size}")
        return ShardedCompositeOperator(self, mesh)


def shard_composite(comp: CompositeOperator, num_devices: int) -> ShardedComposite:
    """Re-partition a CompositeOperator for ``num_devices`` ranks (host
    numpy).  Boxes of each level are split contiguously over ranks
    (ghost-padded to equal counts); the layout is device-major (see
    ShardedComposite).  Numerically identical to ``comp`` on live slots.
    """
    D = num_devices
    levels = comp.levels
    p = comp.diag.shape[0]

    cs = [int(np.ceil(lv.nbox / D)) for lv in levels]
    p_loc = int(sum(c * lv.m**3 for c, lv in zip(cs, levels)))
    start_loc = np.concatenate(
        [[0], np.cumsum([c * lv.m**3 for c, lv in zip(cs, levels)])]
    ).astype(np.int64)

    # level-major -> sharded index map
    idx_map = np.empty(p, dtype=np.int64)
    for lv, c, sl in zip(levels, cs, start_loc[:-1]):
        n = lv.nbox * lv.m**3
        i = np.arange(n, dtype=np.int64)
        b = i // lv.m**3
        o = i % lv.m**3
        d = b // c
        r = b % c
        idx_map[lv.start + i] = d * p_loc + sl + r * lv.m**3 + o

    diag = to_numpy(comp.diag)
    dt = diag.dtype
    diag_s = np.zeros(D * p_loc, dtype=dt)
    diag_s[idx_map] = diag
    keep_s = np.zeros(D * p_loc, dtype=dt)
    keep_s[idx_map] = 1.0
    ifc_rows_lm = to_numpy(comp.ifc_rows).astype(np.int64)
    if len(ifc_rows_lm):
        keep_s[idx_map[ifc_rows_lm]] = 0.0

    # per-level adjacency, ghost-padded to (D*c, 26); ids stay level-global
    level_adj = []
    for lv, c in zip(levels, cs):
        adj = np.full((D * c, 26), -1, dtype=np.int64)
        adj[: lv.nbox] = to_numpy(lv.adjacency)
        level_adj.append(adj)

    # interface rows: map ids, group by owning rank, single padded bucket
    if len(ifc_rows_lm):
        rows_s = idx_map[ifc_rows_lm]
        cols_s = idx_map[to_numpy(comp.ifc_cols).astype(np.int64)]
        vals = to_numpy(comp.ifc_vals).astype(np.float64)
        emask = np.zeros_like(vals, dtype=bool)
        emask[:, 0] = True  # diagonal column always real
        emask[:, 1:] = vals[:, 1:] != 0
        blk_ids_all, blk_w_all, nblk = _block_ell(cols_s, vals, emask)
        owner = rows_s // p_loc
        local_row = rows_s % p_loc
        rmax = max(int(np.bincount(owner, minlength=D).max()), 1)
        bmax = blk_ids_all.shape[1]
        rows_out = np.zeros((D, rmax), dtype=np.int64)
        blk_out = np.zeros((D, rmax, bmax), dtype=np.int64)
        w_out = np.zeros((D, rmax, bmax, IFC_W), dtype=np.float64)
        for d in range(D):
            sel = np.nonzero(owner == d)[0]
            rows_out[d, : len(sel)] = local_row[sel]
            blk_out[d, : len(sel)] = blk_ids_all[sel]
            w_out[d, : len(sel)] = blk_w_all[sel]
        ifc_rows = rows_out.reshape(-1)
        ifc_blk_ids = blk_out.reshape(D * rmax, bmax)
        ifc_blk_w = w_out.reshape(D * rmax, bmax, IFC_W).astype(dt)
    else:
        ifc_rows = np.zeros(D, dtype=np.int64)
        ifc_blk_ids = np.zeros((D, 1), dtype=np.int64)
        ifc_blk_w = np.zeros((D, 1, IFC_W), dtype=dt)

    return ShardedComposite(
        num_devices=D,
        P_loc=p_loc,
        level_meta=tuple(
            (c, lv.m, int(sl)) for c, lv, sl in zip(cs, levels, start_loc[:-1])
        ),
        level_adj=tuple(level_adj),
        level_weights=tuple(lv.weights.detach().cpu() for lv in levels),
        diag=diag_s,
        keep=keep_s,
        ifc_rows=ifc_rows,
        ifc_blk_ids=ifc_blk_ids,
        ifc_blk_w=ifc_blk_w,
        idx_map=idx_map,
        dtype=comp.dtype,
    )


class ShardedCompositeOperator(RowShardedOperator):
    """One rank's part of a ShardedComposite: ``matvec`` on this rank's
    (P_loc,) rows of a device-major vector; ``host`` is the
    ShardedComposite (layout maps)."""

    def __init__(self, sc: ShardedComposite, mesh):
        super().__init__(mesh, sc.shape[0], sc.P_loc)
        dev = mesh.device
        self.host = sc
        self.level_meta = sc.level_meta

        def mine(a, per_rank):
            return torch.as_tensor(a[mesh.rank * per_rank:(mesh.rank + 1) * per_rank], device=dev)

        self.register_buffer("diag", mine(sc.diag, sc.P_loc))
        self.register_buffer("keep", mine(sc.keep, sc.P_loc))
        self.register_buffer("live", mine(sc.live_mask().astype(sc.diag.dtype), sc.P_loc))
        rmax = sc.ifc_rows.shape[0] // sc.num_devices
        self.register_buffer("ifc_rows", mine(sc.ifc_rows, rmax))
        self.register_buffer("ifc_blk_ids", mine(sc.ifc_blk_ids, rmax))
        self.register_buffer("ifc_blk_w", mine(sc.ifc_blk_w, rmax))
        for i, ((c, m, sl), adj, w) in enumerate(zip(sc.level_meta, sc.level_adj,
                                                    sc.level_weights)):
            self.register_buffer(f"level{i}_adj", mine(adj, c))
            self.register_buffer(f"level{i}_w", w.to(dev))

    @property
    def dtype(self):
        return self.diag.dtype

    def matvec(self, x):
        y = self.diag * x
        for i, (c, m, sl) in enumerate(self.level_meta):
            n = c * m**3
            xl = x[sl:sl + n].reshape(c, m, m, m)
            faces_g = self.mesh.all_gather(_face_pack(xl))
            hal = _halo_pad_from_faces(xl, getattr(self, f"level{i}_adj"), faces_g)
            y[sl:sl + n] += _stencil27(hal, getattr(self, f"level{i}_w")).reshape(-1)
        y = y * self.keep
        xb = _x_blocks(self.mesh.all_gather(x))
        contrib = torch.einsum("rbw,rbw->r", self.ifc_blk_w, xb[self.ifc_blk_ids])
        return y.index_add_(0, self.ifc_rows, contrib)
