"""Row-sharded CompositeV2: z-slab level regions + surface-run exchange.

Counterpart of ``lanczos_tpu/parallel/composite2.py``, the multi-rank form
of the north-star operator (``ops/composite2.py``).  Only surface-sized
data crosses ranks per matvec:

* BULK (each level's interior stencil, most rows): each level's region is
  cut into z-slabs, one per rank, and applied by the sharded stencil's
  local matvec (``parallel/distributed.py:ShardedStencilOperator``: the
  CUDA SpMV on the slab plus the two-plane halo correction).  One
  ``halo_exchange`` carries every level's two boundary planes.
* INTERFACE (the strided classes and the block-ELL tail, the box-surface
  rows): every tap of every class reads a slab that is thin along at
  least one axis.  At build time :func:`_plan_support` (the JAX package's,
  verbatim) covers every tap slice and ELL column with a few axis-aligned
  SURFACE RUNS per level, full extent in two axes and a few units wide in
  the third.  Per matvec each rank sends its part of the x- and y-thin runs
  (and of the levels that degenerate to a whole-level gather) in ONE
  all-gather, and its owned planes of the z-runs, zero elsewhere, in ONE
  all-reduce; it rebuilds a support-correct full region, applies the
  port's interface kernel (``ops/interface_kernel.py``, CUDA on a card)
  and the ELL tail to it, and keeps its own z-portion of the result.

The interface compute is replicated on every rank, as in the JAX package:
the classes are face-sized, so splitting them would save little and need
per-tap point-to-point schedules.

Layout: device-major.  Rank d owns, for every level, z-planes
[d*nz_l/D, (d+1)*nz_l/D) of the level's region; its local vector is the
concatenation of those slabs (level order, raster within).
``host.idx_map`` maps level-major region slots (the single-device
CompositeV2 layout) to sharded slots; every level's z-extent must divide
by D.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .._util import to_numpy
from ..ops.composite import IFC_W
from ..ops.composite2 import CompositeV2, ell_tail
from ..ops.interface_kernel import FusedInterface, apply_fused_interface
from ..ops.operators import RowShardedOperator
from .distributed import ShardedStencilOperator
from .mesh import RowMesh

__all__ = ["ShardedCompositeV2", "ShardedCompositeV2Host", "plan_composite_v2",
           "shard_composite_v2"]


def _merge_intervals(iv, ext, gap=2):
    """Merge [lo, hi) intervals, closing gaps <= ``gap`` (fewer, slightly
    wider runs beat many narrow ones: each run is one collective in the
    JAX package, and one more slice here)."""
    iv = sorted((max(0, lo), min(ext, hi)) for lo, hi in iv if hi > lo)
    out = []
    for lo, hi in iv:
        if out and lo <= out[-1][1] + gap:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def _plan_support(comp: CompositeV2, degenerate_frac: float = 0.6):
    """Static per-level surface runs covering every interface read.

    Returns (runs, stats): ``runs[l]`` is a tuple of (axis, lo, hi) — full
    extent along the other two axes — such that every grid-class tap slice
    and every ELL-tail column of level ``l`` lies inside at least one run.
    A level whose run volume would exceed 60% of its region degenerates to
    one full z-run (plain all-gather) — correct, just not surface-thin.
    """
    level_meta = comp.level_meta
    nlev = len(level_meta)
    m = int(comp.diag.shape[0])
    iv = [[[] for _ in range(3)] for _ in range(nlev)]

    # Grid-class taps: cover along the tap's thinnest axis (ties prefer
    # x, then y — all_gather runs — over z, which needs the psum path).
    for (row_level, out_start, interior, acc_shape, taps) in comp.grid_meta:
        for (ls, start, limit, stride) in taps:
            extents = [limit[ax] - start[ax] for ax in range(3)]
            best = min(extents)
            for cand in (2, 1, 0):
                if extents[cand] == best:
                    ax = cand
                    break
            iv[ls][ax].append((start[ax], limit[ax]))

    # ELL-tail columns: every slot of every referenced block must be
    # covered.  Cover the stragglers along the axis with the fewest
    # distinct uncovered coordinate values.
    starts = np.array([st for (a, ext, st) in level_meta] + [m])
    exts = [ext for (a, ext, st) in level_meta]
    blocks = [to_numpy(b[1]).ravel() for b in comp.ifc_buckets]
    if blocks:
        blk = np.unique(np.concatenate(blocks))
        slots = (blk[:, None] * IFC_W + np.arange(IFC_W)).ravel()
        slots = slots[slots < m]
        li_of = np.searchsorted(starts, slots, side="right") - 1
        for li in range(nlev):
            pts = slots[li_of == li] - level_meta[li][2]
            if not len(pts):
                continue
            ext = exts[li]
            plane = ext[1] * ext[2]
            c = np.stack([pts // plane, (pts % plane) // ext[2],
                          pts % ext[2]])  # (3, n) coords z, y, x
            cov = np.zeros(len(pts), dtype=bool)
            for ax in range(3):
                for lo, hi in iv[li][ax]:
                    cov |= (c[ax] >= lo) & (c[ax] < hi)
            if (~cov).any():
                un = ~cov
                counts = [len(np.unique(c[ax][un])) for ax in range(3)]
                best = min(counts)
                for cand in (2, 1, 0):
                    if counts[cand] == best:
                        ax = cand
                        break
                for v in np.unique(c[ax][un]):
                    iv[li][ax].append((int(v), int(v) + 1))

    runs = []
    stats = {"run_volume": 0, "total_volume": 0}
    for li in range(nlev):
        ext = exts[li]
        vol = int(np.prod(ext))
        lv_runs = []
        rv = 0
        for ax in range(3):
            for lo, hi in _merge_intervals(iv[li][ax], ext[ax]):
                lv_runs.append((ax, lo, hi))
                rv += (hi - lo) * vol // ext[ax]
        if rv > degenerate_frac * vol:
            lv_runs = [(0, 0, ext[0])]  # degenerate: full-level all-gather
            rv = vol
        runs.append(tuple(lv_runs))
        stats["run_volume"] += rv
        stats["total_volume"] += vol
    return tuple(runs), stats


@dataclasses.dataclass(frozen=True)
class ShardedCompositeV2Host:
    """Host-side plan of the sharded layout, the same on every rank.

    ``level_meta[l] = (a, ext (3), st_levelmajor, sl_local, nz_loc)``;
    ``support_runs`` from :func:`_plan_support`."""

    num_devices: int
    P_loc: int
    idx_map: np.ndarray  # level-major region slot -> sharded slot
    live_levelmajor: np.ndarray
    level_meta: Tuple
    support_runs: Tuple
    dtype: torch.dtype

    @property
    def shape(self):
        m = self.num_devices * self.P_loc
        return (m, m)

    def to_sharded(self, x_levelmajor: np.ndarray) -> np.ndarray:
        out = np.zeros(self.num_devices * self.P_loc, np.asarray(x_levelmajor).dtype)
        out[self.idx_map] = x_levelmajor
        return out

    def from_sharded(self, x_sharded: np.ndarray) -> np.ndarray:
        return np.asarray(x_sharded)[self.idx_map]

    def live_mask(self) -> np.ndarray:
        """1.0 on slots holding a lattice point, 0.0 on dead region slots
        (mask start vectors with this — dead lambda=0 modes must never
        enter the Krylov basis)."""
        out = np.zeros(self.num_devices * self.P_loc, dtype=np.float64)
        out[self.idx_map] = self.live_levelmajor
        return out

    def exchange_elements(self) -> dict:
        """Per-rank exchanged element counts per matvec: the halo planes of
        the level stencils plus the support runs (the JAX package's
        surface-proportionality count, number for number)."""
        halo = sum(2 * ext[1] * ext[2] for (a, ext, st, sl, nzl) in self.level_meta)
        runs = 0
        for (a, ext, st, sl, nzl), lv_runs in zip(self.level_meta, self.support_runs):
            vol = ext[0] * ext[1] * ext[2]
            for ax, lo, hi in lv_runs:
                runs += (hi - lo) * vol // ext[ax]
        return {"halo": halo, "support_runs": runs, "total": halo + runs,
                "operator_dim": self.shape[0]}


def plan_composite_v2(comp: CompositeV2, num_devices: int,
                      degenerate_frac: float = 0.6) -> ShardedCompositeV2Host:
    """The host plan of ``comp`` split over ``num_devices`` ranks: the
    device-major layout and the surface runs.  Host numpy only, so the
    exchange volume of any D can be counted without a process group."""
    D = num_devices
    m = int(comp.diag.shape[0])
    level_meta = []
    sl = 0
    for (a, ext, st) in comp.level_meta:
        if ext[0] % D:
            raise ValueError(
                f"level a={a} z-extent {ext[0]} does not divide across "
                f"{D} devices (choose n_fine a multiple of "
                f"{D}*box_depth*max_spacing)"
            )
        nzl = ext[0] // D
        level_meta.append((a, tuple(ext), st, sl, nzl))
        sl += nzl * ext[1] * ext[2]
    P_loc = sl
    assert P_loc * D == m

    idx_map = np.empty(m, dtype=np.int64)
    for (a, ext, st, sl, nzl) in level_meta:
        vol = int(np.prod(ext))
        plane = ext[1] * ext[2]
        i = np.arange(vol, dtype=np.int64)
        z = i // plane
        d = z // nzl
        idx_map[st + i] = d * P_loc + sl + (z - d * nzl) * plane + i % plane

    support_runs, _ = _plan_support(comp, degenerate_frac)
    return ShardedCompositeV2Host(
        num_devices=D, P_loc=P_loc, idx_map=idx_map,
        live_levelmajor=to_numpy(comp.live).astype(np.float64),
        level_meta=tuple(level_meta), support_runs=support_runs, dtype=comp.dtype,
    )


class ShardedCompositeV2(RowShardedOperator):
    """This rank's part of a CompositeV2 split into z-slabs (see the module
    docstring).  ``matvec`` takes and returns this rank's P_loc rows of a
    device-major vector; ``host`` translates layouts.

    Buffers: ``diag``, ``keep``, ``live`` (P_loc,) this rank's rows;
    ``levels`` the levels' ShardedStencilOperators (no diagonal); ``fused``
    and the ELL tail buckets the whole operator's, replicated."""

    def __init__(self, comp: CompositeV2, mesh: RowMesh, host: ShardedCompositeV2Host):
        super().__init__(mesh, host.shape[0], host.P_loc)
        dev = mesh.device
        self.host = host
        self.symmetric = comp.symmetric
        self.level_meta = host.level_meta
        self.support_runs = host.support_runs

        def local(levelmajor):
            full = np.zeros(host.shape[0], to_numpy(levelmajor).dtype)
            full[host.idx_map] = to_numpy(levelmajor)
            return torch.as_tensor(full[self.row_offset:self.row_offset + host.P_loc], device=dev)

        self.register_buffer("diag", local(comp.diag))
        self.register_buffer("keep", local(comp.keep))
        self.register_buffer("live", local(comp.live))
        self.levels = torch.nn.ModuleList(ShardedStencilOperator(op, mesh) for op in comp.level_ops)
        if comp.fused.tap_w.device == dev:
            self.fused = comp.fused
        else:
            self.fused = FusedInterface(comp.grid_meta, comp.level_meta,
                                        [w.to(dev) for w in comp.grid_w], comp.dtype, dev)
        self._n_buckets = len(comp.ifc_buckets)
        for i, (rows, blk_ids, blk_w) in enumerate(comp.ifc_buckets):
            self.register_buffer(f"bucket{i}_rows", rows.to(dev))
            self.register_buffer(f"bucket{i}_ids", blk_ids.to(dev))
            self.register_buffer(f"bucket{i}_w", blk_w.to(dev))

    @property
    def dtype(self):
        return self.diag.dtype

    @property
    def ifc_buckets(self):
        return tuple(
            (getattr(self, f"bucket{i}_rows"), getattr(self, f"bucket{i}_ids"),
             getattr(self, f"bucket{i}_w"))
            for i in range(self._n_buckets)
        )

    def exchange_elements(self) -> dict:
        return self.host.exchange_elements()

    def _support(self, parts):
        """The full level-major regions (M,), correct on every support run
        and zero elsewhere, from every rank's level slabs ``parts``."""
        mesh, r = self.mesh, self.mesh.rank
        xs = torch.zeros(self.shape[0], dtype=parts[0].dtype, device=parts[0].device)
        gather, g_at, reduce, r_at = [], [], [], []
        for part, (a, ext, st, sl, nzl), runs in zip(parts, self.level_meta, self.support_runs):
            xg = part.reshape(nzl, ext[1], ext[2])
            if runs == ((0, 0, ext[0]),):  # degenerate: the whole level
                gather.append(xg.reshape(-1))
                g_at.append((st, ext, None))
                continue
            for ax, lo, hi in runs:
                if ax == 0:  # planes of varying owners: mine, zero elsewhere
                    run = torch.zeros((hi - lo, ext[1], ext[2]), dtype=xg.dtype, device=xg.device)
                    a0, b0 = max(lo, r * nzl), min(hi, (r + 1) * nzl)
                    if a0 < b0:
                        run[a0 - lo:b0 - lo] = xg[a0 - r * nzl:b0 - r * nzl]
                    reduce.append(run.reshape(-1))
                    r_at.append((st, ext, lo, hi))
                else:
                    cut = (slice(None), slice(lo, hi)) if ax == 1 else (
                        slice(None), slice(None), slice(lo, hi))
                    gather.append(xg[cut].reshape(-1))
                    g_at.append((st, ext, (ax, lo, hi)))
        if gather:
            sizes = [t.shape[0] for t in gather]
            G = mesh.all_gather(torch.cat(gather)).reshape(mesh.size, -1)
            for piece, (st, ext, run) in zip(torch.split(G, sizes, dim=1), g_at):
                region = xs[st:st + int(np.prod(ext))].reshape(ext)
                if run is None:
                    region.copy_(piece.reshape(ext))
                    continue
                ax, lo, hi = run
                shape = list(ext)
                shape[ax] = hi - lo
                cut = (slice(None), slice(lo, hi)) if ax == 1 else (
                    slice(None), slice(None), slice(lo, hi))
                region[cut] = piece.reshape(shape)
        if reduce:
            R = mesh.all_reduce(torch.cat(reduce))
            for run, (st, ext, lo, hi) in zip(torch.split(R, [t.shape[0] for t in reduce]), r_at):
                xs[st:st + int(np.prod(ext))].reshape(ext)[lo:hi] = run.reshape(hi - lo, *ext[1:])
        return xs

    def matvec(self, x):
        x = x.contiguous()
        parts = [x[sl:sl + nzl * ext[1] * ext[2]] for (a, ext, st, sl, nzl) in self.level_meta]
        planes = [ext[1] * ext[2] for (a, ext, st, sl, nzl) in self.level_meta]
        from_prev, from_next = self.mesh.halo_exchange(
            torch.cat([p[:n] for p, n in zip(parts, planes)]),
            torch.cat([p[-n:] for p, n in zip(parts, planes)]))
        ys = []
        for part, lv, fp, fn, (a, ext, st, sl, nzl) in zip(
                parts, self.levels, torch.split(from_prev, planes),
                torch.split(from_next, planes), self.level_meta):
            n = part.shape[0]
            ys.append(lv.local_matvec(part, fp, fn) * self.keep[sl:sl + n])

        # The interface on the rebuilt support, replicated; keep my z-portion.
        xs = self._support(parts)
        yi = apply_fused_interface(self.fused, xs, torch.zeros_like(xs))
        if self._n_buckets:
            yi = ell_tail(xs, self.ifc_buckets, yi)
        r = self.mesh.rank
        for i, (a, ext, st, sl, nzl) in enumerate(self.level_meta):
            mine = yi[st:st + int(np.prod(ext))].reshape(ext)[r * nzl:(r + 1) * nzl]
            ys[i] = ys[i] + mine.reshape(-1)
        return torch.cat(ys) + self.diag * x

    def rmatvec(self, x):
        if self.symmetric:
            return self.matvec(x)
        raise NotImplementedError("sharded CompositeV2 rmatvec requires symmetric=True")


def shard_composite_v2(
    comp: CompositeV2,
    mesh: RowMesh,
    degenerate_frac: float = 0.6,
) -> ShardedCompositeV2:
    """This rank's part of ``comp`` re-partitioned over the mesh.

    Every level's region z-extent must divide by D (choose n_fine so that
    n_fine/box_depth and the coarse extents do — e.g. multiples of
    8*box_depth*max_spacing).  The returned operator acts on device-major
    vectors; translate layouts through ``.host`` (to_sharded/from_sharded/
    live_mask).  Numerically ``comp`` (tests pin the matvec and the
    restarted solve).
    """
    return ShardedCompositeV2(comp, mesh, plan_composite_v2(comp, mesh.size, degenerate_frac))
