"""Row-sharded operators and Lanczos: z-slab stencils, sharded ELL, halo ELL.

Counterpart of ``lanczos_tpu/parallel/distributed.py``.  The rows of H and
of the Krylov basis are split over the ranks of a :class:`RowMesh`; each
rank holds one block of rows on its device and runs the port's solvers on
it, their dots and norms all-reduced (``solver/rows.py``).  The JAX
package's ``shard_map`` over one jitted program becomes one process per
rank, each launching its own kernels.

* :class:`ShardedStencilOperator`: the grid's slowest axis (z) is split
  into slabs of nz/D planes.  The hot path is the port's CUDA SpMV on the
  rank's ``(nz/D, ny, nx)`` slab, run z-periodically; only its first and
  last output planes differ from the global operator, and a two-plane
  correction built from the neighbours' halo planes fixes them (the JAX
  package's ``_stencil_local_matvec``, ``distributed.py:84-127``).  Here the
  correction is one more launch of the same kernel on a 4-plane grid
  ``[d_top, 0, 0, d_bot]`` (d = the neighbour's plane minus the wrapped
  local one): its plane 1 is the dz=-1 taps applied to d_top and its
  plane 2 the dz=+1 taps applied to d_bot, so the nine taps of each plane
  cost one launch and not eighteen rolls.  :meth:`~ShardedStencilOperator.
  local_matvec` is the arithmetic alone, fed the halo planes;
  :meth:`~ShardedStencilOperator.matvec` exchanges them first
  (:meth:`RowMesh.halo_exchange`, 2 planes a step).  A stencil outside
  the kernel's domain takes the JAX package's roll path on a halo-padded
  slab.
* :class:`ShardedEllOperator`: row-sharded ELL whose matvec all-gathers x.
* :class:`EllHaloOperator` / :func:`shard_ell_halo`: ELL whose ranks
  exchange only the (D, E) table of the slots another rank reads (the
  host analysis is the JAX package's, verbatim).
* :func:`shard_operator` dispatches on the operator's type as the JAX
  package does; :func:`lanczos_sharded` runs ``solver/lanczos.py``'s
  recurrence on a sharded operator.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._util import to_numpy
from ..ops.operators import EllOperator, RowShardedOperator, StencilOperator
from ..ops.stencil_kernels import kernel_supported
from ..solver.lanczos import LanczosFactorization, lanczos
from .mesh import RowMesh

__all__ = [
    "ShardedStencilOperator",
    "ShardedEllOperator",
    "EllHaloOperator",
    "lanczos_sharded",
    "shard_ell_halo",
    "shard_operator",
]


def _rank_rows(t: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """This rank's block of rows of a global tensor, on the mesh's device."""
    r = t.shape[0] // mesh.size
    return t[mesh.rank * r:(mesh.rank + 1) * r].to(mesh.device)


def _divides(m: int, mesh: RowMesh) -> int:
    if m % mesh.size:
        raise ValueError(
            f"operator dimension {m} must divide across {mesh.size} devices (pad the assembly)"
        )
    return m // mesh.size


class ShardedStencilOperator(RowShardedOperator):
    """A StencilOperator split into z-slabs, one per rank (see the module
    docstring).  ``slab`` is the rank's (nz/D, ny, nx) StencilOperator with
    its rows of the diagonal; ``corr`` the 4-plane operator of the
    correction (no diagonal), both built once, so the kernel wrapper's
    weight cache is read once per operator."""

    def __init__(self, op: StencilOperator, mesh: RowMesh):
        grid = op.grid_shape
        nz = grid[0]
        if nz % mesh.size:
            raise ValueError(
                f"leading grid dim {nz} must divide across {mesh.size} devices"
            )
        nz_loc = nz // mesh.size
        super().__init__(mesh, op.shape[0], nz_loc * int(np.prod(grid[1:], dtype=np.int64)))
        self.halo = max(abs(off[0]) for off in op.offsets)
        if self.halo > nz_loc:
            raise ValueError(f"stencil depth {self.halo} exceeds the slab's {nz_loc} planes")
        self.plane = int(np.prod(grid[1:], dtype=np.int64))
        self.grid_shape = tuple(grid)
        weights = op.weights.to(mesh.device)
        diag = None if op.diag is None else _rank_rows(op.diag, mesh)
        self.slab = StencilOperator(weights, diag, (nz_loc, *grid[1:]), op.offsets, op.graded)
        self.kernel = kernel_supported(self.slab)
        self.corr = (StencilOperator(weights, None, (4, *grid[1:]), op.offsets, op.graded)
                     if self.kernel else None)

    @property
    def dtype(self):
        return self.slab.dtype

    @property
    def offsets(self):
        return self.slab.offsets

    @property
    def graded(self):
        return self.slab.graded

    def local_matvec(self, x, from_prev, from_next):
        """This rank's rows of A x from its rows of x and the halo planes:
        ``from_prev`` the previous rank's last ``halo`` planes, ``from_next``
        the next rank's first (flat, ``halo * ny * nx`` each)."""
        if self.kernel:
            y = self.slab.matvec(x)
            p = self.plane
            d = torch.zeros(4 * p, dtype=x.dtype, device=x.device)
            d[:p] = from_prev - x[-p:]
            d[3 * p:] = from_next - x[:p]
            c = self.corr.matvec(d)
            y[:p] += c[p:2 * p]
            y[-p:] += c[2 * p:3 * p]
            return y
        # The JAX package's roll path, on the slab padded with the halos.
        h, rest = self.halo, self.slab.grid_shape[1:]
        nz_loc = self.slab.grid_shape[0]
        xg = x.reshape(self.slab.grid_shape)
        if h:
            xg = torch.cat([from_prev.reshape(h, *rest), xg, from_next.reshape(h, *rest)])
        dims = tuple(range(1, len(self.slab.grid_shape)))
        y = torch.zeros(self.slab.grid_shape, dtype=x.dtype, device=x.device)
        for w, off in zip(self.slab.weights, self.slab.offsets):
            block = xg[h + off[0]:h + off[0] + nz_loc]
            tail = tuple(-o for o in off[1:])
            if any(tail):
                block = torch.roll(block, shifts=tail, dims=dims)
            y = y + w * block
        y = y.reshape(-1)
        if self.slab.diag is not None:
            y = y + self.slab.diag * x
        return y

    def matvec(self, x):
        if not self.halo:
            return self.local_matvec(x, None, None)
        n = self.halo * self.plane
        from_prev, from_next = self.mesh.halo_exchange(x[:n], x[-n:])
        return self.local_matvec(x, from_prev, from_next)

    def rmatvec(self, x):
        if self.graded is not None:  # mirror-symmetric
            return self.matvec(x)
        raise NotImplementedError("sharded stencil rmatvec needs a graded (symmetric) stencil")


class ShardedEllOperator(RowShardedOperator):
    """Row-sharded ELL: this rank's rows of ``cols``/``vals`` (global column
    indices); the matvec all-gathers x (M - M/D elements received a step)."""

    def __init__(self, cols: torch.Tensor, vals: torch.Tensor, mesh: RowMesh, m: int):
        super().__init__(mesh, m, cols.shape[0])
        self.register_buffer("cols", cols.to(torch.int64))
        self.register_buffer("vals", vals)

    @property
    def dtype(self):
        return self.vals.dtype

    def matvec(self, x):
        return torch.sum(self.vals * self.mesh.all_gather(x)[self.cols], dim=1)

    def matmat(self, X):
        return torch.einsum("mk,mkb->mb", self.vals, self.mesh.all_gather(X)[self.cols])


class EllHaloOperator(RowShardedOperator):
    """Row-sharded ELL with a halo-compressed exchange.

    Built by :func:`shard_ell_halo`: each rank's EXPORT list (its local
    slots that another rank's rows read) is found on the host; per matvec
    every rank all-gathers only the (D, E) export table (E = the largest
    export count), and the columns are remapped into [local | table]
    positions: entries < M/D index the local rows, entries >= M/D the
    gathered table at (value - M/D).

    cols, vals: this rank's (M/D, K) remapped columns and values (0 pad).
    export_ids: (D, E) every rank's LOCAL indices of its exported slots.
    """

    def __init__(self, cols, vals, export_ids, mesh: RowMesh, m: int):
        super().__init__(mesh, m, cols.shape[0])
        self.register_buffer("cols", cols.to(torch.int64))
        self.register_buffer("vals", vals)
        self.register_buffer("export_ids", export_ids.to(torch.int64))

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def exchange_elements(self) -> int:
        """Elements of the gathered table a matvec (vs M for all-gather)."""
        return int(np.prod(self.export_ids.shape))

    def _x_cat(self, x):
        table = self.mesh.all_gather(x[self.export_ids[self.mesh.rank]])
        return torch.cat([x, table])

    def matvec(self, x):
        return torch.sum(self.vals * self._x_cat(x)[self.cols], dim=1)

    def matmat(self, X):
        return torch.einsum("mk,mkb->mb", self.vals, self._x_cat(X)[self.cols])


def shard_ell_halo(op: EllOperator, mesh: RowMesh) -> EllHaloOperator:
    """The halo-compressed sharded form of an EllOperator (this rank's part).

    Host-side analysis: for each rank, the remote columns its rows read;
    the union per OWNER rank is that owner's export list.  E can approach
    M/D for non-local graphs: the format stays correct, just not thinner."""
    D = mesh.size
    cols = to_numpy(op.cols).astype(np.int64)
    vals = to_numpy(op.vals)
    m, kk = cols.shape
    r = _divides(m, mesh)
    owner = cols // r  # (M, K) owning rank of each referenced slot
    row_dev = np.repeat(np.arange(D), r)[:, None]  # (M, 1)
    real = vals != 0
    remote = real & (owner != row_dev)

    # Export list per owner rank: slots read by any foreign rank.
    exports = []
    for o in range(D):
        sel = remote & (owner == o)
        exports.append(np.unique(cols[sel]) if sel.any() else np.empty(0, np.int64))
    e_max = max(1, max(len(e) for e in exports))
    export_ids = np.zeros((D, e_max), dtype=np.int64)
    for o, e in enumerate(exports):
        export_ids[o, : len(e)] = e - o * r

    # Remap columns: local -> local index; remote -> r + table position
    # (the exports are sorted, so the position is a searchsorted).
    new_cols = np.zeros_like(cols, dtype=np.int64)
    local = real & (owner == row_dev)
    new_cols[local] = cols[local] % r
    for o, e in enumerate(exports):
        sel = remote & (owner == o)
        if len(e) and sel.any():
            new_cols[sel] = r + o * e_max + np.searchsorted(e, cols[sel])

    mine = slice(mesh.rank * r, (mesh.rank + 1) * r)
    return EllHaloOperator(
        cols=torch.as_tensor(new_cols[mine], device=mesh.device),
        vals=torch.as_tensor(vals[mine], device=mesh.device),
        export_ids=torch.as_tensor(export_ids, device=mesh.device),
        mesh=mesh, m=m,
    )


def shard_operator(op, mesh: RowMesh) -> RowShardedOperator:
    """This rank's part of ``op`` split by rows over ``mesh`` (each rank
    holds 1/D of the operator: ELL rows and diagonal split, stencil
    weights replicated).

    A CompositeV2 becomes a ShardedCompositeV2 and a v1 CompositeOperator a
    ShardedCompositeOperator, whose vectors are DEVICE-MAJOR, not the
    input's level-major layout: translate through ``.host`` (to_sharded,
    from_sharded, live_mask)."""
    from ..ops.composite import CompositeOperator, shard_composite
    from ..ops.composite2 import CompositeV2

    if isinstance(op, EllOperator):
        _divides(op.shape[0], mesh)
        return ShardedEllOperator(_rank_rows(op.cols, mesh), _rank_rows(op.vals, mesh),
                                  mesh, op.shape[0])
    if isinstance(op, StencilOperator):
        return ShardedStencilOperator(op, mesh)
    if isinstance(op, CompositeV2):
        from .composite2 import shard_composite_v2

        return shard_composite_v2(op, mesh)
    if isinstance(op, CompositeOperator):
        return shard_composite(op, mesh.size).as_operator(mesh)
    raise TypeError(f"cannot shard operator of type {type(op).__name__}")


def lanczos_sharded(
    op,
    n: int,
    mesh: Optional[RowMesh] = None,
    *,
    seed: int = 99,
    v0=None,
    reorth: str = "full",
    reorth_passes: int = 2,
    reorth_period: int = 5,
    dtype=None,
) -> LanczosFactorization:
    """Row-sharded n-step Lanczos: ``solver/lanczos.py``'s recurrence with
    its dots and Gram-Schmidt products all-reduced over the mesh.

    ``op`` is a sharded operator (:func:`shard_operator`), or an unsharded
    one that is sharded over ``mesh`` first.  ``v0`` is the global (M,)
    vector (default: Uniform(-1, 1) from a ``torch.Generator`` seeded with
    ``seed``, drawn on the CPU on every rank), of which each rank keeps its
    rows, so the result does not depend on D.  Returns a
    LanczosFactorization whose V (n, M/D) and resid (M/D,) are this rank's
    rows; alpha and beta are the same on every rank."""
    if not isinstance(op, RowShardedOperator):
        if mesh is None:
            raise ValueError("an unsharded operator needs the mesh to shard it over")
        op = shard_operator(op, mesh)
    elif mesh is not None and mesh is not op.mesh:
        raise ValueError("the operator is sharded over another mesh")
    return lanczos(op, n, seed=seed, v0=v0, reorth=reorth, reorth_passes=reorth_passes,
                   reorth_period=reorth_period, dtype=dtype)
