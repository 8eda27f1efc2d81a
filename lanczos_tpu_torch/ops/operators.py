"""Linear operators on PyTorch tensors.

Counterpart of ``lanczos_tpu/ops/operators.py``.  Each operator is an
``nn.Module`` whose arrays are buffers, so ``op.to(device)`` moves it, and
whose ``matvec`` / ``rmatvec`` / ``matmat`` are plain methods.  Vectors are
flat ``(M,)`` (``vec_shape``); the JAX package's flat-plane layout was a
choice for the TPU kernel and is not kept.

* :class:`DenseOperator` — a dense matrix (small problems and tests).
* :class:`EllOperator` — padded ELLPACK: a gather matvec, a scatter-add
  (``index_add_``) rmatvec.
* :class:`StencilOperator` — a constant-coefficient stencil on a periodic
  regular grid plus a diagonal.  3D stencils with offsets in {-1,0,1}^3 go
  to the stencil kernels of ``ops/stencil_kernels.py`` (a CUDA kernel on a
  card, its plain version on the CPU); any other stencil takes the plain
  roll path on every device, as in the JAX package, which has no kernel for
  those either.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .._util import DEFAULT_DEVICE, as_torch_dtype, to_numpy
from .stencil_kernels import (
    kernel_supported,
    stencil_spmm,
    stencil_spmm_reference,
    stencil_spmv,
    stencil_spmv_reference,
)

__all__ = [
    "LinearOperator",
    "RowShardedOperator",
    "DenseOperator",
    "EllOperator",
    "StencilOperator",
    "make_stencil_operator",
    "as_operator",
]


class LinearOperator(nn.Module):
    """A square linear operator: ``matvec``, ``rmatvec`` and ``matmat`` on
    tensors of its device and dtype.  Calling it applies ``matvec`` to a
    vector and ``matmat`` to an (M, b) block."""

    @property
    def shape(self) -> Tuple[int, int]:
        raise NotImplementedError

    @property
    def dtype(self) -> torch.dtype:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    @property
    def vec_shape(self) -> Tuple[int, ...]:
        """The layout this operator takes its vectors in: flat (M,)."""
        return (self.shape[0],)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x for x of shape (M,)."""
        raise NotImplementedError

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A.T @ x.  Needed by the two-sided (non-Hermitian) Lanczos."""
        raise NotImplementedError

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Y = A @ X for a block X of shape (M, b)."""
        return torch.stack([self.matvec(X[:, j]) for j in range(X.shape[1])], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 1:
            return self.matvec(x)
        return self.matmat(x)

    def to_dense(self) -> torch.Tensor:
        m = self.shape[0]
        return self.matmat(torch.eye(m, dtype=self.dtype, device=self.device))

    def to_scipy(self):
        """CSR copy for host-side oracle comparisons (tests only)."""
        import scipy.sparse

        return scipy.sparse.csr_matrix(to_numpy(self.to_dense()))


class RowShardedOperator(LinearOperator):
    """An operator whose rows are split over the ranks of a row mesh
    (``parallel/mesh.py:RowMesh``, kept in ``mesh``).

    Each rank holds ``local_rows`` rows, from global row ``row_offset``;
    ``matvec``/``matmat`` take and return this rank's rows of a vector or
    block and exchange what they need through the mesh, so every rank calls
    them together.  ``shape`` is the global one; a ``live`` buffer, where a
    subclass has one, is 1 on this rank's rows that hold a point and 0 on
    padding, and a start vector is multiplied by it.  The solvers find
    ``mesh`` on the operator and all-reduce their dots and norms over it
    (``solver/rows.py``)."""

    def __init__(self, mesh, m: int, local_rows: int):
        super().__init__()
        if m != mesh.size * local_rows:
            raise ValueError(f"{m} rows do not split into {mesh.size} blocks of {local_rows}")
        self.mesh = mesh
        self.m = m
        self.local_rows = local_rows
        self.row_offset = mesh.rank * local_rows

    @property
    def shape(self):
        return (self.m, self.m)

    @property
    def vec_shape(self):
        return (self.local_rows,)

    def to_dense(self):
        raise NotImplementedError("a row-sharded operator has no dense form on one rank")


class DenseOperator(LinearOperator):
    """Dense symmetric-or-not matrix operator (small problems and tests)."""

    def __init__(self, A: torch.Tensor):
        super().__init__()
        self.register_buffer("A", A)

    @property
    def shape(self):
        return tuple(self.A.shape)

    @property
    def dtype(self):
        return self.A.dtype

    def matvec(self, x):
        return self.A @ x

    def rmatvec(self, x):
        return self.A.T @ x

    def matmat(self, X):
        return self.A @ X

    def to_dense(self):
        return self.A


class EllOperator(LinearOperator):
    """Padded ELLPACK sparse operator.

    ``cols[i, k]`` / ``vals[i, k]`` hold the k-th nonzero of row i; short
    rows are padded with ``cols = i`` and ``vals = 0``.  The matvec is a
    gather, ``y[i] = sum_k vals[i, k] * x[cols[i, k]]``.  ``cols`` is int64,
    the index type of PyTorch's gathers and ``index_add_``.
    """

    def __init__(self, cols: torch.Tensor, vals: torch.Tensor):
        super().__init__()
        self.register_buffer("cols", cols.to(torch.int64))
        self.register_buffer("vals", vals)

    @property
    def shape(self):
        m = self.cols.shape[0]
        return (m, m)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz_padded(self) -> int:
        return self.cols.shape[0] * self.cols.shape[1]

    def matvec(self, x):
        return torch.sum(self.vals * x[self.cols], dim=1)

    def matmat(self, X):
        # (M, K, b) gather then contraction over K.
        return torch.einsum("mk,mkb->mb", self.vals, X[self.cols])

    def rmatvec(self, x):
        # Scatter-add of vals[i,k] * x[i] into cols[i,k].
        m = self.cols.shape[0]
        contrib = (self.vals * x[:, None]).reshape(-1)
        y = torch.zeros(m, dtype=self.vals.dtype, device=self.vals.device)
        return y.index_add_(0, self.cols.reshape(-1), contrib)

    def transpose(self) -> "EllOperator":
        """Materialize A.T as a new EllOperator (host-side assembly)."""
        from .assemble import ell_from_coo

        cols = to_numpy(self.cols)
        vals = to_numpy(self.vals)
        m, k = cols.shape
        rows = np.repeat(np.arange(m, dtype=np.int64), k)
        flat_cols = cols.reshape(-1)
        flat_vals = vals.reshape(-1)
        mask = flat_vals != 0
        return ell_from_coo(
            flat_cols[mask], rows[mask], flat_vals[mask], m,
            dtype=self.dtype, device=self.device,
        )

    def to_scipy(self):
        import scipy.sparse

        cols = to_numpy(self.cols)
        vals = to_numpy(self.vals)
        m, k = cols.shape
        rows = np.repeat(np.arange(m), k)
        mat = scipy.sparse.coo_matrix(
            (vals.reshape(-1), (rows, cols.reshape(-1))), shape=(m, m)
        )
        mat.sum_duplicates()
        # Padding entries have val exactly 0 and vanish under eliminate_zeros.
        csr = mat.tocsr()
        csr.eliminate_zeros()
        return csr


def _normalize_offsets(offsets) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(int(o) for o in np.atleast_1d(off)) for off in offsets)


class StencilOperator(LinearOperator):
    """Matrix-free stencil + diagonal operator on a periodic regular grid.

    ``A = S + diag(d)`` with ``(S x)[c] = sum_k weights[k] x[(c + offsets[k])
    mod grid]``.  ``grid_shape`` is ordered slowest to fastest axis,
    ``(Nz, Ny, Nx)`` in 3D, so ``x.reshape(grid_shape)`` matches the flat
    index ``x + y*Nx + z*Nx*Ny``; ``offsets[k]`` use the same axis order.

    ``graded`` holds the weight ladder (w0, w1, w2, w3) of a full {-1,0,1}^3
    stencil whose weight depends only on the count of nonzero offset
    components (the 27-point Laplacian is one); such a stencil is
    mirror-symmetric, so its transpose is itself.
    """

    def __init__(
        self,
        weights: torch.Tensor,
        diag: Optional[torch.Tensor],
        grid_shape: Sequence[int],
        offsets,
        graded: Optional[Tuple[float, float, float, float]] = None,
    ):
        super().__init__()
        self.register_buffer("weights", weights)
        self.register_buffer("diag", diag)
        self.grid_shape = tuple(int(n) for n in grid_shape)
        self.offsets = _normalize_offsets(offsets)
        self.graded = graded
        kernel_supported(self)  # builds the kernels' cache: weights read once, here

    @property
    def shape(self):
        m = int(np.prod(self.grid_shape))
        return (m, m)

    @property
    def dtype(self):
        return self.weights.dtype

    def matvec(self, x):
        if kernel_supported(self):
            return stencil_spmv(self, x.contiguous())
        return stencil_spmv_reference(self, x)

    def rmatvec(self, x):
        # Transpose of a constant-coefficient periodic stencil is the stencil
        # with negated offsets; the diagonal is symmetric.
        if self.graded is not None:
            return self.matvec(x)
        xg = x.reshape(self.grid_shape)
        dims = tuple(range(len(self.grid_shape)))
        y = torch.zeros_like(xg)
        for k, off in enumerate(self.offsets):
            y = y + self.weights[k] * torch.roll(xg, shifts=off, dims=dims)
        if self.diag is not None:
            y = y + self.diag.reshape(self.grid_shape) * xg
        return y.reshape(x.shape)

    def matmat(self, X):
        if kernel_supported(self):
            return stencil_spmm(self, X.contiguous())
        return stencil_spmm_reference(self, X)

    @property
    def is_symmetric_stencil(self) -> bool:
        """True when for every offset its negation appears with equal weight."""
        table = {off: float(w) for off, w in zip(self.offsets, to_numpy(self.weights))}
        for off, w in table.items():
            neg = tuple(-o for o in off)
            if abs(table.get(neg, 0.0) - w) > 1e-12:
                return False
        return True

    def to_ell(self) -> EllOperator:
        """Materialize as an EllOperator."""
        from .assemble import stencil_to_ell

        return stencil_to_ell(self)


def _detect_graded(grid_shape, offsets, weights_np):
    """Return (w0, w1, w2, w3) if this is a full {-1,0,1}^3 stencil whose
    weight depends only on the count of nonzero offset components."""
    if len(grid_shape) != 3 or len(offsets) != 27:
        return None
    if set(offsets) != set(itertools.product((-1, 0, 1), repeat=3)):
        return None
    ladder = [None] * 4
    for off, w in zip(offsets, weights_np):
        nz = sum(o != 0 for o in off)
        if ladder[nz] is None:
            ladder[nz] = float(w)
        elif abs(ladder[nz] - float(w)) > 1e-14 * max(abs(float(w)), 1.0):
            return None
    return tuple(ladder)


def make_stencil_operator(
    grid_shape: Sequence[int],
    offsets,
    weights,
    diag=None,
    dtype=torch.float32,
    device=DEFAULT_DEVICE,
) -> StencilOperator:
    """Validating constructor: normalizes offsets, detects a graded ladder,
    and places weights and diag on ``device`` in ``dtype``."""
    dtype = as_torch_dtype(dtype)
    offsets = _normalize_offsets(offsets)
    weights_np = np.asarray(to_numpy(weights), dtype=np.float64)
    if weights_np.shape != (len(offsets),):
        raise ValueError(
            f"{len(offsets)} offsets but weights of shape {weights_np.shape}"
        )
    m = int(np.prod(grid_shape))
    if diag is not None:
        diag = torch.as_tensor(diag, dtype=dtype, device=device).reshape(-1)
        if diag.shape[0] != m:
            raise ValueError(f"diag has {diag.shape[0]} entries, grid has {m}")
    return StencilOperator(
        weights=torch.as_tensor(weights_np, dtype=dtype, device=device),
        diag=diag,
        grid_shape=grid_shape,
        offsets=offsets,
        graded=_detect_graded(grid_shape, offsets, weights_np),
    )


def as_operator(A, *, dtype=None, device=None) -> LinearOperator:
    """Coerce a dense array or tensor / scipy sparse matrix / operator to a
    LinearOperator.  ``dtype`` defaults to the input's own; ``device`` to a
    tensor's own device and to DEFAULT_DEVICE for host arrays and scipy
    matrices."""
    if isinstance(A, LinearOperator):
        return A
    import scipy.sparse

    if scipy.sparse.issparse(A):
        from .assemble import ell_from_scipy

        return ell_from_scipy(A, dtype=dtype, device=device or DEFAULT_DEVICE)
    if device is None and not torch.is_tensor(A):
        device = DEFAULT_DEVICE
    A = torch.as_tensor(A, device=device)
    if dtype is not None:
        A = A.to(as_torch_dtype(dtype))
    return DenseOperator(A)
