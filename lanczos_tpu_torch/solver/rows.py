"""A solver's reductions over its operator's rows, sharded or not.

An unsharded operator's vectors live whole on one device, and a solver's
dots, norms and Gram products are local sums.  A row-sharded operator
(``ops/operators.py:RowShardedOperator``, built by ``parallel/``) gives
each rank a block of rows and carries its ``mesh``; every such reduction
is then a local partial sum all-reduced over the mesh, which is what GSPMD
does for the JAX package's sharded solves.  :class:`Rows` holds both forms
behind one interface, so each solver has one copy: the recurrences take
``dot``/``basis_dot`` from it, and the verification residuals, Gram
matrices and acceptance sums go through :meth:`Rows.sum`.  Everything the
host decides on (convergence, restarts, breakdown) is then computed from
all-reduced values, the same on every rank, so all ranks take the same
branches.  The unsharded dots are :func:`default_dot` and
``ops/cgs2_kernels.py:local_basis_dot``; :func:`resolve_dot` swaps in the
compensated dot.

:func:`_start_vector` draws the global start vector from ``seed`` with a
``torch.Generator`` on the CPU; a rank keeps its own rows of it, masked by
the operator's ``live`` rows, so a sharded solve starts where the
unsharded one does.
"""

from __future__ import annotations

import warnings

import torch

from .._util import as_torch_dtype
from ..ops.cgs2_kernels import local_basis_dot

__all__ = ["Rows"]


def default_dot(a, b):
    """The vector-vector dot of an unsharded solve."""
    return torch.dot(a, b)


def resolve_dot(dot, compensated: bool):
    """Swap the default vector-vector dot for the error-free-transform one
    (``ops/compensated.py:dot2_rounded``) when ``compensated``.

    Compensation targets the recurrence's reductions (alpha, beta, norms),
    whose plain float32 rounding floors the Ritz residuals; the
    reorthogonalization products stay plain (CGS2 corrects itself).  A
    custom ``dot`` is kept, with a warning.
    """
    if not compensated:
        return dot
    if dot is default_dot:
        from ..ops.compensated import dot2_rounded

        return dot2_rounded
    warnings.warn(
        "compensated=True has no effect when a custom dot is supplied; "
        "compensation applies only to the default dot",
        stacklevel=3,
    )
    return dot


class Rows:
    """The reductions over ``op``'s rows.  ``compensated`` selects the
    error-free-transform dot (``ops/compensated.py:dot2_rounded``; over a
    mesh its all-reduced form, ``RowMesh.dot2_rounded``)."""

    def __init__(self, op, compensated: bool = False):
        self.mesh = getattr(op, "mesh", None)
        if self.mesh is None:
            self.n = op.shape[0]
            self.dot = resolve_dot(default_dot, compensated)
            self.basis_dot = local_basis_dot
        else:
            self.n = op.local_rows
            self.dot = self.mesh.dot2_rounded if compensated else self.mesh.dot
            self.basis_dot = self.mesh.basis_dot

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, a sum over this rank's rows, summed over every rank."""
        return t if self.mesh is None else self.mesh.all_reduce(t)

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return torch.linalg.vector_norm(v)
        return torch.sqrt(self.mesh.dot(v, v))

    def col_norms(self, X: torch.Tensor) -> torch.Tensor:
        """The 2-norm of each column of an (M, k) block."""
        if self.mesh is None:
            return torch.linalg.vector_norm(X, dim=0)
        return torch.sqrt(self.sum(torch.sum(X * X, dim=0)))


def _unsharded(op, solver: str) -> None:
    """Raise for a row-sharded operator: ``solver`` takes whole vectors."""
    if getattr(op, "mesh", None) is not None:
        raise NotImplementedError(
            f"{solver} takes an unsharded operator; the row-sharded solvers are lanczos, "
            "eigsh, eigsh_restarted, arnoldi and eigs_nonsym")


def _check_dtype(op, dtype):
    dtype = op.dtype if dtype is None else as_torch_dtype(dtype)
    if dtype != op.dtype:
        raise ValueError(
            f"dtype {dtype} differs from the operator's {op.dtype}; build the "
            "operator in the dtype to solve in"
        )
    return dtype


def _start_vector(op, v0, seed, dtype):
    """The start vector on ``op``'s device: ``v0`` (array-like or tensor)
    or Uniform(-1, 1) numbers from a ``torch.Generator`` seeded with
    ``seed``, drawn on the CPU.

    For a row-sharded operator ``v0`` is the global (M,) vector, of which
    this rank keeps its rows (or already this rank's (local_rows,) rows),
    multiplied by the operator's ``live`` rows when it has them."""
    m = op.shape[0]
    if v0 is None:
        gen = torch.Generator().manual_seed(seed)
        v0 = torch.rand(m, generator=gen, dtype=dtype) * 2.0 - 1.0
    v0 = torch.as_tensor(v0)
    if getattr(op, "mesh", None) is not None:
        n, off = op.local_rows, op.row_offset
        if v0.shape == (m,):
            v0 = v0[off:off + n]
        elif v0.shape != (n,):
            raise ValueError(f"v0 has shape {tuple(v0.shape)}, expected ({m},) or ({n},)")
        v0 = v0.to(device=op.device, dtype=dtype)
        live = getattr(op, "live", None)
        return v0 if live is None else v0 * live
    v0 = v0.to(device=op.device, dtype=dtype)
    if v0.shape != (m,):
        raise ValueError(f"v0 has shape {tuple(v0.shape)}, expected ({m},)")
    return v0
