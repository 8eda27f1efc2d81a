"""Operator application to double-word vectors: the 1e-8 residual path.

Counterpart of ``lanczos_tpu/ops/dd.py``.  float32-stored eigenvectors hit a
true-residual floor of ~2 eps32; the refinement (``solver/refine.py``)
breaks it by holding the vectors as x = x_hi + x_lo and computing
residuals exact to ~1e-14.  The JAX package emulates that with error-free
products of float32 pairs, because the TPU has no fast float64.  The H100
has, so here float64 stands in for the pair (both take 8 bytes an
element): ``matvec_dd`` applies the operator's float64 copy to x_hi + x_lo
and splits the result.

**The float64 copy is the float32-stored operator cast to float64**
(:func:`to_float64`: a deep copy, then ``nn.Module.to``), never an operator
assembled again in float64: the dd path applies the *stored* float32
coefficients exactly, and a reassembled operator would differ from them by
~eps32 ||H|| and floor the residual there.  A StencilOperator's weight
ladder ``graded`` (Python floats) is rounded to float32 with it, and its
kernel cache is rebuilt from the cast weights.  On a card the copy's
matvec runs the float64 stencil SpMV and interface kernels.

``matvec_dd`` casts the operator on each call; a caller that applies it
many times (the refinement) casts once with :func:`to_float64` and passes
the copy, which ``matvec_dd`` then uses as it is.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .operators import DenseOperator, EllOperator, StencilOperator

__all__ = ["matvec_dd", "matmat_dd", "dd_split_scalar", "to_float64"]


def dd_split_scalar(v: float, dtype=torch.float32):
    """Split a Python/float64 scalar into an (hi, lo) pair of 0-d tensors."""
    hi = torch.tensor(v, dtype=torch.float64).to(dtype)
    return hi, (torch.tensor(v, dtype=torch.float64) - hi.double()).to(dtype)


def _split(y: torch.Tensor, dtype):
    hi = y.to(dtype)
    return hi, (y - hi.double()).to(dtype)


def _supported(op) -> bool:
    from .composite2 import CompositeV2

    return isinstance(op, (StencilOperator, CompositeV2, DenseOperator, EllOperator))


def to_float64(op):
    """A float64 copy of ``op`` holding its stored coefficients exactly;
    ``op`` itself is left as it is."""
    if not _supported(op):
        raise NotImplementedError(f"dd path: unsupported operator {type(op)}")
    if op.dtype == torch.float64:
        return op
    # The stencil kernels' caches hold the float32 weights and launch
    # arguments (ctypes pointers, which do not copy): the copy starts
    # without them and builds its own from the cast weights.
    memo = {id(m.__dict__["_stencil_kernel_cache"]): None for m in op.modules()
            if m.__dict__.get("_stencil_kernel_cache") is not None}
    op64 = copy.deepcopy(op, memo).to(torch.float64)
    for m in op64.modules():
        if isinstance(m, StencilOperator) and m.graded is not None:
            m.graded = tuple(float(np.float32(g)) for g in m.graded)
    return op64


def matvec_dd(op, x_hi: torch.Tensor, x_lo: torch.Tensor):
    """(y_hi, y_lo) = A (x_hi + x_lo), through ``op``'s float64 copy."""
    op64 = to_float64(op)
    return _split(op64.matvec(x_hi.double() + x_lo.double()), x_hi.dtype)


def apply_columns(op64, X: torch.Tensor) -> torch.Tensor:
    """A X for a float64 (M, k) block, one matvec per column (on a card the
    float64 SpMV and interface kernels), as the JAX package maps the
    double-word matvec over columns."""
    return torch.stack([op64.matvec(X[:, j].contiguous()) for j in range(X.shape[1])], dim=1)


def matmat_dd(op, X_hi: torch.Tensor, X_lo: torch.Tensor):
    """Column-wise dd matmat: (Y_hi, Y_lo) for (M, k) blocks."""
    return _split(apply_columns(to_float64(op), X_hi.double() + X_lo.double()), X_hi.dtype)
