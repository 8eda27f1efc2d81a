"""Carry objects of the JAX package across to the port.

:func:`from_jax` turns a ``lanczos_tpu`` StencilOperator, EllOperator,
DenseOperator or LanczosFactorization into the port's counterpart, so both
packages can compute with identical operators and states.  It reads
attributes through ``np.asarray`` and never imports ``jax`` itself.
"""

from __future__ import annotations

import numpy as np
import torch

from ._util import as_torch_dtype
from .ops.operators import DenseOperator, EllOperator, StencilOperator
from .solver.lanczos import LanczosFactorization

__all__ = ["from_jax"]


def from_jax(obj, *, device="cpu", dtype=None):
    """The port's counterpart of a ``lanczos_tpu`` object, on ``device``.

    Floating arrays are converted to ``dtype`` (default: their own).
    """

    def t(a, dt=dtype):
        arr = np.array(a)  # a writable host copy of the (read-only) JAX buffer
        return torch.as_tensor(
            arr, dtype=None if dt is None else as_torch_dtype(dt), device=device
        )

    kind = type(obj).__name__
    if not type(obj).__module__.startswith("lanczos_tpu."):
        raise TypeError(f"not a lanczos_tpu object: {type(obj)!r}")
    if kind == "StencilOperator":
        return StencilOperator(
            weights=t(obj.weights),
            diag=None if obj.diag is None else t(obj.diag),
            grid_shape=obj.grid_shape,
            offsets=obj.offsets,
            graded=obj.graded,
        )
    if kind == "EllOperator":
        return EllOperator(cols=t(obj.cols, torch.int64), vals=t(obj.vals))
    if kind == "DenseOperator":
        return DenseOperator(t(obj.A))
    if kind == "LanczosFactorization":
        return LanczosFactorization(
            alpha=t(obj.alpha), beta=t(obj.beta), V=t(obj.V), resid=t(obj.resid),
            breakdown_iter=t(obj.breakdown_iter, torch.int64),
        )
    raise TypeError(f"no port counterpart for lanczos_tpu {kind}")
