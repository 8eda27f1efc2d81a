"""Device default, dtype and host-array conversions shared by the port's modules."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DEFAULT_DEVICE", "as_torch_dtype", "as_numpy_dtype", "to_numpy"]

#: Where every constructor and builder of the port allocates unless the
#: caller passes ``device=``.  On a host without a card a call that leaves
#: ``device`` out raises from PyTorch; it never quietly builds CPU tensors.
DEFAULT_DEVICE = "cuda"


def as_torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, a numpy dtype or a name such as
    ``"float32"`` (the CLI and the JAX package's callers pass names)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def as_numpy_dtype(dtype) -> np.dtype:
    return torch.empty(0, dtype=as_torch_dtype(dtype)).numpy().dtype


def to_numpy(x) -> np.ndarray:
    """Host numpy copy of a tensor (any device) or array-like."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)
