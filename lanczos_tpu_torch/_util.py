"""Device default, dtype and host-array conversions, and the solvers' spans
and counters, shared by the port's modules."""

from __future__ import annotations

import collections

import numpy as np
import torch

__all__ = ["DEFAULT_DEVICE", "COUNTERS", "span", "as_torch_dtype", "as_numpy_dtype",
           "to_numpy"]

#: Where every constructor and builder of the port allocates unless the
#: caller passes ``device=``.  On a host without a card a call that leaves
#: ``device`` out raises from PyTorch; it never quietly builds CPU tensors.
DEFAULT_DEVICE = "cuda"

#: Process totals of the single-vector ``eigsh`` path: ``lt.eigsh.calls``
#: (one per call of ``eigsh``, so also the number of the solve running) and
#: ``lt.lanczos.recurrence.steps`` (the Lanczos steps run, added once per
#: recurrence loop).  Readers take differences or ratios; nothing resets it.
COUNTERS: collections.Counter = collections.Counter()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` (``lt.*``):
    it lands in the profiler's trace beside the kernels launched inside it,
    on the same clock.  It costs ~10 us of host time even when no profiler
    is active, so spans mark phases of a solve, never single steps."""
    return torch.profiler.record_function(name)


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
