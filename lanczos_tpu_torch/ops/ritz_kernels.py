"""The Ritz rotation: a CUDA kernel and its plain PyTorch version.

:func:`rotate` returns ``V.T @ W[:, cols]`` (M, k), contiguous, for a
Lanczos basis ``V`` (n, M) and the eigenvectors ``W`` of its tridiagonal
matrix: the Ritz vectors of the k pairs ``cols`` names (every column of
``W`` when ``cols`` is None).  The plain version, :func:`rotate_reference`,
is that product, which runs on CPU tensors.  On the card the kernel of
``csrc/ritz.cu`` reads ``V`` once and gathers up to :data:`K_MAX` columns
of ``W`` itself, with their accumulators in registers (see the source's
header for the design and what bounds it); a wider k is split into chunks
of at most :data:`K_MAX` columns (:func:`chunk_width`), rotated by the
blocks of the same launch, which share their reads of ``V`` through L2.
It replaces no TPU kernel: the JAX package rotates all n Ritz vectors with
one matmul and keeps k of them.

On the card every call launches the kernel: a ``V`` that is not contiguous
is copied first, and a dtype other than float32/float64, or a ``W`` of
another dtype, raises ``TypeError``.  ``COUNTERS["lt.ritz.launches"]``
counts the kernel's launches, one a call.
"""

from __future__ import annotations

import functools

import torch

from .._util import COUNTERS
from ._build import launch_on

__all__ = ["K_MAX", "chunk_width", "rotate", "rotate_reference"]

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}

#: The most columns one block rotates, the source's ``kMaxCols``: 4 x 24
#: fp32 (2 x 24 fp64) accumulators a thread leave two blocks an SM; a wider
#: k is split into chunks of at most this many columns.
K_MAX = 24


def rotate_reference(V: torch.Tensor, W: torch.Tensor, cols=None) -> torch.Tensor:
    """Plain PyTorch: ``V.T @ W[:, cols]`` (``V.T @ W`` for ``cols=None``)."""
    return V.T @ (W if cols is None else W[:, cols])


def chunk_width(k: int) -> int:
    """The columns of each chunk of a k-column rotation: k up to K_MAX,
    else as few chunks as K_MAX allows, of near-equal widths rounded up to
    a multiple of 4, so that every chunk but the last fills its
    accumulators and starts on a multiple of 4 columns, where its 16-byte
    stores stay aligned when k is a multiple of 4 too."""
    if k <= K_MAX:
        return k
    width = -(-k // -(-k // K_MAX))
    return width + -width % 4


@functools.lru_cache(maxsize=None)
def _library():
    from ._build import load_ritz_library

    lib, _ = load_ritz_library()
    return lib


def _indices(cols, W: torch.Tensor) -> torch.Tensor:
    """``cols`` as a 1-D int64 tensor on ``W``'s device; indices given on
    the host are checked against W's columns there (on the card an index
    out of range gives a column of NaN)."""
    cols = torch.as_tensor(cols)
    if cols.ndim != 1 or cols.dtype.is_floating_point or cols.dtype == torch.bool:
        raise ValueError(f"cols must be a 1-D tensor of indices, got {cols.dtype} "
                         f"{tuple(cols.shape)}")
    if cols.device.type == "cpu" and cols.numel() and (
            int(cols.min()) < 0 or int(cols.max()) >= W.shape[1]):
        raise IndexError(f"cols outside W's {W.shape[1]} columns")
    return cols.to(device=W.device, dtype=torch.int64)


def rotate(V: torch.Tensor, W: torch.Tensor, cols=None) -> torch.Tensor:
    """``V.T @ W[:, cols]`` (M, k) for ``V`` (n, M), ``W`` (n, n_w), any
    strides, and ``cols`` k indices into W's columns, in ``cols``' order
    (None: all n_w columns in order)."""
    if V.ndim != 2 or W.ndim != 2 or W.shape[0] != V.shape[0]:
        raise ValueError(f"rotate takes V (n, M) and W (n, n_w); got V {tuple(V.shape)}, "
                         f"W {tuple(W.shape)}")
    if cols is not None:
        cols = _indices(cols, W)
    if V.device.type == "cpu":
        return rotate_reference(V, W, cols)
    if V.dtype not in _DTYPES or W.dtype != V.dtype:
        raise TypeError(f"the rotation kernel takes float32/float64 V and W of its dtype, "
                        f"got {V.dtype} and {W.dtype}")
    if W.device != V.device:
        raise ValueError(f"rotate takes V and W on one device, got {V.device} and {W.device}")
    if cols is None:
        cols = torch.arange(W.shape[1], device=V.device)
    V, cols = V.contiguous(), cols.contiguous()  # no copy for the solver's basis
    n, m = V.shape
    k = cols.numel()
    X = torch.empty((m, k), dtype=V.dtype, device=V.device)
    if m == 0 or k == 0:
        return X
    err = launch_on(V.device, getattr(_library(), f"ritz_rotate_{_DTYPES[V.dtype]}"),
                    V.data_ptr(), W.data_ptr(), cols.data_ptr(), X.data_ptr(), m, n,
                    W.stride(0), W.stride(1), W.shape[1], k, chunk_width(k))
    if err != 0:
        raise RuntimeError(f"ritz_rotate launch failed with CUDA error {err}")
    COUNTERS["lt.ritz.launches"] += 1
    return X
