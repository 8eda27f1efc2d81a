"""Stencil SpMV / SpMM: CUDA kernels for Hopper and their plain PyTorch versions.

Counterpart of ``lanczos_tpu/ops/pallas_kernels.py``:

* :func:`stencil_spmv` replaces ``stencil_spmv_pallas`` (``_spmv_impl`` ->
  ``_build_call``), ``y = A x`` for a periodic 3D stencil operator.
* :func:`stencil_spmm` replaces ``stencil_spmm_pallas`` (``_spmm_impl``),
  ``Y = A X`` for a row-major ``(M, b)`` block, in one launch.

Both kernels live in ``csrc/stencil.cu`` (built by ``ops/_build.py``).  What
bounds them on the H100 is bytes: the compulsory traffic is a read of x, a
read of diag and a write of y, 12 B/point in fp32.  Their design is one
thread per output value with the neighbour reuse left to L1/L2 and the
periodic wrap done in the index math (see the source's header); the TPU
kernel's slab/halo/flat-plane layout is not carried over.

Dispatch is by the tensor's device only: a CPU tensor goes to the plain
version (``*_reference``: a sum of ``torch.roll``s over the taps plus the
diagonal), a CUDA tensor launches the kernel or raises.  There is no
fallback and no switch.  Each wrapper counts its kernel launches in
``<wrapper>.launches``, incremented where the kernel is launched and
nowhere else, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "MAX_TAPS",
    "kernel_supported",
    "stencil_spmv",
    "stencil_spmm",
    "stencil_spmv_reference",
    "stencil_spmm_reference",
]

#: Taps the CUDA kernel takes (kMaxTaps in csrc/stencil.cu): the full
#: {-1,0,1}^3 neighbourhood.
MAX_TAPS = 27

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def kernel_supported(op) -> bool:
    """True when the CUDA kernel covers ``op``: a 3D grid with at most
    MAX_TAPS taps, every offset in {-1,0,1}^3 (the Pallas kernel's domain,
    ``pallas_kernels.py:_prep``)."""
    return (
        len(op.grid_shape) == 3
        and len(op.offsets) <= MAX_TAPS
        and all(all(abs(o) <= 1 for o in off) for off in op.offsets)
    )


def stencil_spmv_reference(op, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``y = A x``: ``sum_k w_k roll(x, -off_k) + diag * x``
    over the grid's axes (slow -> fast), on any grid and any offsets."""
    xg = x.reshape(op.grid_shape)
    dims = tuple(range(len(op.grid_shape)))
    y = torch.zeros_like(xg)
    for k, off in enumerate(op.offsets):
        # y[c] += w_k x[c + off]  <=>  y += w_k * roll(x, -off)
        y = y + op.weights[k] * torch.roll(xg, shifts=tuple(-o for o in off), dims=dims)
    if op.diag is not None:
        y = y + op.diag.reshape(op.grid_shape) * xg
    return y.reshape(x.shape)


def stencil_spmm_reference(op, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``Y = A X``: the SpMV reference on each column."""
    return torch.stack(
        [stencil_spmv_reference(op, X[:, j]) for j in range(X.shape[1])], dim=1
    )


def _check(op, x: torch.Tensor, shape) -> None:
    if not kernel_supported(op):
        raise ValueError(
            "stencil kernel supports 3D grids with at most "
            f"{MAX_TAPS} taps, offsets in {{-1,0,1}}; got grid "
            f"{op.grid_shape} with offsets {op.offsets}"
        )
    if x.dtype not in _DTYPES:
        raise TypeError(f"stencil kernel takes float32/float64, got {x.dtype}")
    if x.dtype != op.weights.dtype:
        raise TypeError(
            f"operand dtype {x.dtype} != operator dtype {op.weights.dtype}"
        )
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"operand shape {tuple(x.shape)} != {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError("stencil kernel needs a contiguous operand")
    for name, t in (("weights", op.weights), ("diag", op.diag)):
        if t is not None and t.device != x.device:
            raise ValueError(
                f"operator {name} on {t.device}, operand on {x.device}"
            )


def _launch(fn_name: str, op, x: torch.Tensor, b) -> torch.Tensor:
    """Launch ``fn_name`` on x's device and stream; raise on a refused launch."""
    if x.device.type != "cuda":
        raise ValueError(f"stencil kernel runs on CUDA tensors, got {x.device}")
    from ._build import load_stencil_library

    lib, _ = load_stencil_library()
    fn = getattr(lib, f"{fn_name}_{_DTYPES[x.dtype]}")
    nz, ny, nx = op.grid_shape
    k = len(op.offsets)
    offs = (ctypes.c_int * (3 * k))(*(o for off in op.offsets for o in off))
    weights = op.weights.contiguous()
    diag = None if op.diag is None else op.diag.contiguous()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        sizes = (nz, ny, nx) if b is None else (nz, ny, nx, b)
        err = fn(
            x.data_ptr(), None if diag is None else diag.data_ptr(),
            weights.data_ptr(), y.data_ptr(), *sizes, offs, k, stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed with CUDA error {err}")
    return y


def stencil_spmv(op, x: torch.Tensor) -> torch.Tensor:
    """``y = op @ x`` for a StencilOperator and a contiguous (M,) vector."""
    _check(op, x, (op.shape[0],))
    if x.device.type == "cpu":
        return stencil_spmv_reference(op, x)
    y = _launch("stencil_spmv", op, x, None)
    stencil_spmv.launches += 1
    return y


def stencil_spmm(op, X: torch.Tensor) -> torch.Tensor:
    """``Y = op @ X`` for a StencilOperator and a contiguous (M, b) block."""
    if X.ndim != 2:
        raise ValueError(f"stencil_spmm takes an (M, b) block, got {tuple(X.shape)}")
    _check(op, X, (op.shape[0], X.shape[1]))
    if X.device.type == "cpu":
        return stencil_spmm_reference(op, X)
    Y = _launch("stencil_spmm", op, X, X.shape[1])
    stencil_spmm.launches += 1
    return Y


stencil_spmv.launches = 0
stencil_spmm.launches = 0
