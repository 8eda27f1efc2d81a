"""CGS2 reorthogonalization in p + 1 sweeps over the basis: a CUDA kernel
and its plain PyTorch version.

:func:`cgs2` orthogonalizes ``v`` (M,) against the rows of ``V`` (j, M) by
classical Gram-Schmidt run ``passes`` times, ``v <- v - (V v) V`` each pass.
The plain version, :func:`cgs2_reference`, is that loop: two GEMVs a pass,
each reading all of ``V``, so 2p reads of the basis.  On the card the
kernel of ``csrc/cgs2.cu`` reads it p + 1 times: one pass's update and the
next pass's projection share one read of each column tile (see the
source's header for the design and what bounds it).  A basis of more rows
than one tile holds (:func:`max_rows`) is taken in row blocks, 2p reads as
the loop.  It replaces no TPU kernel: the JAX package's CGS2 is plain
matmuls.

Dispatch is by the tensor's device: a CPU tensor goes to the plain
version, a CUDA tensor of float32 or float64 launches the kernel, any
number of rows (a view that is not contiguous is copied first).
``COUNTERS["lt.cgs2.fused"]`` counts the calls that launched the kernel,
incremented after a successful launch and nowhere else (inside a CUDA
graph: the capture, not the replays).
"""

from __future__ import annotations

import functools

import torch

from .._util import COUNTERS
from ._build import launch_on

__all__ = ["cgs2", "cgs2_reference", "max_rows"]

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def cgs2_reference(V: torch.Tensor, v: torch.Tensor, passes: int, basis_dot=None) -> torch.Tensor:
    """Plain PyTorch: ``passes`` CGS passes of ``v`` against the rows of
    ``V``; ``basis_dot(V, v)`` in place of ``V @ v`` where given (a row-sharded
    mesh's all-reduced product)."""
    for _ in range(passes):
        h = V @ v if basis_dot is None else basis_dot(V, v)
        v = v - h @ V
    return v


@functools.lru_cache(maxsize=None)
def _library():
    from ._build import load_cgs2_library

    lib, _ = load_cgs2_library()
    return lib


def max_rows() -> int:
    """The most rows of ``V`` one tile of the kernel holds (both dtypes):
    up to here p passes read ``V`` p + 1 times, beyond it 2p times.  Builds
    the library on first use."""
    return _library().cgs2_max_rows()


@functools.lru_cache(maxsize=None)
def _blocks(index: int) -> int:
    """The kernel's grid on card ``index``: one block per SM."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def cgs2(V: torch.Tensor, v: torch.Tensor, passes: int) -> torch.Tensor:
    """``passes`` CGS passes of ``v`` (M,) against the rows of ``V`` (j, M),
    returned as a new tensor; ``v`` is left as it was."""
    if V.device.type == "cpu":
        return cgs2_reference(V, v, passes)
    if V.dtype not in _DTYPES or v.dtype != V.dtype:
        raise TypeError(f"cgs2 kernel takes float32/float64 V and v of its dtype, got "
                        f"{V.dtype} and {v.dtype}")
    if V.ndim != 2 or v.ndim != 1 or v.shape[0] != V.shape[1] or v.device != V.device:
        raise ValueError(f"cgs2 takes V (j, M) and v (M,) on one device; got V "
                         f"{tuple(V.shape)} on {V.device}, v {tuple(v.shape)} on {v.device}")
    j, m = V.shape
    if j == 0 or passes < 1:
        return v.clone()
    V, v = V.contiguous(), v.contiguous()  # no copy for the solver's V[:j] and v
    blocks = _blocks(V.device.index)
    out = torch.empty_like(v)
    h = torch.empty(j, dtype=v.dtype, device=v.device)
    partial = torch.empty(blocks * j, dtype=v.dtype, device=v.device)
    err = launch_on(
        V.device, getattr(_library(), f"cgs2_{_DTYPES[V.dtype]}"), V.data_ptr(), v.data_ptr(),
        out.data_ptr(), h.data_ptr(), partial.data_ptr(), m, j, passes, blocks,
    )
    if err != 0:
        raise RuntimeError(f"cgs2 launch failed with CUDA error {err}")
    COUNTERS["lt.cgs2.fused"] += 1
    return out
