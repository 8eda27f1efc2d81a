"""Stencil SpMV / SpMM: CUDA kernels for Hopper and their plain PyTorch versions.

Counterpart of ``lanczos_tpu/ops/pallas_kernels.py``:

* :func:`stencil_spmv` replaces ``stencil_spmv_pallas`` (``_spmv_impl`` ->
  ``_build_call``), ``y = A x`` for a periodic 3D stencil operator.
* :func:`stencil_spmm` replaces ``stencil_spmm_pallas`` (``_spmm_impl``),
  ``Y = A X`` for a row-major ``(M, b)`` block, in one launch.

Both kernels live in ``csrc/stencil.cu`` (built by ``ops/_build.py``).  What
bounds them on the H100 is bytes: the compulsory traffic is a read of x, a
read of diag and a write of y, 12 B/point in fp32 for the SpMV, 8b + 4
B/point for the SpMM.  Both march along z with a shared-memory plane ring:
the SpMV's blocks own a 32 x 8 tile of the (y, x) plane over a chunk of
planes that :func:`spmv_z_chunk` picks from the grid and the card's
resident blocks; the SpMM treats the (M, b) block as a grid (nz, ny, nx*b)
whose x-taps step by b, with the tile of :func:`spmm_tile` (all b columns
of each point, or sector-aligned column chunks when b is wide) and the
chunk of :func:`spmm_z_chunk` (see the source's header).  The TPU kernel's
slab/halo/flat-plane layout and its one call per column are not carried
over.

Dispatch is by the tensor's device only: a CPU tensor goes to the plain
version (``*_reference``: a sum of ``torch.roll``s over the taps plus the
diagonal), a CUDA tensor launches the kernel or raises.  There is no
fallback and no switch.  Each wrapper counts its kernel launches in
``<wrapper>.launches``, incremented where the kernel is launched and
nowhere else, so a run can show that its main path went through the kernel;
``<wrapper>.launches_by_dtype`` splits the same count by dtype.
What a launch needs from the operator (the dense weights, and per dtype,
device and width the tile and z-chunk) is kept on the operator and renewed
when its weights or diag change.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import launch_on

__all__ = [
    "MAX_TAPS",
    "kernel_supported",
    "stencil_spmv",
    "stencil_spmm",
    "stencil_spmv_reference",
    "stencil_spmm_reference",
    "z_chunk",
    "spmv_z_chunk",
    "spmm_tile",
    "spmm_z_chunk",
]

#: Taps the CUDA kernel takes (kMaxTaps in csrc/stencil.cu): the full
#: {-1,0,1}^3 neighbourhood.
MAX_TAPS = 27

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}

#: The SpMV's tile of the (y, x) plane (kTY x kTX in csrc/stencil.cu),
#: checked against the library when it loads.
TILE_Y, TILE_X = 8, 32

#: The SpMM's tile (:func:`spmm_tile`): rows of the (y, x) plane, the bytes
#: of outputs a tile row aims at, its least and most points along x, and
#: the DRAM sector that a column chunk's width is a multiple of.
SPMM_TILE_Y = 8
SPMM_ROW_BYTES = 640
SPMM_MIN_TILE_X, SPMM_MAX_TILE_X = 4, 32
SECTOR_BYTES = 32
#: Outputs per thread of the SpMM (kSpmmOutputs), checked when the library
#: loads.
SPMM_OUTPUTS = 4


class _OpCache:
    """What the kernels need from one operator, worked out from its
    geometry, weights and diag: whether the kernels cover it, the 27 dense
    weights on the host (duplicate offsets summed), and each kernel's launch
    arguments per dtype, device and width (``_launch_args``).  It holds the
    weights and diag tensors themselves and their versions, so a replaced
    or modified tensor is noticed whatever address it has (:func:`_cache`)."""

    __slots__ = ("grid_shape", "offsets", "weights", "diag", "versions", "supported",
                 "w27", "launches")

    def __init__(self, op):
        self.grid_shape, self.offsets = op.grid_shape, op.offsets
        self.weights, self.diag = op.weights, op.diag
        self.versions = _versions(op)
        self.supported = (
            len(op.grid_shape) == 3
            and len(op.offsets) <= MAX_TAPS
            and all(all(abs(o) <= 1 for o in off) for off in op.offsets)
        )
        dense = [0.0] * MAX_TAPS
        if self.supported:
            for (dz, dy, dx), wk in zip(op.offsets, op.weights.tolist()):
                dense[(dz + 1) * 9 + (dy + 1) * 3 + dx + 1] += wk
        self.w27 = (ctypes.c_double * MAX_TAPS)(*dense)
        self.launches = {}

    def describes(self, op) -> bool:
        return (self.offsets is op.offsets and self.grid_shape is op.grid_shape
                and self.weights is op.weights and self.diag is op.diag
                and self.versions == _versions(op))


def _versions(op):
    return (op.weights._version, None if op.diag is None else op.diag._version)


def _cache(op) -> _OpCache:
    """``op``'s kernel cache, rebuilt when its geometry, weights or diag
    changed.  StencilOperator builds it with the operator, so the host read
    of the weights (a sync on a card) happens then, not at the first launch."""
    c = op.__dict__.get("_stencil_kernel_cache")
    if c is None or not c.describes(op):
        c = op.__dict__["_stencil_kernel_cache"] = _OpCache(op)
    return c


def kernel_supported(op) -> bool:
    """True when the CUDA kernel covers ``op``: a 3D grid with at most
    MAX_TAPS taps, every offset in {-1,0,1}^3 (the Pallas kernel's domain,
    ``pallas_kernels.py:_prep``)."""
    return _cache(op).supported


def z_chunk(nz: int, blocks_per_plane: int, resident_blocks: int) -> int:
    """Output planes per block of a z-march over nz planes whose blocks
    tile each plane ``blocks_per_plane`` times, for a card that holds
    ``resident_blocks`` of them at once.

    Each block of a chunk of zc planes reads zc + 2 input planes, and the
    blocks run in waves of ``resident_blocks``; the chunk minimises (waves)
    x (zc + 2), preferring fewer, longer chunks on a tie.  Small grids get
    short chunks (down to one plane) so that they still fill the card.
    """
    best = None
    for n in range(1, nz + 1):
        zc = -(-nz // n)
        cost = -(-blocks_per_plane * -(-nz // zc) // max(resident_blocks, 1)) * (zc + 2)
        if best is None or cost < best[0]:
            best = (cost, zc)
    return best[1]


def spmv_z_chunk(grid_shape, resident_blocks: int) -> int:
    """:func:`z_chunk` of the SpMV (32 x 8 tiles) on a (nz, ny, nx) grid."""
    nz, ny, nx = grid_shape
    return z_chunk(nz, -(-nx // TILE_X) * -(-ny // TILE_Y), resident_blocks)


def spmm_tile(b: int, elem_bytes: int):
    """(ty, tx, cb) of the SpMM for an (M, b) block of ``elem_bytes``
    elements: ty x tx points of the (y, x) plane, cb columns of each.

    A tile row aims at SPMM_ROW_BYTES of outputs (tx * b * elem_bytes), with
    4 to 32 points along x: 8 x 8 points at b = 20 in fp32, 8 x 20 at b = 8,
    8 x 32 at b <= 5.  When even 4 points of all b columns overrun the row,
    the columns are split into chunks of cb, the widest multiple of a
    32-byte sector that 4 points hold (40 columns in fp32, 20 in fp64), so
    that blocks of neighbouring chunks never share a sector."""
    row = SPMM_ROW_BYTES // elem_bytes
    if b * SPMM_MIN_TILE_X <= row:
        return SPMM_TILE_Y, min(SPMM_MAX_TILE_X, row // b), b
    sector = SECTOR_BYTES // elem_bytes
    return SPMM_TILE_Y, SPMM_MIN_TILE_X, row // SPMM_MIN_TILE_X // sector * sector


def spmm_z_chunk(grid_shape, b: int, tile, resident_blocks: int) -> int:
    """:func:`z_chunk` of the SpMM with ``tile`` (:func:`spmm_tile`) for an
    (M, b) block on a (nz, ny, nx) grid: a plane takes one block per tile
    and column chunk."""
    nz, ny, nx = grid_shape
    ty, tx, cb = tile
    return z_chunk(nz, -(-nx // tx) * -(-ny // ty) * -(-b // cb), resident_blocks)


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


@functools.lru_cache(maxsize=None)
def _library():
    """``csrc/stencil.cu``'s library, built and loaded once; its SpMV tile
    and SpMM outputs per thread are checked against the host's here, not
    per launch."""
    from ._build import load_stencil_library

    lib, _ = load_stencil_library()
    tile = (lib.stencil_spmv_tile_y(), lib.stencil_spmv_tile_x())
    if tile != (TILE_Y, TILE_X):
        raise RuntimeError(f"csrc/stencil.cu tiles the plane {tile}, the host expects "
                           f"{(TILE_Y, TILE_X)}")
    if lib.stencil_spmm_outputs_per_thread() != SPMM_OUTPUTS:
        raise RuntimeError("csrc/stencil.cu's SpMM gives each thread "
                           f"{lib.stencil_spmm_outputs_per_thread()} outputs, the host "
                           f"expects {SPMM_OUTPUTS}")
    return lib


@functools.lru_cache(maxsize=None)
def _resident_blocks(query: str, device_index: int, *args) -> int:
    """Blocks of a kernel that the card holds at once (SMs x blocks per SM):
    the library's occupancy query ``query(*args)`` (``stencil_spmv_resident_*``
    or, for an SpMM launch's width, tile and diag, ``stencil_spmm_resident_*``),
    asked once per device and arguments."""
    with torch.cuda.device(device_index):
        n = getattr(_library(), query)(*args)
    if n <= 0:
        raise RuntimeError(f"{query} failed with CUDA error {-n}")
    return n


def _launch_args(name: str, op, x: torch.Tensor):
    """(C launcher, diag, kernel arguments) of kernel ``name`` for ``op`` on
    x's dtype and device: the SpMV's z-chunk, the SpMM's tile and z-chunk
    for x's width, and the dense host weights.  Kept in the operator's
    cache, which a change of weights or diag renews."""
    cache = _cache(op)
    b = x.shape[1] if name == "stencil_spmm" else None
    key = (name, x.dtype, x.device, b)
    hit = cache.launches.get(key)
    if hit is not None:
        return hit
    tag = _DTYPES[x.dtype]
    fn = getattr(_library(), f"{name}_{tag}")
    diag = None if op.diag is None else op.diag.contiguous()
    dev = x.device.index
    if name == "stencil_spmv":
        zc = spmv_z_chunk(op.grid_shape, _resident_blocks(f"stencil_spmv_resident_{tag}", dev))
        args = (fn, diag, (zc, cache.w27))
    else:
        tile = spmm_tile(b, x.element_size())
        resident = _resident_blocks(f"stencil_spmm_resident_{tag}", dev, b, *tile,
                                    int(diag is not None))
        args = (fn, diag, (b, *tile, spmm_z_chunk(op.grid_shape, b, tile, resident), cache.w27))
    cache.launches[key] = args
    return args


def _launch(name: str, op, x: torch.Tensor) -> torch.Tensor:
    """Launch kernel ``name`` on x's device and stream; raise on a refused
    launch."""
    if x.device.type != "cuda":
        raise ValueError(f"stencil kernel runs on CUDA tensors, got {x.device}")
    fn, diag, extra = _launch_args(name, op, x)
    y = torch.empty_like(x)
    d = None if diag is None else diag.data_ptr()
    err = launch_on(x.device, fn, x.data_ptr(), d, y.data_ptr(), *op.grid_shape, *extra)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    return y


def stencil_spmv(op, x: torch.Tensor) -> torch.Tensor:
    """``y = op @ x`` for a StencilOperator and a contiguous (M,) vector."""
    _check(op, x, (op.shape[0],))
    if x.device.type == "cpu":
        return stencil_spmv_reference(op, x)
    y = _launch("stencil_spmv", op, x)
    stencil_spmv.launches += 1
    stencil_spmv.launches_by_dtype[x.dtype] += 1
    return y


def stencil_spmm(op, X: torch.Tensor) -> torch.Tensor:
    """``Y = op @ X`` for a StencilOperator and a contiguous (M, b) block."""
    if X.ndim != 2:
        raise ValueError(f"stencil_spmm takes an (M, b) block, got {tuple(X.shape)}")
    _check(op, X, (op.shape[0], X.shape[1]))
    if X.device.type == "cpu":
        return stencil_spmm_reference(op, X)
    Y = _launch("stencil_spmm", op, X)
    stencil_spmm.launches += 1
    stencil_spmm.launches_by_dtype[X.dtype] += 1
    return Y


stencil_spmv.launches = 0
stencil_spmm.launches = 0
stencil_spmv.launches_by_dtype = dict.fromkeys(_DTYPES, 0)
stencil_spmm.launches_by_dtype = dict.fromkeys(_DTYPES, 0)
