"""Fused interface classes of CompositeV2: a CUDA kernel and its plain version.

Counterpart of ``lanczos_tpu/ops/interface_kernel.py``:

* :class:`FusedInterface` holds, as buffers, the tables the CUDA kernel
  reads, built once with the operator straight from its static geometry
  (``grid_meta``): every interface class, at any stride.
* :func:`apply_fused_interface` replaces the Pallas kernel of the same name:
  it adds every class's weighted tap sum into ``y``, in place, with one
  launch of ``csrc/interface.cu`` (rows of all classes packed densely, a
  group of lanes per row splitting its taps; see the source's header for
  the design and what bounds it).
* :func:`apply_fused_interface_reference` is the plain PyTorch version:
  strided slices of the level regions, summed in tap order, added in place.
* :class:`InterfacePlan` and :func:`plan_interface_kernel` are the JAX
  package's plan (phase-split operands and a fallback split for strides
  outside {1, 2}, both answers to Mosaic's stride limit), ported so the
  two packages' plans can be compared and converted.  The kernel does not
  read it.  The JAX plan's VMEM budget (``LANCZOS_IFACE_VMEM_MB``) is not
  carried over.

Dispatch is by the tensor's device only: a CPU tensor goes to the plain
version, a CUDA tensor launches the kernel or raises.  There is no fallback
and no switch.  ``apply_fused_interface.launches`` counts launches,
incremented after a successful launch and nowhere else
(``launches_by_dtype`` splits it by dtype).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
from torch import nn

from .._util import as_torch_dtype
from ._build import launch_on

__all__ = [
    "InterfacePlan",
    "FusedInterface",
    "plan_interface_kernel",
    "class_windows",
    "apply_fused_interface",
    "apply_fused_interface_reference",
]

#: int32 fields of a class in ``FusedInterface.cls`` (three int4 loads).
CLASS_FIELDS = 12

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


@dataclasses.dataclass(frozen=True)
class InterfacePlan:
    """Hashable fused-interface plan (the JAX package's, field for field).

    operands: ((level, (s0,s1,s2), (p0,p1,p2), shape), ...) — phase-split
        views ``x3[level][p0::s0, p1::s1, p2::s2]`` of the level regions.
    out_operands: ((row_level, (s0,s1,s2), (p0,p1,p2), shape), ...) —
        phase-split views of the per-level OUTPUT regions.
    classes:  ((out_idx, out_off, acc_shape, taps), ...) with taps
        ((operand_idx, start3, weight), ...); each tap reads its operand at
        ``start3 : start3 + acc_shape`` and the class adds into
        ``out_operands[out_idx]`` at ``out_off : out_off + acc_shape``.
    fallback: indices into the operator's grid_meta for classes the Pallas
        kernel does not cover.
    """

    operands: Tuple
    out_operands: Tuple
    classes: Tuple
    fallback: Tuple


def plan_interface_kernel(grid_meta, level_meta, grid_w_host) -> InterfacePlan:
    """Build the fused plan from CompositeV2 static geometry + host weights."""
    op_index = {}
    operands = []
    out_index = {}
    out_operands = []
    classes = []
    fallback = []
    exts = {i: ext for i, (a, ext, st) in enumerate(level_meta)}
    for ci, (row_level, out_start, interior, acc_shape, taps) in enumerate(grid_meta):
        w = np.asarray(grid_w_host[ci], np.float64)
        out_step = tuple(int(i) + 1 for i in interior)
        if any(s not in (1, 2) for s in out_step):
            fallback.append(ci)
            continue
        ktaps = []
        ok = True
        for t, (src_level, start, limit, stride) in enumerate(taps):
            if any(s not in (1, 2) for s in stride):
                ok = False
                break
            par = tuple(int(start[ax] % stride[ax]) for ax in range(3))
            key = (src_level, tuple(stride), par)
            if key not in op_index:
                ext = exts[src_level]
                shape = tuple(
                    (ext[ax] - par[ax] + stride[ax] - 1) // stride[ax] for ax in range(3)
                )
                op_index[key] = len(operands)
                operands.append((src_level, tuple(stride), par, shape))
            st_op = tuple((start[ax] - par[ax]) // stride[ax] for ax in range(3))
            ktaps.append((op_index[key], st_op, float(w[t])))
        if not ok:
            fallback.append(ci)
            continue
        out_par = tuple(int(out_start[ax] % out_step[ax]) for ax in range(3))
        okey = (row_level, out_step, out_par)
        if okey not in out_index:
            ext = exts[row_level]
            shape = tuple(
                (ext[ax] - out_par[ax] + out_step[ax] - 1) // out_step[ax]
                for ax in range(3)
            )
            out_index[okey] = len(out_operands)
            out_operands.append((row_level, out_step, out_par, shape))
        out_off = tuple(int(out_start[ax] // out_step[ax]) for ax in range(3))
        oshape = out_operands[out_index[okey]][3]
        assert all(
            out_off[ax] + acc_shape[ax] <= oshape[ax] for ax in range(3)
        ), (out_off, acc_shape, oshape)
        classes.append((out_index[okey], out_off, tuple(acc_shape), tuple(ktaps)))
    return InterfacePlan(
        operands=tuple(operands),
        out_operands=tuple(out_operands),
        classes=tuple(classes),
        fallback=tuple(fallback),
    )


def class_windows(grid_meta, level_meta):
    """Per class of ``grid_meta``: (row_base, (ny, nx), out_start (3),
    step (3), acc_shape, taps as (src_base, (ny, nx), start (3), stride
    (3))), in absolute level-region coordinates."""
    out = []
    for row_level, out_start, interior, acc_shape, taps in grid_meta:
        _, ext, base = level_meta[row_level]
        ktaps = []
        for src_level, start, _, stride in taps:
            _, sext, sbase = level_meta[src_level]
            ktaps.append((sbase, tuple(sext[1:]), tuple(start), tuple(stride)))
        step = tuple(int(i) + 1 for i in interior)
        out.append((base, tuple(ext[1:]), tuple(out_start), step, tuple(acc_shape), ktaps))
    return out


def _linear_form(base, ny, nx, start, step):
    """(q0, Z, Y, X) with ``q0 + Z*iz + Y*iy + X*ix`` the flat slot of
    window point (iz, iy, ix): ``base + ((start + step*i) . (ny*nx, nx, 1))``."""
    return (
        base + (start[0] * ny + start[1]) * nx + start[2],
        step[0] * ny * nx,
        step[1] * nx,
        step[2],
    )


class FusedInterface(nn.Module):
    """Every strided interface class of an operator, as the CUDA kernel's
    tables (buffers, built once with the operator).

    The layout is the one described in ``csrc/interface.cu``: ``cls`` (C,
    12) int32 holds each class's packed-row range, window shape and output
    linear form; ``taps`` (T, 4) int32 each tap's linear form ``(q0, Z, Y,
    X)``; ``row_class`` (R,) int32 the class of each packed row (a class's
    rows contiguous, classes in ``grid_meta`` order); ``tap_w`` (T,) the
    classes' tap weights, class after class, in the operator's dtype.  A
    CUDA thread reads at any stride, so every class of ``grid_meta`` is in
    the tables: none is left to another path.  Building them checks on the
    host that every address fits in int32 and that no two classes write the
    same slot, so the kernel runs without atomics.
    """

    def __init__(self, grid_meta, level_meta, grid_w, dtype, device):
        super().__init__()
        self.grid_meta = tuple(grid_meta)
        self.level_meta = tuple(level_meta)
        m = sum(int(np.prod(ext)) for _, ext, _ in level_meta)
        if m >= 2**31:
            raise ValueError(f"operator of {m} slots exceeds the kernel's int32 tables")
        self.num_slots = m
        cls_rows, tap_rows, tap_acc, row_class, slots = [], [], [], [], []
        for c, (base, (ny, nx), o3, step, acc, ktaps) in enumerate(
            class_windows(grid_meta, level_meta)
        ):
            rows = int(np.prod(acc))
            out = _linear_form(base, ny, nx, o3, step)
            t0 = len(tap_rows)
            for sbase, (sny, snx), s3, stride in ktaps:
                tap_rows.append(_linear_form(sbase, sny, snx, s3, stride))
            tap_acc.extend([acc] * len(ktaps))
            cls_rows.append([len(row_class), acc[1] * acc[2], acc[2], t0,
                             len(tap_rows), *out, 0, 0, 0])
            row_class.extend([c] * rows)
            iz, iy, ix = (a.reshape(-1) for a in np.meshgrid(
                *(np.arange(a) for a in acc), indexing="ij"))
            slots.append(out[0] + out[1] * iz + out[2] * iy + out[3] * ix)
        forms = np.asarray(tap_rows + [row[5:9] for row in cls_rows], np.int64).reshape(-1, 4)
        last = np.asarray(tap_acc + [g[3] for g in self.grid_meta], np.int64).reshape(-1, 3) - 1
        if len(forms) and not (
            forms.min() >= 0 and (forms[:, 0] + (forms[:, 1:] * last).sum(axis=1)).max() < m
        ):
            raise ValueError("an interface tap or output window leaves the operator's slots")
        if slots:
            slots = np.concatenate(slots)
            if len(np.unique(slots)) != len(slots):
                raise AssertionError(
                    "interface classes write overlapping output slots; the "
                    "kernel has one writer per slot and would race"
                )
        self.num_rows = len(row_class)
        self.num_taps = len(tap_rows)
        self._tap_counts = tuple(len(taps) for *_, taps in self.grid_meta)

        def table(rows, width):
            a = np.asarray(rows, dtype=np.int64).reshape(-1, width)
            return torch.as_tensor(a, dtype=torch.int32, device=device)

        self.register_buffer("cls", table(cls_rows, CLASS_FIELDS))
        self.register_buffer("taps", table(tap_rows, 4))
        self.register_buffer("row_class", table(row_class, 1).reshape(-1))
        w = [torch.as_tensor(v, dtype=as_torch_dtype(dtype), device=device) for v in grid_w]
        self.register_buffer(
            "tap_w", torch.cat(w) if w else torch.zeros(0, dtype=as_torch_dtype(dtype), device=device)
        )
        if self.tap_w.shape[0] != self.num_taps:
            raise ValueError(f"{self.tap_w.shape[0]} tap weights for {self.num_taps} taps")

    @property
    def grid_w(self) -> Tuple[torch.Tensor, ...]:
        """Each class's tap weights: views into ``tap_w``."""
        return tuple(torch.split(self.tap_w, self._tap_counts))

    @property
    def tap_reads(self) -> int:
        """Tap reads of one application: sum over classes of rows x taps."""
        return int(sum(np.prod(acc) * len(taps) for *_, acc, taps in self.grid_meta))


def _level_views(t: torch.Tensor, level_meta):
    """Per-level 3D views (z, y, x[, b]) of a flat region-native tensor."""
    out = []
    for _, ext, start in level_meta:
        vol = int(np.prod(ext))
        out.append(t[start:start + vol].reshape(*ext, *t.shape[1:]))
    return out


def _window(start, step, shape):
    """Slices selecting ``start + step * i`` for i in range(shape), per axis."""
    return tuple(
        slice(s, s + st * (n - 1) + 1, st) for s, st, n in zip(start, step, shape)
    )


def apply_fused_interface_reference(fi: FusedInterface, x: torch.Tensor, y: torch.Tensor):
    """Plain PyTorch: add every class's contribution into ``y`` in place
    and return it.  ``x``/``y`` are flat (M,) vectors or (M, b) blocks in
    the operator's region-native layout."""
    x3 = _level_views(x, fi.level_meta)
    y3 = _level_views(y, fi.level_meta)
    for (row_level, out_start, interior, acc_shape, taps), w in zip(fi.grid_meta, fi.grid_w):
        acc = None
        for t, (src_level, start, _, stride) in enumerate(taps):
            term = w[t] * x3[src_level][_window(start, stride, acc_shape)]
            acc = term if acc is None else acc + term
        step = tuple(i + 1 for i in interior)
        y3[row_level][_window(out_start, step, acc_shape)] += acc
    return y


def _check(fi: FusedInterface, x: torch.Tensor, y: torch.Tensor) -> None:
    if x.ndim not in (1, 2) or x.shape[0] != fi.num_slots or x.shape != y.shape:
        raise ValueError(
            f"interface kernel takes (M,) or (M, b) x and y with M={fi.num_slots}, got "
            f"{tuple(x.shape)} and {tuple(y.shape)}"
        )
    if x.dtype not in _DTYPES or y.dtype != x.dtype or fi.tap_w.dtype != x.dtype:
        raise TypeError(
            f"interface kernel takes float32/float64 operands of the operator's "
            f"dtype {fi.tap_w.dtype}, got {x.dtype} and {y.dtype}"
        )
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("interface kernel needs contiguous operands")
    if not (x.device == y.device == fi.tap_w.device):
        raise ValueError(
            f"operator tables on {fi.tap_w.device}, x on {x.device}, y on {y.device}"
        )


@functools.lru_cache(maxsize=None)
def _kernels():
    """{dtype: C launcher} of ``csrc/interface.cu``, built and loaded once.
    The tables do not depend on the kernel's block geometry."""
    from ._build import load_interface_library

    lib, _ = load_interface_library()
    return {dt: getattr(lib, f"fused_interface_{tag}") for dt, tag in _DTYPES.items()}


def apply_fused_interface(fi: FusedInterface, x: torch.Tensor, y: torch.Tensor):
    """Add every class's contribution into ``y`` in place (flat (M,)
    vectors or row-major (M, b) blocks) and return ``y``."""
    _check(fi, x, y)
    if x.device.type == "cpu":
        return apply_fused_interface_reference(fi, x, y)
    if x.device.type != "cuda":
        raise ValueError(f"interface kernel runs on CUDA tensors, got {x.device}")
    if fi.num_rows == 0:
        return y
    err = launch_on(
        x.device, _kernels()[x.dtype], x.data_ptr(), y.data_ptr(),
        1 if x.ndim == 1 else x.shape[1], fi.num_rows, fi.cls.data_ptr(),
        fi.taps.data_ptr(), fi.tap_w.data_ptr(), fi.row_class.data_ptr(),
    )
    if err != 0:
        raise RuntimeError(f"fused_interface launch failed with CUDA error {err}")
    apply_fused_interface.launches += 1
    apply_fused_interface.launches_by_dtype[x.dtype] += 1
    return y


apply_fused_interface.launches = 0
apply_fused_interface.launches_by_dtype = dict.fromkeys(_DTYPES, 0)
