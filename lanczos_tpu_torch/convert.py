"""Carry objects of the JAX package across to the port.

:func:`from_jax` turns a ``lanczos_tpu`` StencilOperator, EllOperator,
DenseOperator, CompositeV2 (with its transpose), v1 CompositeOperator,
EllHaloOperator (one rank's part, given the port's row mesh),
InterfacePlan, IrregularLattice, LanczosFactorization,
BlockLanczosFactorization or LookAheadFactorization into the port's
counterpart, so both packages can compute with identical operators and
states.  It reads attributes through ``np.asarray`` and never imports
``jax`` itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._util import DEFAULT_DEVICE, as_torch_dtype
from .models.lattice import IrregularLattice
from .ops.composite import CompositeOperator, LevelBlock
from .ops.composite2 import CompositeV2
from .ops.interface_kernel import InterfacePlan
from .ops.operators import DenseOperator, EllOperator, StencilOperator
from .solver.block import BlockLanczosFactorization
from .solver.lanczos import LanczosFactorization
from .solver.look_ahead import LookAheadFactorization

__all__ = ["from_jax"]


def from_jax(obj, *, device=DEFAULT_DEVICE, dtype=None, mesh=None):
    """The port's counterpart of a ``lanczos_tpu`` object, on ``device``.

    Floating arrays are converted to ``dtype`` (default: their own).  An
    EllHaloOperator needs ``mesh`` (``parallel/mesh.py:RowMesh``, of as
    many ranks as the JAX operator's devices): the result is this rank's
    rows, on the mesh's device.
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
    if kind == "InterfacePlan":
        return InterfacePlan(
            operands=obj.operands, out_operands=obj.out_operands,
            classes=obj.classes, fallback=obj.fallback,
        )
    if kind == "IrregularLattice":
        # Host numpy arrays on both sides: the fields carry over as they are.
        return IrregularLattice(
            **{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
        )
    if kind == "CompositeV2":
        # The port always applies every class with its interface kernel,
        # whether or not the JAX operator carries a fused plan.
        level_ops = [from_jax(op, device=device, dtype=dtype) for op in obj.level_ops]
        return CompositeV2(
            diag=t(obj.diag), keep=t(obj.keep), live=t(obj.live),
            level_ops=level_ops,
            grid_w=[t(w) for w in obj.grid_w],
            ifc_buckets=[
                (t(r, torch.int64), t(i, torch.int64), t(w))
                for r, i, w in obj.ifc_buckets
            ],
            level_meta=obj.level_meta, grid_meta=obj.grid_meta,
            symmetric=obj.symmetric,
            transpose_op=None if obj.transpose_op is None
            else from_jax(obj.transpose_op, device=device, dtype=dtype),
        )
    if kind == "CompositeOperator":
        levels = [
            LevelBlock(t(lv.adjacency, torch.int64), t(lv.weights), lv.start, lv.nbox, lv.m)
            for lv in obj.levels
        ]
        return CompositeOperator(
            diag=t(obj.diag), levels=levels, ifc_rows=t(obj.ifc_rows, torch.int64),
            ifc_cols=t(obj.ifc_cols, torch.int64), ifc_vals=t(obj.ifc_vals),
            ifc_buckets=[
                (t(r, torch.int64), t(i, torch.int64), t(w)) for r, i, w in obj.ifc_buckets
            ],
        )
    if kind == "EllHaloOperator":
        from .parallel.distributed import EllHaloOperator

        if mesh is None or mesh.size != obj.export_ids.shape[0]:
            raise ValueError("an EllHaloOperator needs the row mesh of its device count")
        m = obj.cols.shape[0]
        rows = slice(mesh.rank * (m // mesh.size), (mesh.rank + 1) * (m // mesh.size))
        cols, vals = np.array(obj.cols)[rows], np.array(obj.vals)[rows]
        return EllHaloOperator(
            cols=torch.as_tensor(cols, dtype=torch.int64, device=mesh.device),
            vals=torch.as_tensor(vals, device=mesh.device,
                                 dtype=None if dtype is None else as_torch_dtype(dtype)),
            export_ids=torch.as_tensor(np.array(obj.export_ids), dtype=torch.int64,
                                       device=mesh.device),
            mesh=mesh, m=m,
        )
    if kind == "LanczosFactorization":
        return LanczosFactorization(
            alpha=t(obj.alpha), beta=t(obj.beta), V=t(obj.V), resid=t(obj.resid),
            breakdown_iter=t(obj.breakdown_iter, torch.int64),
        )
    if kind == "BlockLanczosFactorization":
        return BlockLanczosFactorization(
            a_blocks=t(obj.a_blocks), b_blocks=t(obj.b_blocks), Q=t(obj.Q),
            resid_block=t(obj.resid_block),
        )
    if kind == "LookAheadFactorization":
        # The port keeps the bases in float64 whatever ``dtype`` says.
        return LookAheadFactorization(
            V=t(obj.V, torch.float64), W=t(obj.W, torch.float64), AV=t(obj.AV, torch.float64),
            blocks=tuple(tuple(int(i) for i in blk) for blk in obj.blocks),
            incurable=bool(obj.incurable), max_block_used=int(obj.max_block_used),
        )
    raise TypeError(f"no port counterpart for lanczos_tpu {kind}")
