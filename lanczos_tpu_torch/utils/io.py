"""Operator and result I/O: ``.npz`` caching of ELL operators, ``.npy``
eigenpair dumps and the Mathematica ``.dat`` export (counterpart of
``lanczos_tpu/utils/io.py``).

  * ``.npz`` caching of assembled operators, keyed by a path (the
    reference's T-matrix cache, Regular/Hamiltonian.py:48-69);
  * ``.npy`` eigenpair dumps (3Ddeuteron.py:99-100);
  * the COO export in Mathematica syntax (MatrixWrite.py:37-62).

The files are the JAX package's: either package reads what the other
writes.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .._util import DEFAULT_DEVICE, to_numpy
from ..ops.operators import EllOperator

__all__ = [
    "save_ell",
    "load_ell",
    "cached_ell",
    "save_eigpairs",
    "export_mathematica",
]


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_ell(path: str, op: EllOperator) -> None:
    """Write ``op``'s ``cols`` and ``vals`` to ``path`` (``.npz`` appended
    when missing)."""
    np.savez_compressed(_npz(path), cols=to_numpy(op.cols), vals=to_numpy(op.vals))


def load_ell(path: str, *, device=DEFAULT_DEVICE) -> EllOperator:
    """The EllOperator saved at ``path``, on ``device``."""
    with np.load(path) as z:
        return EllOperator(
            cols=torch.as_tensor(z["cols"], device=device),
            vals=torch.as_tensor(z["vals"], device=device),
        )


def cached_ell(path: str, builder, *, device=DEFAULT_DEVICE) -> EllOperator:
    """Load the operator from ``path`` onto ``device`` if the file exists,
    else call ``builder()`` and save what it returns."""
    real = _npz(path)
    if os.path.exists(real):
        return load_ell(real, device=device)
    op = builder()
    os.makedirs(os.path.dirname(real) or ".", exist_ok=True)
    save_ell(real, op)
    return op


def save_eigpairs(prefix: str, eigenvalues, eigenvectors) -> None:
    """Write ``<prefix>_eigvals.npy`` and ``<prefix>_eigvecs.npy``."""
    np.save(prefix + "_eigvals.npy", to_numpy(eigenvalues))
    np.save(prefix + "_eigvecs.npy", to_numpy(eigenvectors))


def export_mathematica(
    path: str,
    op: EllOperator,
    *,
    ndim: int = 3,
    length: float = 25.0,
    potential_name: str = "Deuteron",
    shape: Optional[int] = None,
) -> None:
    """COO triplet export in the reference's Mathematica syntax
    (MatrixWrite.py:37-60):

        numd = d; nrpoints = nnz; box = {L, L, L};
        potential = "name"; H = {{M, M}, { {row, col, val},\\n ... }};

    with values printed to 17 decimal places, as the reference does.
    """
    coo = op.to_scipy().tocoo()
    m = coo.shape[0] if shape is None else shape
    lines = [
        f"numd = {ndim:d};",
        f"nrpoints = {coo.nnz:d};",
        f"box = {{{length:g}, {length:g}, {length:g}}};",
        f'potential = "{potential_name}";',
        f"H = {{{{{m:d}, {m:d}}}, {{",
    ]
    body = "".join(
        f"{{{r}, {c}, {v:.17f}}},\n" for r, c, v in zip(coo.row, coo.col, coo.data)
    )
    with open(path, "w") as f:
        f.write("\n".join(lines))
        f.write(body)
        f.write("}};")
