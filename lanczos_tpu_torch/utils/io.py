"""Result I/O: ``.npy`` eigenpair dumps (counterpart of
``lanczos_tpu/utils/io.py:save_eigpairs``)."""

from __future__ import annotations

import numpy as np

from .._util import to_numpy

__all__ = ["save_eigpairs"]


def save_eigpairs(prefix: str, eigenvalues, eigenvectors) -> None:
    """Write ``<prefix>_eigvals.npy`` and ``<prefix>_eigvecs.npy``."""
    np.save(prefix + "_eigvals.npy", to_numpy(eigenvalues))
    np.save(prefix + "_eigvecs.npy", to_numpy(eigenvectors))
