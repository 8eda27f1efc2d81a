"""The port's native (C++) lattice graph-builder and ELL packer, loaded
with ctypes.

Counterpart of ``lanczos_tpu/native``.  The port
keeps its own copy of the C++ source (``neighbor_engine.cpp``) and builds it
with the host C++ compiler at first use into ``lanczos_tpu_torch/_build/``
(gitignored), keyed by a hash of the source and flags.  Builders serialise
on an ``fcntl`` lock, as the CUDA kernels do (``ops/_build.py``).  This is
host code, not a device kernel: when no compiler is present,
``find_neighbors(backend="auto")`` takes the numpy path, as in the JAX
package, and ``ops/assemble.py:ell_from_coo`` packs with numpy.

Public surface:
    available()            -> bool: the engine is built and loaded
    find_neighbors_native  -> backend for models.lattice.find_neighbors
    reciprocal_mask_native -> edge reciprocity of a neighbor table
    pack_ell_native        -> the packing loop of ops.assemble.ell_from_coo
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "find_neighbors_native", "pack_ell_native", "reciprocal_mask_native"]

_SRC = Path(__file__).resolve().with_name("neighbor_engine.cpp")
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_F64 = ctypes.POINTER(ctypes.c_double)


def _build() -> Optional[Path]:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    lib = _BUILD_DIR / f"neighbor_engine_{digest}.so"
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / ".neighbor_engine.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.is_file():
            return lib
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(
                ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True, timeout=120,
            )
        except (subprocess.SubprocessError, OSError):
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> Optional[ctypes.CDLL]:
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    common = [_I64, _I64, _I32, _I64, ctypes.c_int64, ctypes.c_int64,
              _I64, ctypes.c_int64, ctypes.c_int64]
    lib.count_neighbors.argtypes = common + [_I64]
    lib.count_neighbors.restype = None
    lib.fill_neighbors.argtypes = common + [ctypes.c_int64, _I64, _I64]
    lib.fill_neighbors.restype = None
    lib.reciprocal_mask.argtypes = [_I64, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_uint8)]
    lib.reciprocal_mask.restype = None
    lib.pack_ell.argtypes = [_I64, _I64, _F64, ctypes.c_int64, ctypes.c_int64,
                             ctypes.c_int64, _I64, _F64]
    lib.pack_ell.restype = None
    return lib


def available() -> bool:
    """True when the native engine can be (or has been) built and loaded."""
    return _lib() is not None


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ty)


def find_neighbors_native(
    lat, d: int, idx: Optional[np.ndarray] = None
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native neighbor search; None when the engine is unavailable.

    Same contract as models.lattice.find_neighbors: (nbrs (Q, K) padded -1,
    rels (Q, K, 3)), K = the true max degree over the query.
    """
    lib = _lib()
    if lib is None or lat.occupancy is None:
        # The engine indexes a dense occupancy array; huge fine grids carry
        # only the sorted table (models.lattice.DENSE_OCCUPANCY_LIMIT).
        return None
    if idx is None:
        idx = np.arange(lat.num_points, dtype=np.int64)
    idx = np.ascontiguousarray(np.asarray(idx, dtype=np.int64))
    occ = np.ascontiguousarray(lat.occupancy, dtype=np.int64)
    coords = np.ascontiguousarray(lat.coords, dtype=np.int64)
    bop = np.ascontiguousarray(lat.box_of_point, dtype=np.int32)
    spc = np.ascontiguousarray(lat.spacings, dtype=np.int64)
    nq = len(idx)

    counts = np.empty(nq, dtype=np.int64)
    args = (
        _ptr(occ, _I64), _ptr(coords, _I64), _ptr(bop, _I32), _ptr(spc, _I64),
        ctypes.c_int64(lat.n_fine), ctypes.c_int64(lat.box_depth),
        _ptr(idx, _I64), ctypes.c_int64(nq), ctypes.c_int64(d),
    )
    lib.count_neighbors(*args, _ptr(counts, _I64))
    k = int(counts.max()) if nq else 0

    nbrs = np.empty((nq, k), dtype=np.int64)
    rels = np.empty((nq, k, 3), dtype=np.int64)
    lib.fill_neighbors(
        *args, ctypes.c_int64(k), _ptr(nbrs, _I64), _ptr(rels, _I64)
    )
    return nbrs, rels


def reciprocal_mask_native(nbrs: np.ndarray) -> Optional[np.ndarray]:
    """keep[i, j] = True iff the edge (i -> nbrs[i, j]) has its reverse
    edge; None when the engine is unavailable.  The native counterpart of
    a sort + searchsorted pass over the edges (246 s at the 341M edges of
    the JAX package's north-star lattice; seconds natively)."""
    lib = _lib()
    if lib is None:
        return None
    nbrs = np.ascontiguousarray(nbrs, dtype=np.int64)
    p, k = nbrs.shape
    keep = np.empty((p, k), dtype=np.uint8)
    lib.reciprocal_mask(_ptr(nbrs, _I64), ctypes.c_int64(p), ctypes.c_int64(k),
                        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return keep.astype(bool)


def pack_ell_native(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, m: int, k: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Row-sorted, deduplicated COO -> padded ELL ``(cols (m, k) int64,
    vals (m, k) float64)``, short rows padded with col = row, val = 0;
    None when the engine is unavailable.  Raises ValueError when the rows
    are not sorted, fall outside [0, m), or one holds more than k entries."""
    lib = _lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    if not len(rows) == len(cols) == len(vals):
        raise ValueError(f"COO arrays differ in length: {len(rows)}, {len(cols)}, {len(vals)}")
    if len(rows):
        if rows[0] < 0 or rows[-1] >= m or (np.diff(rows) < 0).any():
            raise ValueError(f"COO rows must be sorted and within [0, {m})")
        if np.bincount(rows, minlength=m).max() > k:
            raise ValueError(f"a row holds more than k={k} entries")
    out_cols = np.empty((m, k), dtype=np.int64)
    out_vals = np.empty((m, k), dtype=np.float64)
    lib.pack_ell(_ptr(rows, _I64), _ptr(cols, _I64), _ptr(vals, _F64),
                 ctypes.c_int64(len(rows)), ctypes.c_int64(m), ctypes.c_int64(k),
                 _ptr(out_cols, _I64), _ptr(out_vals, _F64))
    return out_cols, out_vals
