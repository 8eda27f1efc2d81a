"""Build and load the port's CUDA kernels.

Each source of ``csrc/`` (``stencil.cu``, ``interface.cu``, ``cgs2.cu``)
is compiled with ``nvcc`` for ``sm_90a`` into its own shared library with a
plain C interface and loaded with :mod:`ctypes` (no PyTorch headers, so a build
takes seconds).  The build happens at first use, from the sources in this
package only, into ``lanczos_tpu_torch/_build/``; a library's name carries a
hash of its source and the flags, so an edited source is rebuilt and a
stale library is never loaded.  Concurrent builds of one library (several
test processes on one card) serialise on its own ``fcntl`` lock, which the
kernel releases when its holder dies, so a crashed build leaves no stale
lock behind; different libraries build in parallel (:func:`build_all`).

Nothing here runs at import: the CPU tests import every module, and a
CPU-only host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = [
    "BuildInfo", "nvcc_path", "load_stencil_library", "load_interface_library",
    "load_cgs2_library", "build_all", "launch_on",
]

_PKG_DIR = Path(__file__).resolve().parents[1]
_CSRC = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """Where the library is, and what its build took and printed."""

    path: Path
    seconds: float  # wall time of the nvcc run; 0.0 when it was already built
    log: str  # nvcc's output, including ptxas' registers/spills per kernel
    cached: bool


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH``, else ``PATH``, else the
    toolkit's default install prefix."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
        "from lanczos_tpu_torch/csrc at first use on a CUDA tensor"
    )


def _build(source: Path, stem: str, extra_flags=()) -> BuildInfo:
    flags = (*NVCC_FLAGS, *extra_flags)
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{stem}_{digest}.so"
    log_path = lib.with_suffix(".log")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.is_file():
            log = log_path.read_text() if log_path.is_file() else ""
            return BuildInfo(lib, 0.0, log, cached=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *flags, "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
            )
        log_path.write_text(log)
        os.replace(tmp, lib)
    return BuildInfo(lib, seconds, log, cached=False)


@functools.lru_cache(maxsize=None)
def load_stencil_library():
    """(ctypes library, BuildInfo) for ``csrc/stencil.cu``; built once per
    source version, loaded once per process."""
    info = _build(_CSRC / "stencil.cu", "stencil")
    lib = ctypes.CDLL(str(info.path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "f64"):
        spmv = getattr(lib, f"stencil_spmv_{dt}")
        # x, diag, y, nz, ny, nx, z_chunk, w27 (host doubles), stream
        spmv.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr, ptr]
        spmv.restype = i32
        spmm = getattr(lib, f"stencil_spmm_{dt}")
        # x, diag, y, nz, ny, nx, b, tile (ty, tx, cb), z_chunk, w27, stream
        spmm.argtypes = [ptr, ptr, ptr, *[i32] * 8, ptr, ptr]
        spmm.restype = i32
        resident = getattr(lib, f"stencil_spmm_resident_{dt}")
        # b, tile (ty, tx, cb), has_diag
        resident.argtypes = [i32] * 5
        resident.restype = i32
    for name in ("spmv_resident_f32", "spmv_resident_f64", "spmv_tile_y", "spmv_tile_x",
                 "spmm_outputs_per_thread"):
        getattr(lib, f"stencil_{name}").argtypes = []
        getattr(lib, f"stencil_{name}").restype = i32
    return lib, info


@functools.lru_cache(maxsize=None)
def load_interface_library():
    """(ctypes library, BuildInfo) for ``csrc/interface.cu``."""
    info = _build(_CSRC / "interface.cu", "interface")
    lib = ctypes.CDLL(str(info.path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"fused_interface_{dt}")
        # x, y, b, n_rows, cls, taps, w, row_class, stream
        fn.argtypes = [ptr, ptr, i32, i32, ptr, ptr, ptr, ptr, ptr]
        fn.restype = i32
    return lib, info


@functools.lru_cache(maxsize=None)
def load_cgs2_library():
    """(ctypes library, BuildInfo) for ``csrc/cgs2.cu``."""
    info = _build(_CSRC / "cgs2.cu", "cgs2")
    lib = ctypes.CDLL(str(info.path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"cgs2_{dt}")
        # V, v, out, h, partial, M, j, passes, blocks, stream
        fn.argtypes = [ptr] * 5 + [ctypes.c_longlong, i32, i32, i32, ptr]
        fn.restype = i32
        step = getattr(lib, f"cgs2_step_{dt}")
        # V, v, out, h_pend, h, partial, M, j, passes, blocks, stream
        step.argtypes = [ptr] * 6 + [ctypes.c_longlong, i32, i32, i32, ptr]
        step.restype = i32
        update = getattr(lib, f"cgs2_update_{dt}")
        # V, v, out, h, M, j, flagged, blocks, stream
        update.argtypes = [ptr] * 4 + [ctypes.c_longlong, i32, i32, i32, ptr]
        update.restype = i32
    return lib, info


def build_all():
    """Build every kernel library at once, one nvcc per source started
    together; returns {name: BuildInfo}."""
    from concurrent.futures import ThreadPoolExecutor

    loaders = {"stencil": load_stencil_library, "interface": load_interface_library,
               "cgs2": load_cgs2_library}
    with ThreadPoolExecutor(len(loaders)) as pool:
        futures = {name: pool.submit(fn) for name, fn in loaders.items()}
        return {name: f.result()[1] for name, f in futures.items()}


def launch_on(device, fn, *args):
    """Call the C launcher ``fn(*args, stream)`` with ``device`` current and
    its current stream, entering ``torch.cuda.device`` only when ``device``
    is not already the current one; returns what ``fn`` returns."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return fn(*args, torch.cuda.current_stream().cuda_stream)
    return fn(*args, torch.cuda.current_stream().cuda_stream)
