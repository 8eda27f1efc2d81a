"""Solver-state checkpoints: resumable long Lanczos runs.

Counterpart of ``lanczos_tpu/utils/checkpoint.py``, with its on-disk format
(``.npz`` / ``.npy`` files of the same names and keys), so a checkpoint
written by either package resumes in the other.

* :func:`lanczos_checkpointed` — the plain (not restarted) recurrence in
  resumable segments of ``solver/lanczos.py:lanczos_segment``, the same
  step as ``lanczos``.  Two layouts:
  - ``path`` ending in ``.npz``: one atomic full-state file per segment;
  - any other ``path``: a directory with incremental writes, each segment
    appending only its new basis rows (``V_{j0}_{j1}.npy``) plus a small
    ``meta.npz`` (r, alpha, beta, j), so a segment writes O(every * M).
* :func:`save_restart_state` / :func:`load_restart_state` — the cycle
  boundary of ``solver/restart.py:eigsh_restarted``: the locked block, the
  restart vector, theta, sigma and the completed-cycle count.

Vectors go to disk flat, (rows, M); a state the JAX package wrote in its
operator's ``vec_shape`` is reshaped on load.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from .._util import to_numpy
from ..ops.operators import LinearOperator
from ..solver.arnoldi import _check_dtype, _start_vector
from ..solver.rows import _unsharded, default_dot, resolve_dot
from ..solver.lanczos import LanczosFactorization, lanczos_segment

__all__ = [
    "save_state",
    "load_state",
    "lanczos_checkpointed",
    "save_restart_state",
    "load_restart_state",
]


def _atomic_savez(path: str, **arrays) -> None:
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    # numpy appends .npz to names without the suffix
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(actual_tmp, path)


def save_state(path: str, V, r, alpha, beta, j: int) -> None:
    """Single-file checkpoint (the full basis rewritten every call)."""
    _atomic_savez(
        path, V=to_numpy(V), r=to_numpy(r), alpha=to_numpy(alpha),
        beta=to_numpy(beta), j=np.asarray(j),
    )


def load_state(path: str):
    with np.load(path) as z:
        return z["V"], z["r"], z["alpha"], z["beta"], int(z["j"])


def _save_incremental(dirpath: str, V, r, alpha, beta, j_prev: int, j: int):
    """Append basis rows [j_prev, j) and atomically update meta."""
    os.makedirs(dirpath, exist_ok=True)
    seg = os.path.join(dirpath, f"V_{j_prev:06d}_{j:06d}.npy")
    tmp = seg + ".tmp.npy"
    np.save(tmp, to_numpy(V[j_prev:j]))
    os.replace(tmp, seg)
    _atomic_savez(
        os.path.join(dirpath, "meta.npz"),
        r=to_numpy(r), alpha=to_numpy(alpha), beta=to_numpy(beta), j=np.asarray(j),
    )


def _load_incremental(dirpath: str, n: int, m: int):
    """Reassemble (V, r, alpha, beta, j) from an incremental checkpoint dir.

    Only segments covered by meta's ``j`` are trusted (a segment written
    after a crash mid-meta-update is ignored)."""
    with np.load(os.path.join(dirpath, "meta.npz")) as z:
        r, alpha, beta, j = z["r"], z["alpha"], z["beta"], int(z["j"])
    V = np.zeros((n, m), dtype=r.dtype)
    covered = np.zeros(n, dtype=bool)
    for name in sorted(os.listdir(dirpath)):
        if not (name.startswith("V_") and name.endswith(".npy")):
            continue
        j0, j1 = (int(t) for t in name[2:-4].split("_"))
        if j1 > j:
            continue
        V[j0:j1] = np.load(os.path.join(dirpath, name)).reshape(j1 - j0, m)
        covered[j0:j1] = True
    if not covered[:j].all():
        missing = int(np.count_nonzero(~covered[:j]))
        raise ValueError(
            f"incremental checkpoint at {dirpath} is missing {missing} basis "
            f"rows below j={j}"
        )
    return V, r, alpha, beta, j


def lanczos_checkpointed(
    op: LinearOperator,
    n: int,
    path: str,
    *,
    every: int = 50,
    seed: int = 99,
    v0=None,
    reorth_passes: int = 2,
    dtype=None,
    compensated: bool = False,
    progress: Optional[Callable[[int], None]] = None,
) -> LanczosFactorization:
    """Full-reorthogonalization Lanczos in resumable segments, on ``op``'s
    device.

    If ``path`` exists, resumes from it; otherwise starts fresh from ``v0``
    (default: Uniform(-1, 1) from a ``torch.Generator`` seeded with
    ``seed``, drawn on the CPU).  State is written after every segment, so
    a killed run loses at most ``every`` steps.  ``path`` ending in ``.npz``
    selects the single-file layout, anything else the incremental directory.
    """
    _unsharded(op, "lanczos_checkpointed")
    m = op.shape[0]
    dtype = _check_dtype(op, dtype)
    dev = op.device
    legacy = path.endswith(".npz")

    state = None
    if legacy and os.path.exists(path):
        state = load_state(path)
    elif not legacy and os.path.exists(os.path.join(path, "meta.npz")):
        state = _load_incremental(path, n, m)

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    if state is not None:
        V, r, alpha, beta, j = state
        V = np.asarray(V).reshape(V.shape[0], -1)
        if V.shape != (n, m):
            raise ValueError(f"checkpoint at {path} has shape {V.shape}, expected {(n, m)}")
        V, r, alpha, beta = tensor(V), tensor(r).reshape(m), tensor(alpha), tensor(beta)
    else:
        v0 = _start_vector(op, v0, seed, dtype)
        v0 = v0 / torch.linalg.vector_norm(v0)
        V = torch.zeros((n, m), dtype=dtype, device=dev)
        V[0] = v0
        w = op.matvec(v0)
        a0 = resolve_dot(default_dot, compensated)(w, v0)
        r = w - a0 * v0
        alpha = torch.zeros(n, dtype=dtype, device=dev)
        alpha[0] = a0
        beta = torch.zeros(n - 1, dtype=dtype, device=dev)
        j = 1
        if not legacy:
            # Row 0 must be on disk too, or a resume from the first meta
            # would miss the start vector.
            _save_incremental(path, V, r, alpha, beta, 0, 1)

    bki = torch.tensor(n, dtype=torch.int64, device=dev)
    while j < n:
        j1 = min(j + every, n)
        V, r, alpha, beta, bki = lanczos_segment(
            op.matvec, V, r, alpha, beta, bki, j, j1,
            reorth="full", reorth_passes=reorth_passes, compensated=compensated,
        )
        if legacy:
            save_state(path, V, r, alpha, beta, j1)
        else:
            _save_incremental(path, V, r, alpha, beta, j, j1)
        j = j1
        if progress is not None:
            progress(j)

    return LanczosFactorization(alpha=alpha, beta=beta, V=V, resid=r, breakdown_iter=bki)


# ---------------------------------------------------------------------------
# Thick-restart cycle checkpoints (solver/restart.py:eigsh_restarted).


def save_restart_state(path: str, V_locked, u, theta, sigma, cycle: int) -> None:
    """Atomically save a thick-restart cycle boundary: the locked Ritz rows
    (l, M), the restart vector u (M,), the locked values theta (l,), the
    couplings sigma (l,), the completed-cycle count."""
    _atomic_savez(
        path, V_locked=to_numpy(V_locked), u=to_numpy(u), theta=np.asarray(theta),
        sigma=np.asarray(sigma), cycle=np.asarray(cycle),
    )


def load_restart_state(path: str):
    """(V_locked (l, M), u (M,), theta, sigma, cycle) as host arrays."""
    with np.load(path) as z:
        u = z["u"].reshape(-1)
        return (z["V_locked"].reshape(-1, u.size), u, z["theta"], z["sigma"], int(z["cycle"]))
