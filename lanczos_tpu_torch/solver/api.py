"""User-facing eigensolver entry point: lanczos -> tridiag eigh -> Ritz -> accept.

Counterpart of ``lanczos_tpu/solver/api.py`` for the single-vector path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._util import COUNTERS, span, to_numpy
from ..ops.operators import as_operator
from .lanczos import lanczos
from .results import EigResult, acceptance_inner_prod
from .tridiag import cullum_willoughby_mask, ritz_values, ritz_vectors

__all__ = ["eigsh"]


def _select(theta, which: str, k: int):
    theta_np = to_numpy(theta)
    if which == "SA":  # smallest algebraic
        order = np.argsort(theta_np)
    elif which == "LA":  # largest algebraic
        order = np.argsort(theta_np)[::-1]
    elif which == "SM":  # smallest magnitude
        order = np.argsort(np.abs(theta_np))
    elif which == "LM":
        order = np.argsort(np.abs(theta_np))[::-1]
    else:
        raise ValueError(f"unknown which={which!r}")
    return order[:k]


def eigsh(
    A,
    k: int = 6,
    *,
    n: Optional[int] = None,
    which: str = "SA",
    seed: int = 99,
    v0=None,
    reorth: str = "full",
    reorth_passes: int = 2,
    reorth_period: int = 5,
    ghost_filter: Optional[bool] = None,
    compute_acceptance: bool = True,
    dtype=None,
    compensated: bool = False,
    block_size: int = 1,
) -> EigResult:
    """Find k extremal eigenpairs of a symmetric operator by Lanczos.

    Parameters mirror scipy.sparse.linalg.eigsh where they overlap; ``A`` may
    be a LinearOperator (solved on its device), a dense array or tensor, or
    a scipy sparse matrix.

    ``block_size > 1`` runs block Lanczos (``solver/block.py``): each step
    advances an (M, b) block through ``op.matmat``, resolving degenerate
    multiplets up to b; ``n`` then counts Krylov vectors, rounded up to
    whole blocks so that at least k exist.  The reorth and ghost options
    apply to the single-vector path only; ``v0`` and ``compensated`` are
    rejected with ``block_size > 1``.

    ``ghost_filter`` defaults to True when reorthogonalization is not "full"
    (without full reorth, spurious copies of converged eigenvalues appear and
    are filtered by the Cullum–Willoughby test).  ``compensated=True`` runs
    the recurrence's reductions through the error-free-transform dot.

    The call runs inside the span ``lt.eigsh`` and counts itself in
    ``COUNTERS["lt.eigsh.calls"]`` (``_util.py``); the single-vector path's
    phases have spans of their own, the block branch none.
    """
    COUNTERS["lt.eigsh.calls"] += 1
    with span("lt.eigsh"):
        op = as_operator(A)
        m = op.shape[0]
        if n is None:
            n = min(m, max(2 * k + 20, 4 * k))
        if k > n:
            raise ValueError(f"k={k} cannot exceed Krylov depth n={n}")
        if ghost_filter is None:
            ghost_filter = reorth != "full"

        if block_size > 1:
            return _eigsh_block(op, k, n, which, seed, v0, compute_acceptance, dtype,
                                compensated, block_size)

        fac = lanczos(
            op, n, seed=seed, v0=v0, reorth=reorth, reorth_passes=reorth_passes,
            reorth_period=reorth_period, dtype=dtype, compensated=compensated,
        )
        # Select from the Ritz values, then rotate only the selected pairs.
        theta, W, resid_est = ritz_values(fac)
        with span("lt.select"):
            theta_np = to_numpy(theta)
            keep = (_ghost_mask(fac, theta_np, resid_est) if ghost_filter
                    else np.ones(fac.n, dtype=bool))
            kept_idx = np.nonzero(keep)[0]
            sel = torch.as_tensor(
                kept_idx[_select(theta_np[kept_idx], which, k)], device=theta.device
            )
            eigenvalues = theta[sel]
            residuals = resid_est[sel]
        eigenvectors = ritz_vectors(fac, W, sel)
        if compute_acceptance:
            with span("lt.acceptance"):
                inner = acceptance_inner_prod(op, eigenvectors)
        else:
            inner = torch.full_like(eigenvalues, float("nan"))
        return EigResult(
            eigenvalues=eigenvalues,
            eigenvectors=eigenvectors,
            residuals=residuals,
            inner_prod=inner,
        )


def _ghost_mask(fac, theta_np, resid_est):
    """The Ritz values to keep: Cullum–Willoughby's genuine ones, each
    cluster of numerically equal copies collapsed to its best residual."""
    keep = cullum_willoughby_mask(to_numpy(fac.alpha), to_numpy(fac.beta), theta_np)
    # Without (full) reorthogonalization, converged Ritz values reappear
    # as numerically identical copies.  Single-vector Lanczos cannot
    # resolve true multiplicity anyway, so collapse each cluster to its
    # best-residual representative.
    resid_np = to_numpy(resid_est)
    scale = max(float(np.max(np.abs(theta_np))), 1.0)
    tol = 1e-8 * scale
    rep = None  # index of current cluster's representative
    for i in np.argsort(theta_np):
        if not keep[i]:
            continue
        if rep is not None and theta_np[i] - theta_np[rep] < tol:
            if resid_np[i] < resid_np[rep]:
                keep[rep] = False
                rep = i
            else:
                keep[i] = False
        else:
            rep = i
    return keep


def _eigsh_block(op, k, n, which, seed, v0, compute_acceptance, dtype, compensated,
                 block_size):
    """``eigsh``'s block branch: unrestarted block Lanczos, then Ritz."""
    from .block import block_lanczos, block_ritz

    if v0 is not None:
        raise ValueError("v0 is not supported with block_size > 1")
    if compensated:
        raise ValueError("compensated is not supported with block_size > 1")
    m = op.shape[0]
    if m < 2 * block_size:
        # The least basis, two blocks, would exceed the operator dimension.
        raise ValueError(
            f"operator dimension {m} is too small for block_size={block_size} "
            f"(needs m >= {2 * block_size})"
        )
    # The Krylov dimension must cover k: whole blocks, rounded up, capped at
    # the operator dimension.
    num_blocks = min(max(-(-max(n, k) // block_size), 2), m // block_size)
    if num_blocks * block_size < k:
        raise ValueError(
            f"block Krylov dimension {num_blocks * block_size} "
            f"(block_size={block_size}, m={m}) cannot produce k={k} pairs"
        )
    theta, X, resid = block_ritz(block_lanczos(op, num_blocks, block_size, seed=seed,
                                               dtype=dtype))
    sel = torch.as_tensor(_select(theta, which, k).copy(), device=theta.device)
    eigenvalues, eigenvectors = theta[sel], X[:, sel]
    if compute_acceptance:
        inner = acceptance_inner_prod(op, eigenvectors)
    else:
        inner = torch.full_like(eigenvalues, float("nan"))
    return EigResult(
        eigenvalues=eigenvalues,
        eigenvectors=eigenvectors,
        residuals=resid[sel],
        inner_prod=inner,
    )
