"""Tridiagonal eigensolve and Ritz extraction on the device.

Counterpart of ``lanczos_tpu/solver/tridiag.py``: ``torch.linalg.eigh`` of
the dense (n, n) tridiagonal on the factorization's device, and the Ritz
back-transform as one (M, n) x (n, n) product.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .._util import span

__all__ = [
    "tridiag_to_dense",
    "tridiag_eigh",
    "ritz_from_factorization",
    "cullum_willoughby_mask",
]


def tridiag_to_dense(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Dense symmetric tridiagonal from diagonal alpha (n,) and off-diag beta (n-1,)."""
    return torch.diag(alpha) + torch.diag(beta, 1) + torch.diag(beta, -1)


def tridiag_eigh(alpha: torch.Tensor, beta: torch.Tensor):
    """Eigendecomposition of T = tridiag(beta, alpha, beta): (eigvals
    ascending, eigvecs as columns), in alpha's dtype.

    n is the Krylov depth, so the dense form is small whatever the problem
    size M, and it is decomposed in float64 at no measurable cost: on the
    H100, cuSOLVER's float32 eigh of the N=64 deuteron's T moved the Ritz
    values by ~3e-5 relative and left the eigenvector norms off by as much,
    several times the error of the rest of the float32 solve.
    """
    theta, W = torch.linalg.eigh(tridiag_to_dense(alpha, beta).double())
    return theta.to(alpha.dtype), W.to(alpha.dtype)


def ritz_from_factorization(fac) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ritz values/vectors and residual-norm estimates from a Lanczos run.

    Returns (theta, X, resid_est):
      theta     (n,)   Ritz values, ascending.
      X         (M, n) Ritz vectors, columns: X = V.T @ W.
      resid_est (n,)   ||A x_i - theta_i x_i|| estimated as beta_n * |W[n-1, i]|
                       (the classical Lanczos bound, no extra matvec;
                       beta_n = ||resid|| of the factorization).
    """
    with span("lt.ritz"):
        with span("lt.ritz.eigh"):
            theta, W = tridiag_eigh(fac.alpha, fac.beta)
        with span("lt.ritz.rotate"):
            X = fac.V.T @ W
            beta_n = torch.sqrt(torch.dot(fac.resid, fac.resid))
            return theta, X, beta_n * W[-1, :].abs()


def cullum_willoughby_mask(
    alpha: np.ndarray,
    beta: np.ndarray,
    theta: np.ndarray,
    *,
    tol: Optional[float] = None,
) -> np.ndarray:
    """Ghost-eigenvalue (spurious Ritz value) detection, Cullum–Willoughby test.

    A Ritz value of T_n that is ALSO an eigenvalue of the submatrix T_hat
    (T_n with its first row/column deleted) and is simple, is an artifact of
    lost orthogonality ("ghost"), not an eigenvalue of A.  This test is what
    makes the cheaper reorthogonalization strategies (none/periodic/
    selective) usable.

    Host-side (numpy): runs once per solve on (n,)-sized data.

    Returns a boolean mask over ``theta`` — True = genuine, False = ghost.
    """
    alpha = np.asarray(alpha, dtype=np.float64)
    beta = np.asarray(beta, dtype=np.float64)
    theta = np.asarray(theta, dtype=np.float64)
    n = len(alpha)
    if n < 3:
        return np.ones_like(theta, dtype=bool)

    import scipy.linalg

    theta_hat = scipy.linalg.eigh_tridiagonal(
        alpha[1:], beta[1:], eigvals_only=True
    )
    scale = max(np.max(np.abs(theta)), 1.0)
    if tol is None:
        tol = 1e-8 * scale

    good = np.ones_like(theta, dtype=bool)
    # A Ritz value matching an eigenvalue of the deflated matrix is spurious
    # unless it is a (converged) multiple copy among the theta themselves.
    for i, t in enumerate(theta):
        near_hat = np.min(np.abs(theta_hat - t)) < tol
        if near_hat:
            multiplicity = np.sum(np.abs(theta - t) < tol)
            if multiplicity == 1:
                good[i] = False
    return good
