"""Eigensolve results: acceptance criteria, validation, pretty-printing.

Counterpart of ``lanczos_tpu/solver/results.py``:

* residual acceptance <(Hx/||Hx||), x>^2 within tol of 1;
* basis quality checks: normality and orthogonality of eigenvectors;
* greedy eigenvector matching against an oracle.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._util import to_numpy

__all__ = [
    "EigResult",
    "acceptance_inner_prod",
    "match_eigs",
    "check_normalized",
    "check_orthogonal",
]


@dataclasses.dataclass(frozen=True)
class EigResult:
    """k approximate eigenpairs of a symmetric operator.

    eigenvalues:  (k,) ascending Ritz values.
    eigenvectors: (M, k) columns.
    residuals:    (k,) residual-norm estimates ||A x - theta x||.
    inner_prod:   (k,) the acceptance statistic <(Ax/||Ax||), x>^2
                  (1.0 = perfect eigenpair), or NaN if not computed.
    residuals_are_estimates: True when ``residuals`` are cheap model
                  estimates rather than operator-verified values.
    cycles:       restart cycles completed (``eigsh_restarted``, a resumed
                  run's included; 0 for the unrestarted solvers).
    """

    eigenvalues: torch.Tensor
    eigenvectors: torch.Tensor
    residuals: torch.Tensor
    inner_prod: torch.Tensor
    residuals_are_estimates: bool = False
    cycles: int = 0

    @property
    def k(self) -> int:
        return self.eigenvalues.shape[0]

    def good_mask(self, tol: float = 0.01) -> np.ndarray:
        """Acceptance: |1 - <Ax/||Ax||, x>^2| < tol."""
        return np.abs(1.0 - to_numpy(self.inner_prod)) < tol

    def summary(self, print_nr: int = 20, tol: float = 0.01) -> str:
        """Table of eigenvalue, residual, acceptance statistic and status."""
        lines = ["__________EIGENVALUE AND EIGENVECTOR SUMMARY__________"]
        if self.residuals_are_estimates:
            lines.append("(residuals are cheap model ESTIMATES, not "
                         "operator-verified — rr_verify was off)")
        lines.append(f"{'Eigval':>14} {'Residual':>12} {'InnerProd':>18}  status")
        vals = to_numpy(self.eigenvalues)
        res = to_numpy(self.residuals)
        ip = to_numpy(self.inner_prod)
        good = self.good_mask(tol)
        for i in range(min(print_nr, len(vals))):
            status = "ok" if good[i] else "BAD"
            lines.append(
                f"{vals[i]:14.6f} {res[i]:12.3e} {ip[i]:18.14f}  {status}"
            )
        return "\n".join(lines)


def acceptance_inner_prod(op, X: torch.Tensor) -> torch.Tensor:
    """<(Ax/||Ax||), x>^2 per column of X, through ``op.matmat`` (the
    stencil SpMM kernel for a stencil operator).  For a row-sharded
    operator X is this rank's rows and the sums are all-reduced."""
    from .rows import Rows

    rows = Rows(op)
    AX = op.matmat(X)
    nrm = torch.sqrt(rows.sum(torch.sum(AX * AX, dim=0)))
    dots = rows.sum(torch.sum(AX * X, dim=0))
    return (dots / torch.where(nrm > 0, nrm, 1.0)) ** 2


def check_normalized(X, tol: float = 1e-3) -> float:
    """Max |  ||x_i|| - 1 | over columns."""
    norms = np.linalg.norm(to_numpy(X), axis=0)
    return float(np.max(np.abs(norms - 1.0)))


def check_orthogonal(X, tol: float = 1e-2) -> float:
    """Max off-diagonal |x_i . x_j| over columns."""
    X = to_numpy(X)
    g = X.T @ X
    np.fill_diagonal(g, 0.0)
    return float(np.max(np.abs(g)))


def match_eigs(est_vals, est_vecs, ref_vals, ref_vecs):
    """Greedily match estimated eigenpairs to reference pairs by max squared
    inner product of eigenvectors.

    Returns (matched_ref_vals, matched_est_vals, innerprods) over the
    reference set; unmatched entries are NaN.
    """
    est_vals = to_numpy(est_vals)
    est_vecs = to_numpy(est_vecs)
    ref_vals = to_numpy(ref_vals)
    ref_vecs = to_numpy(ref_vecs)

    nref = len(ref_vals)
    matched = np.full(nref, np.nan)
    innerprod = np.full(nref, np.nan)
    overlap = (est_vecs.T @ ref_vecs) ** 2  # (n_est, n_ref)
    for i in range(len(est_vals)):
        idx = int(np.argmax(overlap[i]))
        if np.isnan(innerprod[idx]) or overlap[i, idx] > innerprod[idx]:
            matched[idx] = est_vals[i]
            innerprod[idx] = overlap[i, idx]
    return ref_vals, matched, innerprod
