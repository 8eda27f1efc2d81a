"""Two-sided (biorthogonal / non-Hermitian) Lanczos.

Counterpart of ``lanczos_tpu/solver/two_sided.py``, the reference's solver
for the irregular lattice's non-symmetric Laplacian (IrrLanczos.py:77-187).

Recurrence (the reference's loop, IrrLanczos.py:125-144):

    r = A q_j   - gamma_{j-1} q_{j-1}
    s = A^T p_j - beta_{j-1}  p_{j-1}
    alpha_j = (p_j.r + q_j.s)/2
    r -= alpha_j q_j ; s -= alpha_j p_j
    w_j = r.s ; q_{j+1} = r/beta_j ; p_{j+1} = s/gamma_j

with the JAX package's choices: beta = ||r|| (so ||q|| = 1) and gamma =
w/beta (so p.q = 1); serious breakdown (|r.s| small against ||r|| ||s||)
is detected and the iteration recorded; full two-sided
rebiorthogonalization (CGS, ``reorth_passes`` passes) against the filled
rows of both bases; T has beta on the subdiagonal and gamma on the
superdiagonal.

PRECISION.  The biorthogonal recurrence loses biorthogonality far faster
than the symmetric one: in fp32 it collapses by about iteration 15 on the
deuteron lattice (scale-aware breakdown detection fires).  The H100 has
native fp64, so the port runs this solver in float64 on the device: build
the operator (and its transpose) in float64.  Krylov–Schur
(solver/arnoldi.py) is the fp32 route.

The ``lax.scan`` becomes a Python loop over device tensors; Q and P are
filled in place, and nothing is read back during the recurrence.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .._util import to_numpy
from ..ops.operators import LinearOperator
from .arnoldi import _check_dtype
from .rows import _unsharded, default_dot, resolve_dot
from .results import EigResult, acceptance_inner_prod

__all__ = [
    "TwoSidedFactorization",
    "two_sided_lanczos",
    "two_sided_lanczos_kernel",
    "two_sided_eigs",
    "nonsymmetric_tridiag_eig",
]


@dataclasses.dataclass(frozen=True)
class TwoSidedFactorization:
    """Biorthogonal factorization: A Q.T ~ Q.T T,  A.T P.T ~ P.T T.T.

    alpha (n,), beta (n-1,) subdiag, gamma (n-1,) superdiag;
    Q, P: (n, M) right/left Lanczos vectors (rows), P.T Q ~ I, ||q_j|| = 1.
    breakdown_iter: 0-d int64 tensor, first j where |w_j| underflowed (n if
    none).  biorth_drift (n,): per-iteration max |P_basis . q_new|;
    p_norm (n,): ||p_j||, the local oblique condition number.
    """

    alpha: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    Q: torch.Tensor
    P: torch.Tensor
    breakdown_iter: torch.Tensor
    biorth_drift: torch.Tensor
    p_norm: torch.Tensor

    @property
    def n(self) -> int:
        return self.alpha.shape[0]

    def health_report(self, good: float = None, warn: float = None) -> str:
        """Per-iteration health table: biorthogonality drift thresholded
        good/warn/fail (the reference's fp64 thresholds 1e-12 / 1e-6 scaled
        by eps(dtype)/eps(fp64)), plus the oblique condition ||p||."""
        eps = float(torch.finfo(self.alpha.dtype).eps)
        scale = eps / float(np.finfo(np.float64).eps)
        good = 1e-12 * scale if good is None else good
        warn = 1e-6 * scale if warn is None else warn
        drift = to_numpy(self.biorth_drift)
        pn = to_numpy(self.p_norm)
        bki = int(self.breakdown_iter)
        lines = ["iter  biorth-drift  ||p||      status"]
        for j in range(self.n):
            d = drift[j]
            status = "ok" if d < good else ("WARN" if d < warn else "FAIL")
            if j >= bki:
                status = "post-breakdown"
            lines.append(f"{j:4d}  {d:11.3e}  {pn[j]:9.3e}  {status}")
        return "\n".join(lines)


def two_sided_lanczos_kernel(
    matvec,
    rmatvec,
    v0: torch.Tensor,
    w0: torch.Tensor,
    n: int,
    *,
    reorth: bool = True,
    reorth_passes: int = 2,
    breakdown_tol: Optional[float] = None,
    compensated: bool = False,
) -> TwoSidedFactorization:
    """n two-sided Lanczos steps from the right/left start vectors v0, w0.

    ``compensated=True`` runs the scalar reductions (w, alpha, norms)
    through ``dot2_rounded`` (``ops/compensated.py``)."""
    dot = resolve_dot(default_dot, compensated)
    m = v0.shape[0]
    dtype, device = v0.dtype, v0.device
    if breakdown_tol is None:
        # |w| = |r.s| relative to ||r|| ||s||: cos of the oblique angle.
        breakdown_tol = float(100 * torch.finfo(dtype).eps)

    def norm(x):
        return torch.sqrt(dot(x, x))

    # Biorthogonal init: q0 unit norm, p0 scaled so p0.q0 = 1.
    q0 = v0 / norm(v0)
    p0 = w0 / dot(q0, w0)
    Q = torch.zeros((n, m), dtype=dtype, device=device)
    P = torch.zeros((n, m), dtype=dtype, device=device)
    Q[0], P[0] = q0, p0

    r0, s0 = matvec(q0), rmatvec(p0)
    alpha = torch.zeros(n, dtype=dtype, device=device)
    beta_h = torch.zeros(max(n - 1, 0), dtype=dtype, device=device)
    gamma_h = torch.zeros_like(beta_h)
    drift_h = torch.zeros(n, dtype=dtype, device=device)
    pn_h = torch.zeros(n, dtype=dtype, device=device)
    alpha[0] = (dot(p0, r0) + dot(q0, s0)) / 2.0
    pn_h[0] = norm(p0)
    r = r0 - alpha[0] * q0
    s = s0 - alpha[0] * p0
    breakdown_iter = torch.tensor(n, dtype=torch.int64, device=device)

    for j in range(1, n):
        if reorth:
            # r -= Q.T (P r), s -= P.T (Q s) against the filled rows.
            Qj, Pj = Q[:j], P[:j]
            for _ in range(reorth_passes):
                r = r - (Pj @ r) @ Qj
                s = s - (Qj @ s) @ Pj
        w = dot(r, s)
        rn, sn = norm(r), norm(s)
        # Breakdown when r.s ~ 0 RELATIVE to ||r|| ||s||, or when either
        # residual vanishes (invariant subspace — benign termination).
        denom = rn * sn
        ok = (w.abs() > breakdown_tol * denom) & (denom > 0)
        breakdown_iter = torch.where(ok, breakdown_iter, breakdown_iter.clamp(max=j))
        beta = torch.where(ok, rn, 1.0)
        gamma = torch.where(ok, w, 1.0) / beta
        okf = ok.to(dtype)
        q = r / beta * okf  # unit norm
        p = s / gamma * okf  # p.q = 1
        drift_h[j] = (P[:j] @ q).abs().max()
        pn_h[j] = sn / gamma.abs() * okf
        Q[j], P[j] = q, p
        r = matvec(q) - gamma * Q[j - 1]
        s = rmatvec(p) - beta * P[j - 1]
        a = (dot(p, r) + dot(q, s)) / 2.0
        r = r - a * q
        s = s - a * p
        alpha[j], beta_h[j - 1], gamma_h[j - 1] = a, beta, gamma

    return TwoSidedFactorization(
        alpha=alpha, beta=beta_h, gamma=gamma_h, Q=Q, P=P,
        breakdown_iter=breakdown_iter, biorth_drift=drift_h, p_norm=pn_h,
    )


def two_sided_lanczos(
    op: LinearOperator,
    n: int,
    *,
    seed: int = 99,
    v0=None,
    w0=None,
    reorth: bool = True,
    reorth_passes: int = 2,
    op_transpose: Optional[LinearOperator] = None,
    dtype=None,
    compensated: bool = False,
) -> TwoSidedFactorization:
    """Run n two-sided Lanczos steps on a (generally non-symmetric)
    operator, on its device.

    ``op_transpose``: explicit A^T operator (a CompositeV2's ``transpose()``
    or an EllOperator's); else ``op.rmatvec``.  ``v0``/``w0`` default to
    Uniform(-1, 1) numbers from one ``torch.Generator`` seeded with
    ``seed``, drawn on the CPU (right vector first).  A CompositeV2's start
    vectors must be masked with its ``live``.  ``compensated=True`` runs
    the scalar reductions through ``dot2_rounded``.
    """
    _unsharded(op, "two_sided_lanczos")
    m = op.shape[0]
    if n > m:
        raise ValueError("n cannot exceed operator dimension")
    dtype = _check_dtype(op, dtype)
    gen = torch.Generator().manual_seed(seed)
    vecs = []
    for v in (v0, w0):
        if v is None:
            v = torch.rand(m, generator=gen, dtype=dtype) * 2.0 - 1.0
        v = torch.as_tensor(v).to(device=op.device, dtype=dtype)
        if v.shape != (m,):
            raise ValueError(f"start vector of shape {tuple(v.shape)}, expected ({m},)")
        vecs.append(v)
    rmatvec = op_transpose.matvec if op_transpose is not None else op.rmatvec
    return two_sided_lanczos_kernel(
        op.matvec, rmatvec, *vecs, n, reorth=reorth, reorth_passes=reorth_passes,
        compensated=compensated,
    )


def _true_residuals(op, vals, X):
    """Relative true residuals ||A x - lam x|| / (||x|| max(|lam|, 1)) for
    real Ritz pairs (host float64 X), through one ``op.matmat``."""
    Xd = torch.as_tensor(X, device=op.device)
    W = op.matmat(Xd.to(op.dtype).contiguous()).double()
    R = W - Xd * torch.as_tensor(vals, device=op.device)[None, :]
    xn = np.linalg.norm(X, axis=0)
    return to_numpy(torch.linalg.vector_norm(R, dim=0)) / np.maximum(
        xn, 1e-300
    ) / np.maximum(np.abs(vals), 1.0)


def two_sided_eigs(
    fac: TwoSidedFactorization,
    k: Optional[int] = None,
    *,
    op: Optional[LinearOperator] = None,
    residual_tol: Optional[float] = None,
):
    """Ritz values/right-vectors from a two-sided factorization.

    Truncates the projected tridiagonal at the serious-breakdown iteration
    (iterations past it carry no information).

    With ``op=None``: returns host numpy (vals (j,), X (M, j)) sorted by
    ascending real part — no residuals, the caller must filter ghosts.

    With ``op`` given: computes TRUE relative residuals against the
    operator, drops complex pairs and every pair with residual >
    ``residual_tol`` (default 1e-3), and returns an EigResult of the
    survivors; ``k`` caps the number of ACCEPTED pairs.
    """
    j = min(int(fac.breakdown_iter), fac.n)
    alpha = to_numpy(fac.alpha)[:j]
    beta = to_numpy(fac.beta)[: j - 1]
    gamma = to_numpy(fac.gamma)[: j - 1]
    vals, w = nonsymmetric_tridiag_eig(alpha, beta, gamma)
    x = to_numpy(fac.Q)[:j].T @ w  # right Ritz vectors
    if op is None:
        if k is not None:
            vals, x = vals[:k], x[:, :k]
        return vals, x

    if residual_tol is None:
        residual_tol = 1e-3
    # Complex pairs: on these near-symmetric problems genuine eigenvalues
    # are real; complex Ritz values are breakdown artifacts.
    real_ok = np.abs(vals.imag) <= 1e-8 * np.maximum(np.abs(vals.real), 1.0)
    vals_r = vals.real[real_ok]
    x_r = np.ascontiguousarray(x[:, real_ok].real)
    resid = _true_residuals(op, vals_r, x_r)
    keep = resid < residual_tol
    vals_r, x_r, resid = vals_r[keep], x_r[:, keep], resid[keep]
    order = np.argsort(vals_r)
    vals_r, x_r, resid = vals_r[order], x_r[:, order], resid[order]
    if k is not None:
        vals_r, x_r, resid = vals_r[:k], x_r[:, :k], resid[:k]
    nrm = np.linalg.norm(x_r, axis=0)
    x_r = x_r / np.where(nrm > 0, nrm, 1.0)
    vecs = torch.as_tensor(x_r, dtype=op.dtype, device=op.device)
    return EigResult(
        eigenvalues=torch.as_tensor(vals_r, device=op.device),
        eigenvectors=vecs,
        residuals=torch.as_tensor(resid, device=op.device),
        inner_prod=acceptance_inner_prod(op, vecs),
    )


def nonsymmetric_tridiag_eig(
    alpha: np.ndarray, beta: np.ndarray, gamma: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Eigendecomposition of T = tridiag(beta; alpha; gamma), host float64.

    If beta_i * gamma_i > 0 for all i, T is similar to the symmetric
    tridiagonal with off-diagonals sqrt(beta_i * gamma_i) via a diagonal
    similarity D T D^-1; the eigenvalues are real and eigh applies.  The
    eigenvectors are mapped back through D.  Otherwise falls back to dense
    nonsymmetric eig.

    Returns (eigvals, right eigvecs columns); eigvals sorted by real part.
    """
    alpha = np.asarray(alpha, dtype=np.float64)
    beta = np.asarray(beta, dtype=np.float64)
    gamma = np.asarray(gamma, dtype=np.float64)
    n = len(alpha)
    prod = beta * gamma
    if n == 1:
        return alpha.copy(), np.ones((1, 1))
    if np.all(prod > 0):
        import scipy.linalg

        off = np.sqrt(prod)
        # D with D[0]=1, D[i+1] = D[i] * sqrt(gamma_i / beta_i), in log space
        # against overflow.
        logd = np.concatenate(
            [[0.0], np.cumsum(0.5 * (np.log(np.abs(gamma)) - np.log(np.abs(beta))))]
        )
        logd -= logd.max()
        d = np.exp(logd)
        vals, vecs_sym = scipy.linalg.eigh_tridiagonal(alpha, off)
        vecs = vecs_sym / d[:, None]  # right eigvecs of T
        vecs = vecs / np.linalg.norm(vecs, axis=0, keepdims=True)
        return vals, vecs
    t = np.diag(alpha) + np.diag(beta, -1) + np.diag(gamma, 1)
    vals, vecs = np.linalg.eig(t)
    order = np.argsort(vals.real)
    return vals[order], vecs[:, order]
