"""Symmetric Lanczos recurrence on device tensors.

Counterpart of ``lanczos_tpu/solver/lanczos.py``.  The JAX package's
``lax.scan`` becomes a Python loop over tensors that stay on the device:
the loop launches work and never reads a value back (the breakdown guard is
a tensor ``where``), except on the selective path, which reads one flag per
step to decide whether to run a reorthogonalization pass.

* How a step orthogonalizes its new row is chosen once, before the loop
  (``_row_step``): classical Gram-Schmidt run twice (CGS2) through
  ``ops/cgs2_kernels.py``, which picks the kernel or the plain loop, on
  every step, on some or on none.  Full reorthogonalization with the
  default dots and two or more passes lags each vector's last CGS update
  into the next step, so the card reads the basis p times a step.  The
  basis is sliced to its filled rows ``V[:j]``; the JAX package multiplies
  by the zero-padded ``(n, M)`` basis, whose zero rows contribute exactly 0.
* ``V`` is row-major ``(n, M)`` and is filled in place, as are the
  ``alpha``/``beta`` histories (PyTorch tensors are mutable; this saves a
  copy of the basis per step).
* Breakdown (beta ~ 0, an exact invariant subspace) is recorded in
  ``breakdown_iter`` and the recurrence continues with a zero vector.
* ``_start`` runs inside the span ``lt.lanczos.start`` and the recurrence
  loop inside ``lt.lanczos.recurrence`` (``_util.span``), which adds its
  steps to ``COUNTERS["lt.lanczos.recurrence.steps"]``: one span per loop,
  none per step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .._util import COUNTERS, span
from ..ops import cgs2_kernels
from ..ops.cgs2_kernels import local_basis_dot
from ..ops.operators import LinearOperator
from .rows import Rows, _check_dtype, _start_vector, default_dot, resolve_dot

__all__ = [
    "LanczosFactorization",
    "lanczos",
    "lanczos_kernel",
    "lanczos_segment",
]


@dataclasses.dataclass(frozen=True)
class LanczosFactorization:
    """Result of an n-step Lanczos run: A V.T ≈ V.T T + r e_n.T.

    alpha: (n,) diagonal of the tridiagonal T.
    beta:  (n-1,) off-diagonal of T.
    V:     (n, M) Krylov basis, rows are the Lanczos vectors.
    resid: (M,) final residual vector (unnormalized candidate v_n).
    breakdown_iter: 0-d int64 tensor, the iteration where beta underflowed
                    (n if none did).
    """

    alpha: torch.Tensor
    beta: torch.Tensor
    V: torch.Tensor
    resid: torch.Tensor
    breakdown_iter: torch.Tensor

    @property
    def n(self) -> int:
        return self.alpha.shape[0]

    @property
    def m(self) -> int:
        return self.V.shape[1]


def _normalized(v, dot):
    nrm = torch.sqrt(dot(v, v))
    return v * torch.where(nrm > 0, 1.0 / nrm, 0.0)


def _row_step(reorth, passes, period, dot, basis_dot, alpha_h, j1):
    """How each step of a run ending at step j1 orthogonalizes its new row:
    ``step(V, j, v, beta, ok)`` writes row j of ``V`` from v = r / beta
    (zero where not ``ok``) and returns h~, the coefficients that finish a
    lagged row, or ``None``.  Only full reorthogonalization with p >= 2 and
    the local dots lags: a mesh's all-reduced products and the compensated
    dot cannot take the lagged kernel's Pythagorean norm."""
    if reorth == "full" and passes >= 2 and dot is default_dot and basis_dot is local_basis_dot:
        return _lagged_row(passes, j1)
    if reorth == "selective":
        return _selective_row(passes, dot, basis_dot, alpha_h)
    if reorth not in ("full", "none", "periodic"):
        raise ValueError(f"unknown reorth strategy: {reorth!r}")

    def step(V, j, v, beta, ok):
        if reorth == "full" or (reorth == "periodic" and j % period == 0):
            v = _normalized(cgs2_kernels.orthogonalize(V[:j], v, passes, basis_dot), dot)
        V[j] = v

    return step


def _lagged_row(passes, j1):
    """Full reorthogonalization with CGS's last update lagged a step.

    Step j leaves row j unfinished: ``cgs2_lagged`` stores v~ = s v_{p-1}
    in ``V[j]`` and returns h~ = s h_p, and the unit vector CGS would store
    is v_j = v~ - V[:j]^T h~.  The SpMV runs on v~, and the next step's
    first sweep finishes ``V[j]`` while it projects the next vector, so the
    card reads ``V[:j]`` p times a step instead of p + 1.  Since
    H V[:j]^T = V[:j+1]^T T to rounding, v~ . H v~ = alpha_j + 2 beta_j
    h~[j-1] + O(|h~|^2 |H|), which gives alpha_j; the residual r = H v~ -
    alpha_j v~ - beta_j v_{j-1} differs from the plain one by
    (H - alpha_j) V[:j]^T h~, which lies in span V[:j+1] and is removed by
    the next step's CGS passes (it moves |r| by O(|h~|^2)).  The run's
    last row (step j1 - 1) is finished before its SpMV, so a segment leaves
    ``V`` and ``r`` in the plain recurrence's form, equal to rounding.
    """
    h = None  # h~ of the unfinished row V[j - 1]; none at a segment's start

    def step(V, j, v, beta, ok):
        nonlocal h
        h = cgs2_kernels.cgs2_lagged(V, j, v, h, passes)
        if j == j1 - 1 and h is not None:
            cgs2_kernels.cgs2_finish(V, j + 1, h)
            h = None
        return h

    return step


def _selective_row(passes, dot, basis_dot, alpha_h):
    """Selective reorthogonalization via the omega recurrence (Simon 1984).

    Tracks running estimates omega[j, i] ~ |v_j . v_i| of orthogonality loss
    from the alpha/beta history alone (O(n) work per step), and runs a full
    reorthogonalization pass only on steps where max_i omega exceeds
    sqrt(machine eps); omega then resets to the machine-eps floor.  Deciding
    to skip the O(nM) pass reads one flag back per step.
    """
    n, dtype, device = alpha_h.shape[0], alpha_h.dtype, alpha_h.device
    eps = float(torch.finfo(dtype).eps)
    threshold = np.sqrt(eps)
    noise = eps * 2.0
    beta_h = torch.zeros(n, dtype=dtype, device=device)  # beta_h[j]: norm before v_j
    # omega_prev: estimates for v_{j-1}; omega_curr: for v_j (index i over n).
    omega_prev = torch.zeros(n, dtype=dtype, device=device)
    omega_curr = torch.zeros(n, dtype=dtype, device=device)
    omega_curr[0] = 1.0
    idx = torch.arange(n, device=device)

    def step(V, j, v, beta, ok):
        nonlocal omega_prev, omega_curr
        # omega update for the new vector v_j (Simon's recurrence):
        #   beta_j w_{j,i} = beta_{i} w_{j-1,i+1} + (alpha_i - alpha_{j-1})
        #       w_{j-1,i} + beta_{i-1} w_{j-1,i-1} - beta_{j-1} w_{j-2,i}
        raw = (
            beta_h * torch.roll(omega_curr, -1)
            + (alpha_h - alpha_h[j - 1]) * omega_curr
            + torch.roll(beta_h, 1) * torch.roll(omega_curr, 1)
            - beta_h[j - 1] * omega_prev
        ) / torch.where(ok, beta, 1.0)
        w_new = torch.where(idx < j, raw.abs() + noise, 0.0)
        w_new[j] = 1.0
        w_new[j - 1] = eps

        drift = torch.where(idx < j - 1, w_new, 0.0).max()
        if bool(drift > threshold):
            v = _normalized(cgs2_kernels.orthogonalize(V[:j], v, passes, basis_dot), dot)
            w_new = torch.where(idx < j, noise, w_new)
            omega_prev = torch.where(idx < j, noise, omega_curr)
        else:
            omega_prev = omega_curr
        omega_curr = w_new
        V[j] = v
        beta_h[j] = beta

    return step


def _steps(matvec, V, r, alpha_h, beta_h, breakdown_iter, j0, j1, dot, step, breakdown_tol):
    """Lanczos steps j0..j1-1, row j written by ``step`` (``_row_step``)."""
    if breakdown_tol is None:
        breakdown_tol = float(10 * torch.finfo(r.dtype).eps)
    COUNTERS["lt.lanczos.recurrence.steps"] += max(j1 - j0, 0)
    with span("lt.lanczos.recurrence"):
        for j in range(j0, j1):
            beta = torch.sqrt(dot(r, r))
            # Scale-aware breakdown test: beta relative to the basis scale (=1).
            ok = beta > breakdown_tol
            breakdown_iter = torch.where(ok, breakdown_iter, breakdown_iter.clamp(max=j))
            v = r * torch.where(ok, 1.0 / torch.where(ok, beta, 1.0), 0.0)

            h = step(V, j, v, beta, ok)
            w = matvec(V[j])
            alpha = dot(V[j], w)
            if h is not None:
                alpha = torch.addcmul(alpha, beta, h[j - 1], value=-2.0)
            r = w - alpha * V[j] - beta * V[j - 1]
            alpha_h[j] = alpha
            beta_h[j - 1] = beta
    return V, r, alpha_h, beta_h, breakdown_iter


def lanczos_segment(
    matvec: Callable,
    V: torch.Tensor,
    r: torch.Tensor,
    alpha_h: torch.Tensor,
    beta_h: torch.Tensor,
    breakdown_iter: torch.Tensor,
    j0: int,
    j1: int,
    *,
    reorth: str = "full",
    reorth_passes: int = 2,
    reorth_period: int = 5,
    dot: Callable = default_dot,
    basis_dot: Callable = local_basis_dot,
    breakdown_tol: Optional[float] = None,
    compensated: bool = False,
):
    """Run Lanczos steps j0..j1-1 from a warm state (the restartable core).

    ``V`` (n, M) holds rows [0, j0); ``r`` is the current unnormalized
    residual; ``alpha_h`` (n,) / ``beta_h`` (n-1,) are the histories filled
    up to j0.  Fills ``V``, ``alpha_h`` and ``beta_h`` in place and returns
    (V, r, alpha_h, beta_h, breakdown_iter).  ``reorth`` is one of full,
    none, periodic (selective's omega state does not survive a segment
    boundary); ``compensated=True`` runs every alpha/beta/norm reduction
    through ``dot2_rounded``.  Full reorthogonalization with the default
    ``dot`` and ``basis_dot`` and ``reorth_passes >= 2`` lags each row's
    last CGS update into the next step (``_lagged_row``), the same
    recurrence in exact arithmetic; every row is finished when the call
    returns.
    """
    dot = resolve_dot(dot, compensated)
    if reorth == "selective":
        raise ValueError(f"unknown reorth strategy: {reorth!r}")
    step = _row_step(reorth, reorth_passes, reorth_period, dot, basis_dot, alpha_h, j1)
    return _steps(matvec, V, r, alpha_h, beta_h, breakdown_iter, j0, j1, dot, step,
                  breakdown_tol)


def _start(matvec, v0, n, dot):
    """Normalize v0 and take the first step: (V with row 0 set, r, alpha_h)."""
    with span("lt.lanczos.start"):
        v0 = v0 / torch.sqrt(dot(v0, v0))
        V = torch.zeros((n, v0.shape[0]), dtype=v0.dtype, device=v0.device)
        V[0] = v0
        w = matvec(v0)
        alpha0 = dot(v0, w)
        alpha_h = torch.zeros(n, dtype=v0.dtype, device=v0.device)
        alpha_h[0] = alpha0
        return V, w - alpha0 * v0, alpha_h


def lanczos_kernel(
    matvec: Callable,
    v0: torch.Tensor,
    n: int,
    *,
    reorth: str = "full",
    reorth_passes: int = 2,
    reorth_period: int = 5,
    dot: Callable = default_dot,
    basis_dot: Callable = local_basis_dot,
    breakdown_tol: Optional[float] = None,
    compensated: bool = False,
) -> LanczosFactorization:
    """Run n Lanczos steps from the (M,) start vector v0 (need not be
    normalized).  ``reorth`` is one of full, none, periodic, selective;
    ``compensated=True`` runs the reductions through ``dot2_rounded``.
    Full reorthogonalization with the default ``dot`` and ``basis_dot`` and
    ``reorth_passes >= 2`` lags each row's last CGS update into the next
    step (``_lagged_row``); every other run keeps the plain recurrence."""
    dot = resolve_dot(dot, compensated)
    V, r, alpha_h = _start(matvec, v0, n, dot)
    step = _row_step(reorth, reorth_passes, reorth_period, dot, basis_dot, alpha_h, n)
    beta_h = torch.zeros(max(n - 1, 0), dtype=v0.dtype, device=v0.device)
    breakdown_iter = torch.tensor(n, dtype=torch.int64, device=v0.device)
    V, r, alpha_h, beta_h, breakdown_iter = _steps(
        matvec, V, r, alpha_h, beta_h, breakdown_iter, 1, n, dot, step, breakdown_tol)
    return LanczosFactorization(
        alpha=alpha_h, beta=beta_h, V=V, resid=r, breakdown_iter=breakdown_iter
    )


def lanczos(
    op: LinearOperator,
    n: int,
    *,
    seed: int = 99,
    v0=None,
    reorth: str = "full",
    reorth_passes: int = 2,
    reorth_period: int = 5,
    dtype=None,
    compensated: bool = False,
) -> LanczosFactorization:
    """High-level single-device entry point: n Lanczos steps of ``op`` on
    its device.

    ``v0`` (array-like or tensor, (M,)) defaults to Uniform(-1, 1) numbers
    from a ``torch.Generator`` seeded with ``seed``, drawn on the CPU so
    every device starts from the same vector.  ``dtype`` must be the
    operator's own (the default): the kernels take one dtype.
    ``compensated=True`` runs the recurrence's reductions through the
    error-free-transform dot (``ops/compensated.py``).  A row-sharded
    operator (``parallel/``) runs the same recurrence with its dots
    all-reduced over the mesh; ``V`` and ``resid`` are then this rank's
    rows, alpha and beta the same on every rank.
    """
    m = op.shape[0]
    if n > m:
        raise ValueError(f"n={n} cannot exceed operator dimension M={m}")
    dtype = _check_dtype(op, dtype)
    rows = Rows(op, compensated)
    return lanczos_kernel(
        op.matvec, _start_vector(op, v0, seed, dtype), n, reorth=reorth,
        reorth_passes=reorth_passes, reorth_period=reorth_period, dot=rows.dot,
        basis_dot=rows.basis_dot,
    )
