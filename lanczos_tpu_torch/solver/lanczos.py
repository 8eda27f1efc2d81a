"""Symmetric Lanczos recurrence on device tensors.

Counterpart of ``lanczos_tpu/solver/lanczos.py``.  The JAX package's
``lax.scan`` becomes a Python loop over tensors that stay on the device:
the loop launches work and never reads a value back (the breakdown guard is
a tensor ``where``), except on the selective path, which reads one flag per
step to decide whether to run a reorthogonalization pass.

* Full reorthogonalization is classical Gram-Schmidt run twice (CGS2): two
  matrix-vector products against the stored basis per pass, or on the card
  one fused kernel that reads the basis three times (``_orthogonalize``).
  The basis is sliced to its filled rows ``V[:j]``; the JAX package
  multiplies by the zero-padded ``(n, M)`` basis, whose zero rows
  contribute exactly 0.
* ``V`` is row-major ``(n, M)`` and is filled in place, as are the
  ``alpha``/``beta`` histories (PyTorch tensors are mutable; this saves a
  copy of the basis per step).
* Breakdown (beta ~ 0, an exact invariant subspace) is recorded in
  ``breakdown_iter`` and the recurrence continues with a zero vector.
* ``_start`` runs inside the span ``lt.lanczos.start`` and each recurrence
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
from ..ops.operators import LinearOperator

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


def _default_dot(a, b):
    return torch.dot(a, b)


def _default_basis_dot(V, v):
    # (j, M) x (M,) -> (j,)
    return V @ v


def _resolve_dot(dot, compensated: bool):
    """Swap the default vector-vector dot for the error-free-transform one
    (``ops/compensated.py:dot2_rounded``) when ``compensated``.

    Compensation targets the recurrence's reductions (alpha, beta, norms),
    whose plain float32 rounding floors the Ritz residuals; the
    reorthogonalization products stay plain (CGS2 corrects itself).  A
    custom ``dot`` is kept, with a warning.
    """
    if not compensated:
        return dot
    if dot is _default_dot:
        from ..ops.compensated import dot2_rounded

        return dot2_rounded
    import warnings

    warnings.warn(
        "compensated=True has no effect when a custom dot is supplied; "
        "compensation applies only to the default dot",
        stacklevel=3,
    )
    return dot


def _orthogonalize(V, v, basis_dot, passes: int):
    """Orthogonalize v against the rows of V, CGS x passes.

    An unsharded basis (the default ``basis_dot``) runs
    ``ops/cgs2_kernels.py:cgs2``: on the card its CUDA kernel, passes + 1
    sweeps over V instead of 2 x passes (2 x passes past one tile's rows),
    on the CPU the plain loop.  A row-sharded mesh's ``basis_dot``, which
    all-reduces each projection over the ranks, runs the plain loop with
    it.  Counts each call in ``COUNTERS["lt.cgs2.calls"]`` (the kernel's
    launches are ``COUNTERS["lt.cgs2.fused"]``); inside a CUDA graph both
    count the capture, not the replays.
    """
    COUNTERS["lt.cgs2.calls"] += 1
    if basis_dot is _default_basis_dot:
        return cgs2_kernels.cgs2(V, v, passes)
    return cgs2_kernels.cgs2_reference(V, v, passes, basis_dot)


def _normalized(v, dot):
    nrm = torch.sqrt(dot(v, v))
    return v * torch.where(nrm > 0, 1.0 / nrm, 0.0)


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
    dot: Callable = _default_dot,
    basis_dot: Callable = _default_basis_dot,
    breakdown_tol: Optional[float] = None,
    compensated: bool = False,
):
    """Run Lanczos steps j0..j1-1 from a warm state (the restartable core).

    ``V`` (n, M) holds rows [0, j0); ``r`` is the current unnormalized
    residual; ``alpha_h`` (n,) / ``beta_h`` (n-1,) are the histories filled
    up to j0.  Fills ``V``, ``alpha_h`` and ``beta_h`` in place and returns
    (V, r, alpha_h, beta_h, breakdown_iter).  ``compensated=True`` runs
    every alpha/beta/norm reduction through ``dot2_rounded``.
    """
    dot = _resolve_dot(dot, compensated)
    if reorth not in ("full", "none", "periodic"):
        raise ValueError(f"unknown reorth strategy: {reorth!r}")
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

            if reorth == "full" or (reorth == "periodic" and j % reorth_period == 0):
                v = _normalized(_orthogonalize(V[:j], v, basis_dot, reorth_passes), dot)

            V[j] = v
            w = matvec(v)
            alpha = dot(v, w)
            r = w - alpha * v - beta * V[j - 1]
            alpha_h[j] = alpha
            beta_h[j - 1] = beta
    return V, r, alpha_h, beta_h, breakdown_iter


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
    dot: Callable = _default_dot,
    basis_dot: Callable = _default_basis_dot,
    breakdown_tol: Optional[float] = None,
    compensated: bool = False,
) -> LanczosFactorization:
    """Run n Lanczos steps from the (M,) start vector v0 (need not be
    normalized).  ``reorth`` is one of full, none, periodic, selective;
    ``compensated=True`` runs the reductions through ``dot2_rounded``."""
    dot = _resolve_dot(dot, compensated)
    if reorth == "selective":
        return _lanczos_selective_kernel(
            matvec, v0, n, reorth_passes=reorth_passes, dot=dot,
            basis_dot=basis_dot, breakdown_tol=breakdown_tol,
        )
    if reorth not in ("full", "none", "periodic"):
        raise ValueError(f"unknown reorth strategy: {reorth!r}")
    V, r, alpha_h = _start(matvec, v0, n, dot)
    beta_h = torch.zeros(max(n - 1, 0), dtype=v0.dtype, device=v0.device)
    breakdown_iter = torch.tensor(n, dtype=torch.int64, device=v0.device)
    V, r, alpha_h, beta_h, breakdown_iter = lanczos_segment(
        matvec, V, r, alpha_h, beta_h, breakdown_iter, 1, n,
        reorth=reorth, reorth_passes=reorth_passes, reorth_period=reorth_period,
        dot=dot, basis_dot=basis_dot, breakdown_tol=breakdown_tol,
    )
    return LanczosFactorization(
        alpha=alpha_h, beta=beta_h, V=V, resid=r, breakdown_iter=breakdown_iter
    )


def _lanczos_selective_kernel(
    matvec, v0, n, *, reorth_passes, dot, basis_dot, breakdown_tol
):
    """Selective reorthogonalization via the omega recurrence (Simon 1984).

    Tracks running estimates omega[j, i] ~ |v_j . v_i| of orthogonality loss
    from the alpha/beta history alone (O(n) work per step), and runs a full
    reorthogonalization pass only on steps where max_i omega exceeds
    sqrt(machine eps); omega then resets to the machine-eps floor.  Deciding
    to skip the O(nM) pass reads one flag back per step.
    """
    dtype, device = v0.dtype, v0.device
    eps = float(torch.finfo(dtype).eps)
    threshold = np.sqrt(eps)
    noise = eps * 2.0
    if breakdown_tol is None:
        breakdown_tol = 10 * eps

    V, r, alpha_h = _start(matvec, v0, n, dot)
    beta_h = torch.zeros(n, dtype=dtype, device=device)  # beta_h[j]: norm before v_j
    # omega_prev: estimates for v_{j-1}; omega_curr: for v_j (index i over n).
    omega_prev = torch.zeros(n, dtype=dtype, device=device)
    omega_curr = torch.zeros(n, dtype=dtype, device=device)
    omega_curr[0] = 1.0
    breakdown_iter = torch.tensor(n, dtype=torch.int64, device=device)
    idx = torch.arange(n, device=device)

    COUNTERS["lt.lanczos.recurrence.steps"] += max(n - 1, 0)
    with span("lt.lanczos.recurrence"):
        for j in range(1, n):
            beta = torch.sqrt(dot(r, r))
            ok = beta > breakdown_tol
            breakdown_iter = torch.where(ok, breakdown_iter, breakdown_iter.clamp(max=j))
            v = r * torch.where(ok, 1.0 / torch.where(ok, beta, 1.0), 0.0)

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
                v = _normalized(_orthogonalize(V[:j], v, basis_dot, reorth_passes), dot)
                w_new = torch.where(idx < j, noise, w_new)
                omega_prev = torch.where(idx < j, noise, omega_curr)
            else:
                omega_prev = omega_curr
            omega_curr = w_new

            V[j] = v
            wv = matvec(v)
            alpha = dot(v, wv)
            r = wv - alpha * v - beta * V[j - 1]
            alpha_h[j] = alpha
            beta_h[j] = beta

    return LanczosFactorization(
        alpha=alpha_h, beta=beta_h[1:], V=V, resid=r, breakdown_iter=breakdown_iter
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
    from .rows import Rows, _check_dtype, _start_vector

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
