"""Look-ahead two-sided Lanczos: curing serious breakdown with block pivots.

Counterpart of ``lanczos_tpu/solver/look_ahead.py`` (Freund, Gutknecht and
Nachtigal, SISC 1993).  The plain biorthogonal recurrence
(``solver/two_sided.py``) divides by w_j = r.s each step; when w_j ~ 0
while r and s are both healthy (a serious breakdown) it truncates.  Here
vectors are grouped into blocks, and a block closes only when its moment
matrix D_l = W_l V_l^T is safely nonsingular; projections use D_l^{-1}, so
a vanishing scalar pivot just grows the open block by one.  A block that
will not close within ``max_block`` vectors is an incurable breakdown: the
run stops at the last closed block and says so.

As in the JAX package, the pivot logic (D, its SVD and its inverse) runs on
the host in numpy float64, and every step projects against all closed
blocks, twice (the robust form).  The matvecs and the bases V, W and AV
stay on the operator's device in float64 (at N=120 they are 3 n M x 8 B).
The closed blocks' inverses form one block-diagonal (j, j) matrix, so a
projection pass is two GEMVs per vector (the JAX package loops over the
blocks, a few tiny launches each); both sides are equal in exact
arithmetic, since the closed blocks are biorthogonal to one another.
Eigenvalues come from the oblique pencil (W A V^T) y = theta (W V^T) y.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .._util import to_numpy
from ..ops.operators import LinearOperator
from .results import EigResult, acceptance_inner_prod
from .rows import _unsharded

__all__ = [
    "LookAheadFactorization",
    "two_sided_lanczos_lookahead",
    "lookahead_eigs",
]


@dataclasses.dataclass(frozen=True)
class LookAheadFactorization:
    """V, W: (j, M) float64 right/left bases (rows) on the operator's
    device, grouped into closed blocks.

    blocks: (start, end) index ranges, each with nonsingular
    D_l = W[start:end] V[start:end]^T.  ``incurable`` marks a run stopped by
    a block that would not close within max_block vectors.  AV holds the
    rows A V^T for the projected pencil (no extra matvecs).
    """

    V: torch.Tensor
    W: torch.Tensor
    AV: torch.Tensor
    blocks: Tuple[Tuple[int, int], ...]
    incurable: bool
    max_block_used: int

    @property
    def n(self) -> int:
        return 0 if not self.blocks else self.blocks[-1][1]


def _project_out(r, s, V, W, dinv, passes: int = 2):
    """Oblique projection against the closed rows [0, j) of V and W, with
    ``dinv`` the block-diagonal (j, j) of their blocks' D_l^{-1}:
    r -= V^T D^{-1} (W r), s -= W^T D^{-T} (V s), ``passes`` times."""
    for _ in range(passes):
        r = r - (dinv @ (W @ r)) @ V
        s = s - (dinv.T @ (V @ s)) @ W
    return r, s


def _as_vector(x, m: int, device) -> torch.Tensor:
    v = torch.as_tensor(x, dtype=torch.float64).to(device)
    if v.shape != (m,):
        raise ValueError(f"start vector of shape {tuple(v.shape)}, expected ({m},)")
    return v


def two_sided_lanczos_lookahead(
    op: LinearOperator,
    n: int,
    *,
    op_transpose: Optional[LinearOperator] = None,
    v0=None,
    w0=None,
    seed: int = 99,
    close_tol: float = 1e-8,
    max_block: int = 4,
) -> LookAheadFactorization:
    """Up to n steps of look-ahead two-sided Lanczos in float64 on ``op``'s
    device.

    ``op_transpose``: explicit A^T operator (a CompositeV2's ``transpose()``
    or an EllOperator's); else ``op.rmatvec``.  ``v0``/``w0`` default to
    Uniform(-1, 1) draws of ``np.random.default_rng(seed)`` (right vector
    first), as in the JAX package.  ``close_tol``: a block closes when its
    smallest singular value exceeds close_tol x its largest.  ``max_block``:
    the block size at which a breakdown is declared incurable.
    """
    _unsharded(op, "two_sided_lanczos_lookahead")
    m = op.shape[0]
    dev = op.device
    rng = np.random.default_rng(seed)
    r = _as_vector(v0 if v0 is not None else rng.uniform(-1, 1, m), m, dev)
    s = _as_vector(w0 if w0 is not None else rng.uniform(-1, 1, m), m, dev)

    def matvec(x):
        return op.matvec(x.to(op.dtype)).double()

    def rmatvec(x):
        if op_transpose is not None:
            return op_transpose.matvec(x.to(op_transpose.dtype)).double()
        return op.rmatvec(x.to(op.dtype)).double()

    V = torch.zeros((n, m), dtype=torch.float64, device=dev)
    W = torch.zeros_like(V)
    AV = torch.zeros_like(V)
    dinv = torch.zeros((n, n), dtype=torch.float64, device=dev)
    blocks = []
    open_start = 0
    incurable = False
    max_used = 1
    j = 0
    while j < n:
        rn, sn = to_numpy(torch.stack([torch.linalg.vector_norm(r),
                                       torch.linalg.vector_norm(s)]))
        if rn < 1e-300 or sn < 1e-300:
            break  # invariant subspace: benign termination
        V[j] = r / float(rn)
        W[j] = s / float(sn)
        AV[j] = matvec(V[j])

        # Try to close the open block [open_start, j + 1).
        D = to_numpy(W[open_start:j + 1] @ V[open_start:j + 1].T)
        svals = np.linalg.svd(D, compute_uv=False)
        bsize = j + 1 - open_start
        if svals[-1] > close_tol * max(svals[0], 1e-300):
            blocks.append((open_start, j + 1))
            dinv[open_start:j + 1, open_start:j + 1] = torch.as_tensor(
                np.linalg.inv(D), device=dev)
            max_used = max(max_used, bsize)
            open_start = j + 1
        elif bsize >= max_block:
            # Incurable: drop the unclosable block and stop.
            incurable = True
            break

        # The next candidate pair continues the Krylov spaces from the
        # newest vectors, obliquely projected against every closed block.
        r, s = AV[j], rmatvec(W[j])
        jc = open_start
        if jc:
            r, s = _project_out(r, s, V[:jc], W[:jc], dinv[:jc, :jc])
        j += 1

    jdone = blocks[-1][1] if blocks else 0
    return LookAheadFactorization(
        V=V[:jdone], W=W[:jdone], AV=AV[:jdone], blocks=tuple(blocks),
        incurable=incurable, max_block_used=max_used,
    )


def lookahead_eigs(
    fac: LookAheadFactorization,
    k: Optional[int] = None,
    *,
    op: Optional[LinearOperator] = None,
    residual_tol: float = 1e-3,
):
    """Ritz pairs from the oblique projection pencil S y = theta G y,
    S = W A V^T, G = W V^T (block diagonal, invertible by construction),
    solved on the host in float64.

    With ``op`` given: an EigResult of the real pairs whose true relative
    residual ||A x - theta x|| / (||x|| max(|theta|, 1)) is within
    ``residual_tol`` (the acceptance of ``two_sided_eigs``), on ``op``'s
    device; ``k`` caps their number.  Otherwise host numpy (vals, X),
    sorted by real part.
    """
    import scipy.linalg

    if fac.n == 0:
        raise ValueError("empty factorization (immediate incurable breakdown)")
    G = to_numpy(fac.W @ fac.V.T)
    S = to_numpy(fac.W @ fac.AV.T)
    vals, Y = scipy.linalg.eig(S, G)
    order = np.argsort(vals.real)
    vals, Y = vals[order], Y[:, order]

    Vt = fac.V.T

    def back(Yr):
        # V is real, so X = V^T Y takes real products on V's device.
        return Vt @ torch.as_tensor(np.ascontiguousarray(Yr), device=Vt.device)

    if op is None:
        if k is not None:
            vals, Y = vals[:k], Y[:, :k]
        return vals, to_numpy(torch.complex(back(Y.real), back(Y.imag)))

    real = np.abs(vals.imag) <= 1e-8 * np.maximum(np.abs(vals.real), 1.0)
    vals_r = vals[real].real
    X_r = back(Y[:, real].real)
    W_mat = op.matmat(X_r.to(op.dtype).contiguous()).double()
    R = W_mat - X_r * torch.as_tensor(vals_r, device=X_r.device)[None, :]
    xn = to_numpy(torch.linalg.vector_norm(X_r, dim=0))
    resid = to_numpy(torch.linalg.vector_norm(R, dim=0)) / np.maximum(xn, 1e-300) / np.maximum(
        np.abs(vals_r), 1.0)
    keep = np.nonzero(resid <= residual_tol)[0]
    if k is not None:
        keep = keep[:k]
    X_k = X_r[:, torch.as_tensor(keep, device=X_r.device)]
    X_k = X_k / torch.linalg.vector_norm(X_k, dim=0).clamp(min=1e-300)
    vecs = X_k.to(op.dtype)
    return EigResult(
        eigenvalues=torch.as_tensor(vals_r[keep], device=op.device),
        eigenvectors=vecs,
        residuals=torch.as_tensor(resid[keep], device=op.device),
        inner_prod=acceptance_inner_prod(op, vecs),
    )
