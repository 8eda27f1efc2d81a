"""Arnoldi + Krylov–Schur: the eigensolver for the non-symmetric operator.

Counterpart of ``lanczos_tpu/solver/arnoldi.py``.  The irregular lattice's
LSQ Laplacian is non-symmetric (models/irr_hamiltonian.py).  Arnoldi keeps
ONE orthonormal basis (condition number 1 by construction), costs one
matvec per step and needs no transpose operator, so it stays sound in fp32,
where the two-sided recurrence (solver/two_sided.py) collapses.

Krylov–Schur restarting (Stewart 2002) bounds the basis at m vectors: after
each cycle the real Schur form of the Rayleigh quotient is sorted, the k
wanted Schur vectors are locked, and the recurrence continues from the
cycle's residual against the locked block — A V_l = V_l T_l + v_next b^T
with T_l quasi-triangular.

The JAX package's ``lax.scan`` becomes a Python loop over device tensors;
the basis ``V`` and the Rayleigh quotient ``B`` are filled in place.  Each
step orthogonalizes against the filled rows ``V[:j+1]`` only (CGS2, two
GEMV pairs per pass); the JAX package multiplies by the whole zero-padded
basis, whose zero rows contribute exactly 0.  The Schur and eig of the small
projected matrix run on the host in float64 (numpy/scipy), as in JAX.

``eigs_nonsym``'s cycle is the counterpart of ``_ks_cycle_jit``: on a card
it runs as a CUDA graph (``solver/graphs.py``), so ``V``, ``B`` and the
breakdown counter are buffers of fixed address for the whole solve, which
the cycle, the Schur rotation and the reset of ``B`` update in place.

A CompositeV2 start vector must be multiplied by the operator's ``live``
mask: the dead slots carry an exact eigenvalue 0 (ops/composite2.py), which
an unmasked start vector brings into the Krylov space.  ``eigs_nonsym``
does not mask it (nor does the JAX package's); its callers do.  A
row-sharded operator's start vector is masked here, as the JAX package's
sharded branch masks it (``arnoldi.py:339-354``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .._util import to_numpy
from ..ops.cgs2_kernels import local_basis_dot
from ..ops.operators import LinearOperator
from .graphs import CycleGraphs
from .results import EigResult, acceptance_inner_prod
from .rows import Rows, _check_dtype, _start_vector, default_dot, resolve_dot

__all__ = ["ArnoldiFactorization", "arnoldi", "arnoldi_kernel", "eigs_nonsym"]


@dataclasses.dataclass(frozen=True)
class ArnoldiFactorization:
    """A V[:n].T = V[:n].T H[:n,:n] + H[n, n-1] V[n] e_n^T.

    V: (n+1, M) orthonormal rows; H: (n+1, n) upper Hessenberg.
    breakdown_iter: 0-d int64 tensor, first j where the new direction
    vanished (n if none) — an invariant subspace, benign.
    """

    V: torch.Tensor
    H: torch.Tensor
    breakdown_iter: torch.Tensor

    @property
    def n(self) -> int:
        return self.H.shape[1]


def _extend(matvec: Callable, V, B, j0: int, j1: int, breakdown_iter, reorth_passes: int,
            dot: Callable = default_dot, basis_dot: Callable = local_basis_dot):
    """Arnoldi steps j0..j1-1 into V (rows) and B (columns), in place;
    ``dot`` takes the norm of each new direction, ``basis_dot`` the
    Gram-Schmidt coefficients."""
    eps = float(torch.finfo(V.dtype).eps)
    for j in range(j0, j1):
        w = matvec(V[j])
        Vj = V[: j + 1]
        h = torch.zeros(j + 1, dtype=V.dtype, device=V.device)
        for _ in range(reorth_passes):
            c = basis_dot(Vj, w)
            w = w - c @ Vj
            h = h + c
        hn = torch.sqrt(dot(w, w))
        ok = hn > 10 * eps
        breakdown_iter = torch.where(ok, breakdown_iter, breakdown_iter.clamp(max=j))
        V[j + 1] = w * torch.where(ok, 1.0 / torch.where(ok, hn, 1.0), 0.0)
        B[: j + 1, j] = h
        B[j + 1, j] = hn
    return breakdown_iter


def arnoldi_kernel(
    matvec: Callable,
    v0: torch.Tensor,
    n: int,
    *,
    reorth_passes: int = 2,
    compensated: bool = False,
    dot: Callable = default_dot,
    basis_dot: Callable = local_basis_dot,
) -> ArnoldiFactorization:
    """n Arnoldi steps from v0 (need not be normalized), on v0's device.

    Orthogonalization is CGS with ``reorth_passes`` passes (CGS2 default —
    the classical twice-is-enough result).  ``compensated=True`` takes the
    norms with ``dot2_rounded`` (``ops/compensated.py``); ``dot`` and
    ``basis_dot`` are a row-sharded run's all-reduced reductions.
    """
    dot = resolve_dot(dot, compensated)
    m = v0.shape[0]
    V = torch.zeros((n + 1, m), dtype=v0.dtype, device=v0.device)
    V[0] = v0 / torch.sqrt(dot(v0, v0))
    H = torch.zeros((n + 1, n), dtype=v0.dtype, device=v0.device)
    bki = torch.tensor(n, dtype=torch.int64, device=v0.device)
    bki = _extend(matvec, V, H, 0, n, bki, reorth_passes, dot, basis_dot)
    return ArnoldiFactorization(V=V, H=H, breakdown_iter=bki)


def arnoldi(
    op: LinearOperator,
    n: int,
    *,
    seed: int = 99,
    v0=None,
    reorth_passes: int = 2,
    dtype=None,
    compensated: bool = False,
) -> ArnoldiFactorization:
    """Run n Arnoldi steps on op (no symmetry assumed), on its device.

    ``v0`` defaults to Uniform(-1, 1) numbers from a ``torch.Generator``
    seeded with ``seed``, drawn on the CPU.  A row-sharded operator's run
    keeps this rank's rows of the basis.
    """
    if n > op.shape[0]:
        raise ValueError("n cannot exceed operator dimension")
    dtype = _check_dtype(op, dtype)
    rows = Rows(op, compensated)
    return arnoldi_kernel(
        op.matvec, _start_vector(op, v0, seed, dtype), n, reorth_passes=reorth_passes,
        dot=rows.dot, basis_dot=rows.basis_dot,
    )


# ---------------------------------------------------------------------------
# Krylov–Schur restart cycle


def _ks_cycle(matvec, V, B, breakdown_iter, l: int, m: int, reorth_passes: int, dot,
              basis_dot):
    """Steps l..m-1 of a Krylov–Schur cycle into V and B, in place, with
    ``breakdown_iter`` reset to m first; returns it."""
    breakdown_iter.fill_(m)
    return _extend(matvec, V, B, l, m, breakdown_iter, reorth_passes, dot, basis_dot)


def _rotate_basis(V, Z, l: int):
    """In place: rows [0, l) of V become Z^T @ V[:m], row l the old
    residual row V[m], the rows after it zero.  Returns V."""
    m = V.shape[0] - 1
    V[:l] = Z.T @ V[:m]  # the product is a temporary, read whole before the write
    V[l] = V[m]
    V[l + 1:] = 0
    return V


def _schur_sort_select(Bm, which, k):
    """Sorted real Schur form of Bm; returns (T, Z, l) with the l wanted
    Ritz values leading, l >= k, never splitting a 2x2 block."""
    import scipy.linalg

    if which == "SR":
        keyfun = lambda x: -x.real
    elif which == "LR":
        keyfun = lambda x: x.real
    elif which == "LM":
        keyfun = lambda x: np.abs(x)
    else:
        raise ValueError("which must be SR, LR or LM")
    T, Z = scipy.linalg.schur(Bm, output="real")
    vals = scipy.linalg.eigvals(T)
    order = np.argsort(-np.asarray([keyfun(v) for v in vals]))
    kth = keyfun(vals[order[k - 1]])
    T, Z, sdim = _sorted_schur(Bm, which, kth)
    l = max(int(sdim), k)
    # Guard 2x2 block splitting: if T[l, l-1] != 0, extend by one.
    if l < Bm.shape[0] and abs(T[l, l - 1]) > 0:
        l += 1
    return T, Z, min(l, Bm.shape[0])


def _sorted_schur(Bm, which, kth):
    """``scipy.linalg.schur(Bm, sort=...)`` with the values whose key is at
    least ``kth`` leading.

    LAPACK's reordering may move a selected value across the threshold by
    rounding (a copy of a degenerate Ritz value that sits on it), and scipy
    then raises; the JAX package's ``_schur_sort_select`` stops the solve
    there.  Here the threshold is lowered past the rounding (64 eps ||Bm||_1
    at first, at most 1e6 times that) and the selection taken again: the
    same leading values, with such copies beside them."""
    import scipy.linalg

    margin = 64 * np.finfo(np.float64).eps * np.linalg.norm(Bm, 1)
    for relax in (0.0, margin, 1e3 * margin, 1e6 * margin):
        try:
            # f2py inspects the callback's arity: dgees passes (wr, wi) to a
            # two-arg select function, so the signature must be explicit.
            return scipy.linalg.schur(
                Bm, output="real",
                sort=lambda wr, wi: _sort_pred(complex(wr, wi), which, kth - relax),
            )
        except np.linalg.LinAlgError as e:
            if "sort condition" not in str(e) or relax == 1e6 * margin:
                raise


def _sort_pred(val, which, kth):
    if which == "SR":
        return -val.real >= kth
    if which == "LR":
        return val.real >= kth
    return abs(val) >= kth


def eigs_nonsym(
    op: LinearOperator,
    k: int = 6,
    *,
    max_basis: int = 0,
    tol: float = 1e-6,
    max_cycles: int = 60,
    which: str = "SR",
    seed: int = 99,
    v0=None,
    dtype=None,
    reorth_passes: int = 2,
    compensated: bool = False,
    verbose: bool = False,
) -> EigResult:
    """k eigenpairs of a general (non-symmetric) operator by Krylov–Schur,
    on the operator's device.

    which: "SR" (smallest real part), "LR", or "LM".
    tol:   true relative residual ||A x - lam x|| / max(|lam|, 1).
    Returns an EigResult of the k best-verified pairs (real parts;
    eigenvalues and residuals in float64).  The run stops when every pair's
    true residual is below ``tol``, when two verifications in a row fail to
    improve the worst residual by 1.2x, or after ``max_cycles``.
    ``compensated=True`` takes each cycle's norms with ``dot2_rounded``.

    A row-sharded operator (``parallel/``) keeps the basis row-sharded:
    every rank holds its rows of V and of the eigenvectors, and the
    Gram-Schmidt products, norms and verification residuals are
    all-reduced over its mesh (``solver/rows.py``); the start vector is
    multiplied by the operator's ``live`` rows (ghost and dead slots).
    """
    rows = Rows(op, compensated)
    mdim = op.shape[0]
    dtype = _check_dtype(op, dtype)
    m = max_basis or max(2 * k + 30, k + 12)
    m = min(m, mdim - 1)

    v0 = _start_vector(op, v0, seed, dtype)
    V = torch.zeros((m + 1, rows.n), dtype=dtype, device=op.device)
    V[0] = v0 / rows.norm(v0)
    B = torch.zeros((m + 1, m), dtype=dtype, device=op.device)
    bki = torch.empty((), dtype=torch.int64, device=op.device)
    graphs = CycleGraphs(op)
    l = 0
    best = None
    best_worst = np.inf
    stall = 0

    for cycle in range(max_cycles):
        graphs.run(("krylov_schur", l, m, reorth_passes, compensated, dtype), _ks_cycle,
                   op.matvec, V, B, bki, l, m, reorth_passes, rows.dot, rows.basis_dot)
        Bh = to_numpy(B).astype(np.float64)
        Bm = Bh[:m, :m]
        bout = float(Bh[m, m - 1])
        if not np.isfinite(Bm).all() or not np.isfinite(bout):
            raise FloatingPointError(
                f"non-finite Rayleigh quotient in Krylov-Schur cycle {cycle}: "
                f"operator overflow in {dtype} or an invalid start vector"
            )

        T, Z, l_new = _schur_sort_select(Bm, which, min(k + 8, m - 2))
        # Residual couplings: A (V Z) = (V Z) T + v_m (bout e_m^T Z).
        b_new = bout * Z[m - 1, :l_new]

        # Ritz pairs + model residual from the leading Schur block.
        import scipy.linalg

        vals, Y = scipy.linalg.eig(T[:l_new, :l_new])
        mres = np.abs(b_new @ Y)  # model residual |b^T y| per Ritz vector

        order = np.argsort(vals.real if which == "SR" else -vals.real)
        vals, Y, mres = vals[order], Y[:, order], mres[order]
        scale = np.maximum(np.abs(vals.real), 1.0)
        conv = (mres[:k] / scale[:k] < tol).all()
        if verbose:
            print(
                f"cycle {cycle}: ritz[0]={vals[0].real:.8g} "
                f"max-model-resid(k)={float((mres[:k] / scale[:k]).max()):.2e}"
            )

        # Truncate: rotate basis to the l_new leading Schur vectors.
        _rotate_basis(V, torch.as_tensor(Z[:, :l_new], dtype=dtype, device=op.device), l_new)
        B.zero_()
        B[:l_new, :l_new] = torch.as_tensor(T[:l_new, :l_new], dtype=dtype, device=op.device)
        B[l_new, :l_new] = torch.as_tensor(b_new, dtype=dtype, device=op.device)
        l = l_new

        if conv or cycle == max_cycles - 1:
            # Verify against the operator itself (the model residual can
            # drift from the true one in fp32), in float64 on the device.
            Yr = torch.as_tensor(Y.real[:, :k], dtype=torch.float64, device=op.device)
            Xk = V[:l].double().T @ Yr
            Xk = Xk / rows.col_norms(Xk).clamp_min(1e-300)
            lam = torch.as_tensor(vals[:k].real.copy(), device=op.device)
            R = op.matmat(Xk.to(dtype).contiguous()).double() - Xk * lam
            tres = to_numpy(rows.col_norms(R)) / scale[:k]
            worst = float(tres.max())
            if verbose:
                print(f"  verify: max-true-rel-resid={worst:.2e}")
            if worst < best_worst / 1.2:
                stall = 0  # noise-level wiggles below 1.2x must not reset it
            else:
                stall += 1
            if worst < best_worst:
                best, best_worst = (vals[:k].real.copy(), Xk, tres), worst
            if worst < tol or stall >= 2:
                break

    lam, Xk, tres = best
    vecs = Xk.to(dtype).contiguous()
    return EigResult(
        eigenvalues=torch.as_tensor(lam, device=op.device),
        eigenvectors=vecs,
        residuals=torch.as_tensor(tres, device=op.device),
        inner_prod=acceptance_inner_prod(op, vecs),
    )
