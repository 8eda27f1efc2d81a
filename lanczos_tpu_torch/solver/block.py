"""Block Lanczos: the SpMM path for clustered and degenerate spectra.

Counterpart of ``lanczos_tpu/solver/block.py``.  Each step applies the
operator to an (M, b) block in one ``op.matmat`` (the stencil SpMM kernel
on a card) and resolves degenerate clusters up to multiplicity b, which
single-vector Lanczos cannot separate.

Recurrence (basis blocks stored row-major (b, M), like the single-vector
basis; the working block is carried as a contiguous (M, b) tensor, so the
SpMM never copies its operand):

    W   = A Q_j^T            (SpMM)
    A_j = Q_j W              (b x b, symmetric)
    R   = W - Q_j^T A_j - Q_{j-1}^T B_{j-1}^T
    [CGS2 of R against the filled basis rows]
    Q_{j+1}^T B_j = qr(R)    (tall-skinny QR: Cholesky QR twice)

The ``lax.scan`` and ``lax.cond`` of the JAX package become a Python loop
over device tensors that fills the basis in place; orthogonalization runs
against the filled rows only (the JAX package multiplies by the whole
zero-padded basis, whose zero rows contribute exactly 0).  The replacement
directions of the breakdown cure come from a ``torch.Generator`` salted by
the step, so they are not JAX's: compare outcomes, not bits.  QR's signs
may differ from JAX's too, which flips basis columns and changes the blocks
by a +-1 similarity; the spectra do not change.

The tall-skinny QR is Cholesky QR twice on the device (:func:`_tall_qr`),
not ``torch.linalg.qr``: on an H100 80GB HBM3 at 700 W, cuSOLVER's
Householder QR of a (160^3, 4) block took 22 ms, most of a step
(``scripts/profile_torch_block.py``).  A step of ``block_lanczos`` reads
b + 1 flags back (a failed Cholesky QR, the deficient columns) and then
takes Householder QR or the cure.

A thick-restart cycle of ``eigsh_block_restarted`` is the counterpart of
``_block_cycle_jit``, whose cure is a ``lax.cond`` inside the compiled
cycle.  Here the branch is taken per cycle: the cycle runs speculatively
(:func:`_block_cycle` with ``flags``: Cholesky QR twice, no cure, no host
read; each step writes its b + 1 flags into a device buffer), on a card as
a CUDA graph replay (``solver/graphs.py``).  The flags are read once, with
the cycle's blocks; where one is set, the cycle is run again from the same
start, eagerly and checked, which is the eager solve's cycle.  Where none
is set, the speculative cycle is the checked one, op for op: the cure
returns its inputs when no column is deficient.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._util import to_numpy
from ..ops.operators import LinearOperator
from .arnoldi import _check_dtype
from .graphs import CycleGraphs
from .graphs import stats as graph_stats
from .rows import Rows, _unsharded
from .restart import _refine_host, _ritz_update
from .results import EigResult, acceptance_inner_prod

__all__ = [
    "BlockLanczosFactorization",
    "block_lanczos",
    "block_lanczos_kernel",
    "block_ritz",
    "eigsh_block_restarted",
]

#: Seed of the breakdown cure's replacement directions (salted by the step),
#: the counterpart of the JAX package's ``PRNGKey(1718)``.
_CURE_SEED = 1718


@dataclasses.dataclass(frozen=True)
class BlockLanczosFactorization:
    """A Q^T ~ Q^T T with Q the stacked blocks, T block tridiagonal.

    a_blocks:    (nb, b, b) diagonal blocks (symmetric).
    b_blocks:    (nb-1, b, b) subdiagonal blocks (upper triangular, from QR).
    Q:           (nb, b, M) orthonormal basis blocks (rows are vectors).
    resid_block: (M, b) final residual block (unnormalized).
    """

    a_blocks: torch.Tensor
    b_blocks: torch.Tensor
    Q: torch.Tensor
    resid_block: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return self.a_blocks.shape[0]

    @property
    def block_size(self) -> int:
        return self.a_blocks.shape[1]


def _orth_block(basis, r):
    """Orthogonalize the (M, b) block r against the rows of the (K, M)
    basis, CGS2.  The coefficients are formed as (r^T basis^T)^T, the
    orientation of the long reduction that cuBLAS runs faster on an H100
    (``scripts/profile_torch_block.py``)."""
    for _ in range(2):
        r = r - basis.T @ (r.T @ basis.T).T
    return r


def _tall_qr(r):
    """(Q, R, failed) of a tall (M, b) block by Cholesky QR twice, on the
    block's device: R_k^T R_k = Q_k^T Q_k with the b x b Gram matrix summed
    in float64, then Q_{k+1} = Q_k R_k^-1; R has a positive diagonal.
    Nothing is read back: ``failed`` (a 0-d bool tensor) is set when a Gram
    matrix was not numerically positive definite (a rank-deficient block),
    and the caller then takes Householder QR (:func:`_qr`, :func:`_qr_step`)."""
    eye = torch.eye(r.shape[1], dtype=torch.float64, device=r.device)
    q, R = r, eye
    failed = torch.zeros((), dtype=torch.bool, device=r.device)
    for _ in range(2):
        q64 = q.double()
        L, info = torch.linalg.cholesky_ex(q64.T @ q64)
        inv = torch.linalg.solve_triangular(L.T, eye, upper=True)
        q = q @ inv.to(q.dtype)
        R = L.T @ R
        failed = failed | (info != 0)
    return q.contiguous(), R.to(r.dtype), failed


def _qr(r):
    """(Q, R) of a tall (M, b) block: Cholesky QR twice, or Householder QR
    where that fails (one host read)."""
    q, R, failed = _tall_qr(r)
    return torch.linalg.qr(r) if bool(failed) else (q, R)


def _deficient(b_j):
    """The columns whose diagonal entry of B_j is below sqrt(eps) x the
    largest: directions that carry no residual mass."""
    diag = b_j.diagonal().abs()
    finfo = torch.finfo(b_j.dtype)
    return diag <= float(np.sqrt(finfo.eps)) * diag.max().clamp(min=finfo.tiny)


def _qr_cure_breakdown(r, q_next, b_j, orth_fn, j: int, bad=None):
    """Block-Lanczos breakdown cure for a (near-)rank-deficient residual
    block, the degenerate-multiplet case this solver targets.

    QR of a rank-deficient r returns arbitrary columns for the deficient
    directions (near-zero diagonal in b_j, not orthogonal to the basis).
    The cure (Golub–Underwood deflation) replaces them with random
    directions orthogonalized against the whole basis, orthonormalizes
    again, and zeroes their coupling rows in b_j: those directions carry
    only ~eps of residual mass.

    orth_fn: projects an (M, b) block against the current basis.
    j:       the step, which salts the replacement directions.
    bad:     the deficient columns as host flags, when the caller has read
             them (else they are read here).
    """
    if bad is None:
        bad = to_numpy(_deficient(b_j))
    if not bad.any():
        return q_next, b_j
    mask = torch.as_tensor(bad, device=q_next.device)
    gen = torch.Generator(device=q_next.device).manual_seed(_CURE_SEED * 1_000_003 + j)
    rnd = torch.randn(tuple(q_next.shape), generator=gen, dtype=q_next.dtype,
                      device=q_next.device)
    q_fix = _qr(orth_fn(torch.where(mask[None, :], rnd, q_next)))[0]
    b_fix = q_fix.T @ r
    b_fix[mask] = 0
    return q_fix, b_fix


def _qr_step(r, orth_fn, j: int):
    """Q_{j+1}, B_j = qr(r) for a step of the recurrence, with the breakdown
    cure, and one host read of b + 1 flags (a failed Cholesky QR, the
    deficient columns): the step's only synchronization."""
    q, R, failed = _tall_qr(r)
    flags = to_numpy(torch.cat([failed[None], _deficient(R)]))
    if flags[0]:
        q, R = torch.linalg.qr(r)
        return _qr_cure_breakdown(r, q, R, orth_fn, j)
    return _qr_cure_breakdown(r, q, R, orth_fn, j, bad=flags[1:])


def _sym(a):
    return 0.5 * (a + a.T)


def block_lanczos_kernel(matmat, q0: torch.Tensor, num_blocks: int) -> BlockLanczosFactorization:
    """num_blocks blocks of block Lanczos from the (M, b) start block q0
    (orthonormalized here), on q0's device."""
    m, b = q0.shape
    q = _qr(q0)[0]
    Q = torch.zeros((num_blocks, b, m), dtype=q0.dtype, device=q0.device)
    Q[0] = q.T
    a_blocks, b_blocks = [], []
    for j in range(num_blocks - 1):
        w = matmat(q)
        a_j = _sym(q.T @ w)
        r = w - q @ a_j
        if j > 0:
            r = r - Q[j - 1].T @ b_blocks[-1].T
        basis = Q[: j + 1].reshape((j + 1) * b, m)
        r = _orth_block(basis, r)
        q_next, b_j = _qr_step(r, lambda c: _orth_block(basis, c), j)
        q = q_next.contiguous()
        Q[j + 1] = q.T
        a_blocks.append(a_j)
        b_blocks.append(b_j)
    # The last diagonal block and the residual block that the next step
    # would orthonormalize: it gives the Ritz residual estimates.
    w = matmat(q)
    a_last = _sym(q.T @ w)
    a_blocks.append(a_last)
    resid_block = w - q @ a_last
    if b_blocks:
        resid_block = resid_block - Q[num_blocks - 2].T @ b_blocks[-1].T
    return BlockLanczosFactorization(
        a_blocks=torch.stack(a_blocks),
        b_blocks=torch.stack(b_blocks) if b_blocks else q.new_zeros((0, b, b)),
        Q=Q,
        resid_block=resid_block,
    )


def _start_block(op, b: int, seed: int, dtype) -> torch.Tensor:
    """An (M, b) standard-normal block from a ``torch.Generator`` seeded
    with ``seed``, drawn on the CPU and moved to the operator's device."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((op.shape[0], b), generator=gen, dtype=dtype).to(op.device)


def block_lanczos(
    op: LinearOperator,
    num_blocks: int,
    block_size: int = 4,
    *,
    seed: int = 99,
    dtype=None,
) -> BlockLanczosFactorization:
    """Run ``num_blocks`` blocks of block Lanczos on ``op``'s device from a
    seeded random (M, block_size) start block."""
    _unsharded(op, "block_lanczos")
    if num_blocks * block_size > op.shape[0]:
        raise ValueError("num_blocks * block_size cannot exceed dimension M")
    dtype = _check_dtype(op, dtype)
    return block_lanczos_kernel(op.matmat, _start_block(op, block_size, seed, dtype), num_blocks)


def block_ritz(fac: BlockLanczosFactorization):
    """(theta, X, resid_est) from a block factorization.

    Builds the dense block-tridiagonal T (nb*b, nb*b), decomposes it in
    float64 on the device (as ``tridiag_eigh`` does T), back-transforms
    through the stacked basis, and estimates residuals from the last block
    row: ||A x_i - theta_i x_i|| ~ ||R_last W[last block, i]||.
    """
    nb, b = fac.num_blocks, fac.block_size
    n = nb * b
    m = fac.Q.shape[2]
    dtype = fac.a_blocks.dtype
    t = torch.zeros((n, n), dtype=torch.float64, device=fac.Q.device)
    for j in range(nb):
        t[j * b:(j + 1) * b, j * b:(j + 1) * b] = fac.a_blocks[j]
    # A Qc_j = Qc_{j-1} B_{j-1}^T + Qc_j A_j + Qc_{j+1} B_j (B upper
    # triangular from QR), so T_{j+1,j} = B_j and T_{j,j+1} = B_j^T.
    for j in range(nb - 1):
        t[(j + 1) * b:(j + 2) * b, j * b:(j + 1) * b] = fac.b_blocks[j]
        t[j * b:(j + 1) * b, (j + 1) * b:(j + 2) * b] = fac.b_blocks[j].T
    theta, w = torch.linalg.eigh(t)
    theta, w = theta.to(dtype), w.to(dtype)
    x = fac.Q.reshape(n, m).T @ w
    resid = torch.linalg.vector_norm(fac.resid_block @ w[-b:, :], dim=0)
    return theta, x, resid


def _block_cycle(matmat, V, q0, l: int, nb: int, b: int, flags=None):
    """One thick-restart block cycle: blocks 0..nb-1 from the contiguous
    (M, b) start block q0, written into rows [l, l + nb*b) of V in place and
    deflated against the locked rows V[:l] by CGS2 over the filled rows.
    Returns (a_blocks (nb,b,b), b_blocks (nb-1,b,b), resid (M, b) orthogonal
    to the whole basis).

    Without ``flags`` each step's QR is checked on the host and cured
    (:func:`_qr_step`).  With ``flags``, an (nb-1, b+1) bool buffer, the
    cycle is speculative: each step takes Cholesky QR twice, never cures,
    reads nothing back, and writes (failed, the deficient columns) into
    ``flags[j]``; where no flag is set, its result is the checked cycle's.
    It reads only V[:l] and q0, so a checked cycle from the same V and q0
    replaces it exactly."""
    V[l:l + b] = q0.T
    q = q0
    a_blocks, b_blocks = [], []
    for j in range(nb - 1):
        w = matmat(q)
        a_j = _sym(q.T @ w)
        r = w - q @ a_j
        # CGS2 against the filled rows removes the previous block's B^T
        # component and the locked coupling in one sweep.
        basis = V[: l + (j + 1) * b]
        r = _orth_block(basis, r)
        if flags is None:
            q_next, b_j = _qr_step(r, lambda c: _orth_block(basis, c), j)
        else:
            q_next, b_j, failed = _tall_qr(r)
            flags[j, 0] = failed
            flags[j, 1:] = _deficient(b_j)
        q = q_next.contiguous()
        V[l + (j + 1) * b:l + (j + 2) * b] = q.T
        a_blocks.append(a_j)
        b_blocks.append(b_j)
    w = matmat(q)
    a_last = _sym(q.T @ w)
    a_blocks.append(a_last)
    resid = _orth_block(V[: l + nb * b], w - q @ a_last)
    bb = torch.stack(b_blocks) if b_blocks else q.new_zeros((0, b, b))
    return torch.stack(a_blocks), bb, resid


def _read_cycle(a_blocks, b_blocks, flags=None):
    """(a_blocks, b_blocks) in float64 on the host and whether any flag is
    set, in one read."""
    parts = [a_blocks.reshape(-1), b_blocks.reshape(-1)]
    if flags is not None:
        parts.append(flags.any().to(a_blocks.dtype)[None])
    host = to_numpy(torch.cat(parts)).astype(np.float64)
    n_a, n_b = a_blocks.numel(), b_blocks.numel()
    flagged = flags is not None and bool(host[n_a + n_b])
    return (host[:n_a].reshape(a_blocks.shape), host[n_a:n_a + n_b].reshape(b_blocks.shape),
            flagged)


def _refined_block(op, V, k: int, which: str):
    """Rayleigh–Ritz of the locked block V[:k] against the operator, in
    ``which`` order: (lam, Xr, true_resid)."""
    lam, Xr, tres, _ = _refine_host(op, V[:k].T, Rows(op))
    order = np.argsort(lam) if which == "SA" else np.argsort(-lam)
    return lam[order], Xr[:, torch.as_tensor(order, device=Xr.device)], tres[order]


def eigsh_block_restarted(
    op: LinearOperator,
    k: int = 10,
    block_size: int = 4,
    *,
    num_blocks: int = 0,
    n_locked: int = 0,
    tol: float = 1e-6,
    max_cycles: int = 60,
    which: str = "SA",
    seed: int = 99,
    dtype=None,
    verbose: bool = False,
) -> EigResult:
    """Thick-restart BLOCK Lanczos: degenerate multiplets in a bounded basis,
    on ``op``'s device.

    Single-vector thick restart (``eigsh_restarted``) finds at most one
    copy of each degenerate eigenvalue per Krylov space; the unrestarted
    ``block_lanczos`` resolves multiplicity <= block_size but its basis
    grows without bound.  This routine combines them (block Wu–Simon):
    after each cycle the l best Ritz vectors are locked, the recurrence
    restarts from the (M, b) residual block, and the projected matrix is
    arrowhead plus block tridiagonal:

        B = [[diag(theta_1..l),  C^T],
             [C,  block-tridiag(A_j, B_j)]],     C = S Y_last (b, l)

    with S the QR factor of the cycle's residual block.  Residual estimates
    are ||S y_i[last b]||, with no extra SpMM; B's eigenproblem runs on the
    host in float64.  Convergence is verified against the operator itself
    (Rayleigh–Ritz, ``restart._refine_host``).

    On a card every cycle after the first replays a CUDA graph of the
    speculative cycle (one capture per (l, nb, b, dtype)), and a cycle in
    which a step broke down is run again eagerly with the cure
    (``graphs.stats["redo"]`` counts them; see the module docstring).

    num_blocks: blocks per cycle (default max(ceil((2k + 20) / b), 4)).
    n_locked:   Ritz vectors carried across restarts (default k + max(b, 4)).
    seed:       the start block's ``torch.Generator`` seed (drawn on the CPU).
    """
    _unsharded(op, "eigsh_block_restarted")
    b = int(block_size)
    mdim = op.shape[0]
    dtype = _check_dtype(op, dtype)
    dev = op.device
    if which not in ("SA", "LA"):
        raise ValueError("which must be SA or LA")
    nb = num_blocks or max(-(-(2 * k + 20) // b), 4)
    l_keep = n_locked or min(k + max(b, 4), nb * b - b)
    if l_keep < k:
        raise ValueError(f"n_locked={l_keep} < k={k}")
    mtot = l_keep + nb * b
    if mtot >= mdim:
        raise ValueError(
            f"basis {mtot} (n_locked={l_keep} + {nb}x{b}) must be smaller "
            f"than the operator dimension {mdim}"
        )

    # The cycle's inputs, at fixed addresses for the whole solve: the basis
    # V, the start block q0 (the restart block is copied into it) and the
    # steps' flags.
    q0 = _qr(_start_block(op, b, seed, dtype))[0].contiguous()
    V = torch.zeros((mtot + 1, mdim), dtype=dtype, device=dev)
    flags = torch.zeros((nb - 1, b + 1), dtype=torch.bool, device=dev)
    graphs = CycleGraphs(op)
    theta = np.zeros(0)
    C = np.zeros((b, 0))
    l = 0
    refined = None
    best_rel = np.inf
    cycles = 0

    for cycle in range(max_cycles):
        cycles = cycle + 1
        a_blocks, b_blocks, resid = graphs.run(("block", l, nb, b, dtype), _block_cycle,
                                               op.matmat, V, q0, l, nb, b, flags)
        ab, bb, flagged = _read_cycle(a_blocks, b_blocks, flags)
        if flagged:
            # A step broke down: the cycle again from the same V[:l] and q0,
            # checked and cured (the lax.cond's other branch).
            graph_stats["redo"] += 1
            a_blocks, b_blocks, resid = _block_cycle(op.matmat, V, q0, l, nb, b)
            ab, bb, _ = _read_cycle(a_blocks, b_blocks)
        mt = l + nb * b
        B = np.zeros((mt, mt))
        if l:
            B[:l, :l] = np.diag(theta)
            B[l:l + b, :l] = C
            B[:l, l:l + b] = C.T
        for j in range(nb):
            B[l + j * b:l + (j + 1) * b, l + j * b:l + (j + 1) * b] = ab[j]
        for j in range(nb - 1):
            B[l + (j + 1) * b:l + (j + 2) * b, l + j * b:l + (j + 1) * b] = bb[j]
            B[l + j * b:l + (j + 1) * b, l + (j + 1) * b:l + (j + 2) * b] = bb[j].T
        if not np.isfinite(B).all():
            raise FloatingPointError(
                f"non-finite projected matrix in block-restart cycle {cycle} "
                f"(operator overflow in {dtype} or degenerate start block)"
            )
        w_all, y_all = np.linalg.eigh(B)
        order = np.argsort(w_all) if which == "SA" else np.argsort(-w_all)
        w_all, y_all = w_all[order], y_all[:, order]

        q_res, S_dev = _qr(resid)
        S = to_numpy(S_dev).astype(np.float64)
        est = np.linalg.norm(S @ y_all[mt - b:, :], axis=0)
        rel = est / np.maximum(np.abs(w_all), 1e-30)
        if verbose:
            print(f"block cycle {cycle}: theta[0]={w_all[0]:.8g} "
                  f"max-rel-resid(k)={rel[:k].max():.2e}", flush=True)
        converged = bool((rel[:k] < tol).all())

        l_new = min(l_keep, mt - b)
        e_pad = np.zeros((mtot, l_new))
        e_pad[:mt] = y_all[:, :l_new]
        _ritz_update(V, torch.as_tensor(e_pad, dtype=dtype, device=dev), l_new)
        theta = w_all[:l_new]
        C = S @ y_all[mt - b:, :l_new]
        l = l_new
        q0.copy_(q_res)

        if not converged:
            continue
        # Verify against the operator itself: in float32 the model drifts
        # from it, as in eigsh_restarted's rr_verify.
        lam, Xr, tres = _refined_block(op, V, k, which)
        trel = tres / np.maximum(np.abs(lam), 1e-30)
        worst = float(trel.max())
        if verbose:
            print(f"  verify: max-true-rel-resid={worst:.2e}", flush=True)
        improved = worst < best_rel / 1.3
        if refined is None or worst < best_rel:
            refined, best_rel = (lam, Xr, tres), worst
        if (trel < tol).all() or not improved:
            # Converged against A itself, or at the precision floor of the
            # working dtype, where more cycles do not help (the JAX package
            # stops only when a verification is worse, and so runs every
            # remaining cycle at the floor).
            break

    if refined is None:
        refined = _refined_block(op, V, k, which)
    lam, Xr, tres = refined
    vecs = Xr.contiguous()
    return EigResult(
        eigenvalues=torch.as_tensor(lam, device=dev),
        eigenvectors=vecs,
        residuals=torch.as_tensor(tres, device=dev),
        inner_prod=acceptance_inner_prod(op, vecs),
        cycles=cycles,
    )
