"""The port's block Lanczos against lanczos_tpu/solver/block.py, on the same
numpy-made inputs (the counterparts of tests/test_block_selective.py's block
tests).

Both packages start from the same numpy block where the API takes one.
Elsewhere each draws its own seeded start block (the replacement directions
of the breakdown cure too), and QR may flip basis columns, so outcomes are
compared (spectra, residuals, orthonormality), never the blocks themselves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.ops.operators import DenseOperator as JaxDense  # noqa: E402
from lanczos_tpu.solver import block as jb  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.convert import from_jax  # noqa: E402
from lanczos_tpu_torch.ops.operators import DenseOperator  # noqa: E402
from lanczos_tpu_torch.solver import block as pb  # noqa: E402
from lanczos_tpu_torch.solver.results import check_orthogonal  # noqa: E402

from conftest import random_sparse_symmetric  # noqa: E402


def _degenerate(seed, m, mult=3):
    """Symmetric matrix whose lowest eigenvalue (-5) has multiplicity mult."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    vals = np.concatenate([np.full(mult, -5.0), np.linspace(-1, 4, m - mult)])
    return (q * vals) @ q.T, np.sort(vals)


def _both(a):
    return JaxDense(jnp.asarray(a)), DenseOperator(torch.as_tensor(a))


def test_block_kernel_matches_jax_from_the_same_block():
    """Same numpy start block, fp64: the block Ritz values agree with JAX's
    to 1e-10 (the 3-fold -5 among them), and the basis is orthonormal."""
    a, exact = _degenerate(0, 120)
    opj, opp = _both(a)
    q0 = np.random.default_rng(1).standard_normal((120, 4))
    fj = jb.block_lanczos_kernel(opj.matmat, jnp.asarray(q0), 15)
    fp = pb.block_lanczos_kernel(opp.matmat, torch.as_tensor(q0), 15)
    tj = np.sort(np.asarray(jb.block_ritz(fj)[0]))
    tp, X, resid = pb.block_ritz(fp)
    np.testing.assert_allclose(np.sort(tp.numpy()), tj, atol=1e-10, rtol=0)
    np.testing.assert_allclose(np.sort(tp.numpy())[:3], exact[:3], atol=1e-8)
    assert check_orthogonal(fp.Q.reshape(60, 120).T) < 1e-10
    assert fp.a_blocks.shape == (15, 4, 4) and fp.b_blocks.shape == (14, 4, 4)
    # The residual estimates are honest for the converged triple.
    sel = torch.argsort(tp)[:3]
    explicit = torch.linalg.vector_norm(opp.A @ X[:, sel] - X[:, sel] * tp[sel], dim=0)
    assert float(explicit.max()) < 1e-7 and float(resid[sel].max()) < 1e-7


def test_block_ritz_on_a_jax_factorization():
    """block_ritz of the JAX factorization carried across with from_jax:
    JAX's Ritz values to 1e-12, and the same Ritz vectors up to sign."""
    a, _ = _degenerate(2, 100)
    opj, _ = _both(a)
    fj = jb.block_lanczos(opj, num_blocks=10, block_size=3, dtype=np.float64)
    tj, Xj, rj = (np.asarray(t) for t in jb.block_ritz(fj))
    tp, Xp, rp = pb.block_ritz(from_jax(fj, device="cpu"))
    np.testing.assert_allclose(tp.numpy(), tj, atol=1e-12, rtol=0)
    np.testing.assert_allclose(rp.numpy(), rj, atol=1e-10)
    # Columns of well-separated values are defined up to sign.
    sep = np.min(np.abs(np.diff(tj)), initial=np.inf, where=np.ones(len(tj) - 1, bool))
    if sep > 1e-6:
        signs = np.sign(np.sum(Xp.numpy() * Xj, axis=0))
        np.testing.assert_allclose(Xp.numpy() * signs, Xj, atol=1e-8)


def test_eigsh_block_size_two_double_ground_state():
    """eigsh(block_size=2) resolves the double ground state: values within
    1e-8 of JAX's, two orthogonal vectors."""
    rng = np.random.default_rng(11)
    d = np.concatenate([[1.0, 1.0], np.linspace(3.0, 20.0, 38)])
    Q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    A = (Q * d) @ Q.T
    A = (A + A.T) / 2
    opj, opp = _both(A)
    rj = lt.eigsh(opj, k=2, n=40, which="SA", block_size=2, dtype=np.float64)
    rp = pt.eigsh(opp, k=2, n=40, which="SA", block_size=2)
    np.testing.assert_allclose(rp.eigenvalues.numpy(), np.asarray(rj.eigenvalues), atol=1e-8)
    np.testing.assert_allclose(rp.eigenvalues.numpy(), [1.0, 1.0], atol=1e-8)
    X = rp.eigenvectors.numpy()
    np.testing.assert_allclose(X.T @ X, np.eye(2), atol=1e-6)
    assert rp.good_mask().all()


def test_restarted_resolves_multiplicity_bounded_basis():
    """k=6, b=4, 5 blocks a cycle (basis 30 rows) on the 400-dim 3-fold
    multiplet: values within 1e-8 of JAX's and of the exact ones."""
    a, exact = _degenerate(3, 400)
    opj, opp = _both(a)
    kw = dict(k=6, block_size=4, num_blocks=5, tol=1e-9, max_cycles=60)
    rj = jb.eigsh_block_restarted(opj, dtype=np.float64, **kw)
    rp = pt.eigsh_block_restarted(opp, **kw)
    lam = rp.eigenvalues.numpy()
    np.testing.assert_allclose(lam, np.asarray(rj.eigenvalues), atol=1e-8, rtol=0)
    np.testing.assert_allclose(lam, exact[:6], atol=1e-8, rtol=0)
    assert float(rp.residuals.max()) < 1e-8
    assert rp.cycles >= 1 and rp.eigenvectors.shape == (400, 6)


def test_restarted_fp32_sparse_ell():
    """float32 on a 600-dim sparse EllOperator, with the operator-verified
    (Rayleigh–Ritz) exit: JAX's fp32 values within JAX's own test
    tolerance (atol 5e-4, rtol 1e-4), and scipy's as well."""
    a = random_sparse_symmetric(np.random.default_rng(1234), 600)
    kw = dict(k=4, block_size=3, num_blocks=6, tol=2e-5, max_cycles=80)
    rj = jb.eigsh_block_restarted(lt.ell_from_scipy(a, dtype=np.float32), dtype="float32", **kw)
    rp = pt.eigsh_block_restarted(pt.ell_from_scipy(a, dtype=torch.float32, device="cpu"), **kw)
    assert rp.eigenvectors.dtype == torch.float32
    exact = np.sort(scipy.sparse.linalg.eigsh(a, k=4, which="SA", tol=1e-12)[0])
    lam = np.sort(rp.eigenvalues.numpy())
    np.testing.assert_allclose(lam, np.sort(np.asarray(rj.eigenvalues)), atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(lam, exact, atol=5e-4, rtol=1e-4)


def test_breakdown_rank_deficient():
    """A rank-6 operator exhausts the Krylov space after ~2 blocks: the
    cure keeps the basis orthonormal, and the model still has the six
    nonzero eigenvalues, as JAX's does."""
    B = np.random.default_rng(5).standard_normal((120, 6))
    A = B @ B.T
    opj, opp = _both(A)
    fj = jb.block_lanczos(opj, num_blocks=5, block_size=4, dtype=np.float64)
    fp = pb.block_lanczos(opp, num_blocks=5, block_size=4)
    assert check_orthogonal(fp.Q.reshape(20, 120).T) < 1e-8
    assert bool(torch.isfinite(fp.a_blocks).all() and torch.isfinite(fp.b_blocks).all())
    tp = np.sort(pb.block_ritz(fp)[0].numpy())[-6:]
    tj = np.sort(np.asarray(jb.block_ritz(fj)[0]))[-6:]
    np.testing.assert_allclose(tp, tj, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(tp, np.sort(np.linalg.eigvalsh(A))[-6:], rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("dtype,cond", [(torch.float64, 1.0), (torch.float64, 1e6),
                                         (torch.float32, 1.0), (torch.float32, 1e2)])
def test_tall_qr_matches_householder(dtype, cond):
    """Cholesky QR twice equals Householder QR up to column signs, keeps Q
    orthonormal to the dtype's rounding, and reproduces the block."""
    gen = np.random.default_rng(int(np.log10(cond)) + 3)
    u = np.linalg.qr(gen.standard_normal((3000, 4)))[0]
    v = np.linalg.qr(gen.standard_normal((4, 4)))[0]
    r = torch.as_tensor((u * np.logspace(0, -np.log10(cond), 4)) @ v.T, dtype=dtype)
    q, R, failed = pb._tall_qr(r)
    assert not bool(failed)
    qh, Rh = torch.linalg.qr(r)
    eps = float(torch.finfo(dtype).eps)
    signs = torch.sign(torch.diagonal(Rh))
    assert bool((torch.diagonal(R) > 0).all())
    np.testing.assert_allclose((q.T @ q).double().numpy(), np.eye(4), atol=50 * eps)
    np.testing.assert_allclose((q @ R).double().numpy(), r.double().numpy(), atol=50 * eps)
    np.testing.assert_allclose((qh * signs).double().numpy(), q.double().numpy(),
                               atol=50 * eps * cond)
    # A rank-deficient block fails Cholesky QR and takes Householder QR
    # (the cure then repairs it).
    r[:, 2] = 0
    assert bool(pb._tall_qr(r)[2])
    q0, R0 = pb._qr(r)
    assert torch.equal(q0, torch.linalg.qr(r)[0]) and float(R0[2, 2].abs()) < 1e-6


def test_cure_replaces_deficient_columns():
    """The cure itself: a residual block with a zero last column gets a
    replacement direction orthogonal to the basis and a zero coupling row,
    the block stays orthonormal and still spans r; a full-rank block
    passes through untouched."""
    gen = np.random.default_rng(9)
    basis = torch.as_tensor(np.linalg.qr(gen.standard_normal((50, 6)))[0].T.copy())
    r = torch.as_tensor(gen.standard_normal((50, 3)))
    r = pb._orth_block(basis, r)
    q, b = torch.linalg.qr(r)
    assert pb._qr_cure_breakdown(r, q, b, lambda c: pb._orth_block(basis, c), 0)[0] is q
    r[:, 2] = 0
    q, b = torch.linalg.qr(r)
    qf, bf = pb._qr_cure_breakdown(r, q, b, lambda c: pb._orth_block(basis, c), 3)
    # A recurrence step takes the same path: Cholesky QR fails, Householder
    # QR and the cure follow.
    qs, bs = pb._qr_step(r, lambda c: pb._orth_block(basis, c), 3)
    np.testing.assert_allclose((qs.T @ qs).numpy(), np.eye(3), atol=1e-12)
    assert float((basis @ qs).abs().max()) < 1e-12 and float(bs[2].abs().max()) == 0.0
    np.testing.assert_allclose((qf.T @ qf).numpy(), np.eye(3), atol=1e-12)
    assert float((basis @ qf).abs().max()) < 1e-12
    assert float(bf[2].abs().max()) == 0.0
    np.testing.assert_allclose((qf @ bf).numpy(), r.numpy(), atol=1e-12)


def test_restarted_regular_stencil_matches_jax():
    """On the regular-grid StencilOperator (N=8, fp64): within 1e-8 of JAX
    and of the dense spectrum, whose lowest values are -1.78e-5, 2.487531
    and the triplet 2.487617 (k = 4 stops inside the triplet, so both
    packages hold the same values)."""
    hj = lt.build_regular_hamiltonian(8, 25.0, lt.deuteron_potential_3d, stencil="27",
                                      dtype=np.float64)
    hp = pt.build_regular_hamiltonian(8, 25.0, pt.deuteron_potential_3d, stencil="27",
                                      dtype=torch.float64, device="cpu")
    kw = dict(k=4, block_size=4, tol=1e-10)
    rj = jb.eigsh_block_restarted(hj, dtype=np.float64, **kw)
    rp = pt.eigsh_block_restarted(hp, **kw)
    np.testing.assert_allclose(rp.eigenvalues.numpy(), np.asarray(rj.eigenvalues), atol=1e-8,
                               rtol=0)
    A = hp.to_scipy().toarray()
    exact = np.linalg.eigvalsh((A + A.T) / 2)[:4]
    np.testing.assert_allclose(rp.eigenvalues.numpy(), exact, atol=1e-8, rtol=0)


def test_restarted_stops_at_the_float32_floor():
    """In float32 the true residual stalls at the dtype's floor long before
    a tight tol: the solve stops once a verification no longer improves
    (two verifications), where the JAX package runs out max_cycles."""
    hp = pt.build_regular_hamiltonian(12, 25.0, pt.deuteron_potential_3d, stencil="27",
                                      dtype=torch.float32, device="cpu")
    res = pt.eigsh_block_restarted(hp, k=6, block_size=4, tol=1e-7, max_cycles=200)
    assert res.cycles < 40
    h64 = pt.build_regular_hamiltonian(12, 25.0, pt.deuteron_potential_3d, stencil="27",
                                       dtype=torch.float64, device="cpu")
    A = h64.to_scipy().toarray()
    exact = np.linalg.eigvalsh((A + A.T) / 2)[:6]
    gershgorin = float(h64.weights.abs().sum() + h64.diag.abs().max())
    eps32 = float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(res.eigenvalues.numpy(), exact, atol=eps32 * gershgorin, rtol=0)
    assert float(res.residuals.max()) <= 14 * eps32 * gershgorin


@pytest.mark.parametrize("case", ["n_locked_below_k", "basis_too_large", "v0", "compensated",
                                  "dimension_below_2b"])
def test_argument_checks_match_jax(case):
    """Each check raises ValueError in both packages."""
    a, _ = _degenerate(4, 40)
    opj, opp = _both(a)
    small_j, small_p = _both(np.eye(3))
    calls = {
        "n_locked_below_k": lambda lib, op: lib.eigsh_block_restarted(op, k=6, n_locked=4),
        "basis_too_large": lambda lib, op: lib.eigsh_block_restarted(op, k=6, num_blocks=10),
        "v0": lambda lib, op: lib.eigsh(op, k=2, n=8, block_size=2, v0=np.ones(40)),
        "compensated": lambda lib, op: lib.eigsh(op, k=2, n=8, block_size=2, compensated=True),
        "dimension_below_2b": lambda lib, op: lib.eigsh(op, k=1, n=2, block_size=2),
    }
    ops = (small_j, small_p) if case == "dimension_below_2b" else (opj, opp)
    for lib, op in ((jb if "locked" in case or "basis" in case else lt, ops[0]),
                    (pt, ops[1])):
        with pytest.raises(ValueError):
            calls[case](lib, op)
