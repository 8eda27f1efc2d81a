"""The port's look-ahead two-sided Lanczos against
lanczos_tpu/solver/look_ahead.py (the counterparts of
tests/test_look_ahead.py), on the same numpy start vectors.

The port projects with one block-diagonal D^{-1} where the JAX package
loops over the closed blocks; the two agree in exact arithmetic, so the
bases and values are compared to rounding-level tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.ops.operators import DenseOperator as JaxDense  # noqa: E402
from lanczos_tpu.solver import look_ahead as jla  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.convert import from_jax  # noqa: E402
from lanczos_tpu_torch.ops.operators import DenseOperator  # noqa: E402
from lanczos_tpu_torch.solver import look_ahead as pla  # noqa: E402
from lanczos_tpu_torch.solver.two_sided import two_sided_lanczos_kernel  # noqa: E402

CYCLIC = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
E1 = np.array([1.0, 0.0, 0.0])


def _both(a):
    return JaxDense(jnp.asarray(a)), DenseOperator(torch.as_tensor(a))


def test_plain_two_sided_breaks_down_on_the_cyclic_shift():
    """The port's plain recurrence truncates where look-ahead cures:
    v0 = w0 = e1 make the scalar pivot w_1 = r.s vanish exactly."""
    _, opp = _both(CYCLIC)
    e1 = torch.as_tensor(E1)
    fac = two_sided_lanczos_kernel(opp.matvec, opp.rmatvec, e1, e1, 3, reorth=False)
    assert int(fac.breakdown_iter) < 3


def test_cures_curable_breakdown_like_jax():
    """Same blocks, flags and bases as JAX (to 1e-12); one 2x2 look-ahead
    block; the eigenvalues are the cube roots of unity."""
    opj, opp = _both(CYCLIC)
    fj = jla.two_sided_lanczos_lookahead(opj, 3, v0=E1, w0=E1)
    fp = pt.two_sided_lanczos_lookahead(opp, 3, v0=E1, w0=E1)
    assert fp.blocks == tuple(tuple(b) for b in fj.blocks)
    assert (fp.incurable, fp.max_block_used, fp.n) == (fj.incurable, fj.max_block_used, 3)
    assert fp.max_block_used == 2 and not fp.incurable
    for name in ("V", "W", "AV"):
        np.testing.assert_allclose(getattr(fp, name).numpy(), getattr(fj, name), atol=1e-12)
    vals, X = pt.lookahead_eigs(fp)
    np.testing.assert_allclose(np.sort_complex(vals), np.sort_complex(np.linalg.eigvals(CYCLIC)),
                               atol=1e-10)
    # The right Ritz vectors are eigenvectors of A.
    np.testing.assert_allclose(CYCLIC @ X, X * vals[None, :], atol=1e-10)


def test_incurable_flag_like_jax():
    opj, opp = _both(CYCLIC)
    fj = jla.two_sided_lanczos_lookahead(opj, 3, v0=E1, w0=E1, max_block=1)
    fp = pt.two_sided_lanczos_lookahead(opp, 3, v0=E1, w0=E1, max_block=1)
    assert fp.incurable and fj.incurable
    assert fp.n == fj.n == 1 and fp.V.shape == (1, 3)
    with pytest.raises(ValueError, match="empty factorization"):
        pla.lookahead_eigs(pla.LookAheadFactorization(
            V=fp.V[:0], W=fp.W[:0], AV=fp.AV[:0], blocks=(), incurable=True, max_block_used=1))


def test_no_breakdown_matches_jax_and_scipy():
    """A random 24x24 matrix, full depth from the default seeded starts
    (numpy's default_rng(5), as in JAX): values within 1e-10 of JAX's and
    of scipy's."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((24, 24)) + np.diag(np.linspace(1.0, 10.0, 24))
    opj, opp = _both(A)
    fj = jla.two_sided_lanczos_lookahead(opj, 24, seed=5)
    fp = pt.two_sided_lanczos_lookahead(opp, 24, seed=5)
    assert not fp.incurable and fp.blocks == tuple(tuple(b) for b in fj.blocks)
    vj, _ = jla.lookahead_eigs(fj)
    vp, _ = pt.lookahead_eigs(fp)
    # Conjugate partners tie on the real part up to rounding, so their order
    # is not comparable: pair each value with the nearest, each way.
    for ref in (vj, np.linalg.eigvals(A)):
        d = np.abs(vp[:, None] - ref[None, :])
        assert d.min(axis=1).max() < 1e-10 and d.min(axis=0).max() < 1e-10


def test_residual_filtered_result_matches_jax():
    """With ``op``: an EigResult of real pairs whose true residuals are
    within residual_tol, the same pairs as JAX's."""
    rng = np.random.default_rng(7)
    A = np.diag(np.linspace(-5.0, 5.0, 30)) + rng.standard_normal((30, 30)) * 0.05
    opj, opp = _both(A)
    fj = jla.two_sided_lanczos_lookahead(opj, 30, seed=1)
    fp = pt.two_sided_lanczos_lookahead(opp, 30, seed=1)
    rj = jla.lookahead_eigs(fj, k=5, op=opj, residual_tol=1e-6)
    rp = pt.lookahead_eigs(fp, k=5, op=opp, residual_tol=1e-6)
    assert rp.k == np.asarray(rj.eigenvalues).shape[0] >= 3
    np.testing.assert_allclose(rp.eigenvalues.numpy(), np.asarray(rj.eigenvalues), atol=1e-10)
    X, lam = rp.eigenvectors.numpy(), rp.eigenvalues.numpy()
    assert np.linalg.norm(A @ X - X * lam[None, :], axis=0).max() < 1e-5
    assert (rp.residuals.numpy() <= 1e-6).all()
    np.testing.assert_allclose(np.linalg.norm(X, axis=0), 1.0, atol=1e-12)
    np.testing.assert_allclose(rp.inner_prod.numpy(), np.asarray(rj.inner_prod), atol=1e-10)


def test_lookahead_eigs_on_a_jax_factorization():
    """lookahead_eigs of the JAX factorization carried across with
    from_jax equals JAX's to 1e-12."""
    rng = np.random.default_rng(8)
    A = rng.standard_normal((16, 16)) + np.diag(np.arange(16.0))
    opj, _ = _both(A)
    fj = jla.two_sided_lanczos_lookahead(opj, 16, seed=2)
    vj, Xj = jla.lookahead_eigs(fj)
    vp, Xp = pla.lookahead_eigs(from_jax(fj, device="cpu"))
    np.testing.assert_allclose(vp, vj, atol=1e-12)
    np.testing.assert_allclose(Xp, Xj, atol=1e-10)


def _mixed(pkg):
    sp = np.full(27, 2, dtype=np.int64)
    sp[13] = 1
    return pkg.build_lattice(24, 25.0, 3, spacings=sp)


def test_irregular_composite_matches_jax_on_the_ell():
    """The N=24 lattice (centre box at spacing 1), fp64: the port on its
    CompositeV2 and transpose (interface classes included), from the
    lattice-order starts scattered into the region layout, against JAX's
    look-ahead on the ELL assembly from the same starts: values within
    1e-10 relative."""
    J = lt.assemble_irregular_hamiltonian(_mixed(lt), lt.deuteron_potential_3d, dtype=np.float64)
    lat = _mixed(pt)
    C, idx_map = pt.assemble_irregular_hamiltonian_composite2(
        lat, pt.deuteron_potential_3d, dtype=torch.float64, min_grid_rows=4,
        build_transpose=True, device="cpu",
    )
    p = lat.num_points
    gen = np.random.default_rng(99)
    v0, w0 = gen.uniform(-1, 1, p), gen.uniform(-1, 1, p)

    def scatter(v):
        out = np.zeros(C.shape[0])
        out[idx_map] = v
        return out

    n = 160
    fj = jla.two_sided_lanczos_lookahead(J, n, v0=v0, w0=w0, op_transpose=J.transpose())
    fp = pt.two_sided_lanczos_lookahead(C, n, v0=scatter(v0), w0=scatter(w0),
                                        op_transpose=C.transpose())
    assert fp.n == fj.n == n and not fp.incurable
    rj = jla.lookahead_eigs(fj, k=6, op=J, residual_tol=1e-6)
    rp = pt.lookahead_eigs(fp, k=6, op=C, residual_tol=1e-6)
    vals_j = np.asarray(rj.eigenvalues)
    assert len(vals_j) == rp.k == 6
    np.testing.assert_allclose(rp.eigenvalues.numpy(), vals_j, atol=1e-10, rtol=1e-10)
    # Dead slots stay zero; the ground state is the pencil's lowest.
    assert float((rp.eigenvectors * (1 - C.live)[:, None]).abs().max()) == 0.0
    w = scipy.linalg.eigvals(J.to_scipy().toarray())
    assert abs(rp.eigenvalues[0].item() - np.min(w.real)) < 1e-8
