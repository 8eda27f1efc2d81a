"""Port's Arnoldi/Krylov–Schur and two-sided Lanczos against lanczos_tpu.

Same operators (the mixed n=24 lattice with the deuteron potential), same
start vectors, fp64.  The port's CompositeV2 runs take a ``live``-masked
start vector: the dead slots carry an exact eigenvalue 0, which an unmasked
one brings in (test_unmasked_start_brings_in_the_dead_zero).
"""

import jax  # noqa: F401  (kept on the CPU by conftest)
import numpy as np
import pytest
import scipy.sparse
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.solver.arnoldi import arnoldi_kernel as jax_arnoldi_kernel  # noqa: E402
from lanczos_tpu.solver.two_sided import (  # noqa: E402
    two_sided_eigs as jax_two_sided_eigs,
    two_sided_lanczos_kernel as jax_two_sided_kernel,
)

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.solver.arnoldi import arnoldi_kernel  # noqa: E402
from lanczos_tpu_torch.solver.two_sided import nonsymmetric_tridiag_eig  # noqa: E402


def _mixed(pkg):
    sp = np.full(27, 2, dtype=np.int64)
    sp[13] = 1
    return pkg.build_lattice(24, 25.0, 3, spacings=sp)


@pytest.fixture(scope="module")
def ops():
    """(JAX ELL, port ELL, port CompositeV2 with transpose, idx_map)."""
    J = lt.assemble_irregular_hamiltonian(_mixed(lt), lt.deuteron_potential_3d, dtype=np.float64)
    lat = _mixed(pt)
    E = pt.assemble_irregular_hamiltonian(lat, pt.deuteron_potential_3d, dtype=torch.float64, device="cpu")
    C, idx_map = pt.assemble_irregular_hamiltonian_composite2(
        lat, pt.deuteron_potential_3d, dtype=torch.float64, min_grid_rows=4,
        build_transpose=True, device="cpu",
    )
    return J, E, C, idx_map


def _scatter(op, idx_map, v):
    out = np.zeros(op.shape[0])
    out[idx_map] = v
    return out


def _v0(p, seed=5):
    return np.random.default_rng(seed).uniform(-1, 1, p)


def test_eigs_nonsym_matches_jax_and_v2(ops):
    J, E, C, idx_map = ops
    v0 = _v0(E.shape[0])
    kw = dict(k=4, max_basis=60, tol=1e-10)
    rj = lt.eigs_nonsym(J, v0=v0, dtype=np.float64, **kw)
    re = pt.eigs_nonsym(E, v0=v0, **kw)
    vals_j = np.asarray(rj.eigenvalues)
    np.testing.assert_allclose(re.eigenvalues.numpy(), vals_j, rtol=0, atol=1e-8)
    assert (re.residuals.numpy() < 1e-10).all()
    np.testing.assert_allclose(re.inner_prod.numpy(), np.asarray(rj.inner_prod), atol=1e-8)
    # The same operator in the v2 layout, from the same (masked) start.
    rc = pt.eigs_nonsym(C, v0=_scatter(C, idx_map, v0), **kw)
    np.testing.assert_allclose(rc.eigenvalues.numpy(), vals_j, rtol=0, atol=1e-8)
    assert float((rc.eigenvectors * (1 - C.live)[:, None]).abs().max()) == 0.0
    assert vals_j[0] < 0 < vals_j[1]


def test_unmasked_start_brings_in_the_dead_zero(ops):
    """k=4 reaches past 0 (the spectrum starts -8.67, 0.116, 2.34, ...): an
    unmasked v0 on v2 reports Ritz values at 0 that the ELL run of the same
    operator lacks; the live-masked v0 does not."""
    _, E, C, idx_map = ops
    kw = dict(k=4, max_basis=60, tol=1e-10)
    ell = pt.eigs_nonsym(E, v0=_v0(E.shape[0]), **kw).eigenvalues.numpy()
    unmasked = pt.eigs_nonsym(C, v0=_v0(C.shape[0], seed=6), **kw).eigenvalues.numpy()
    masked = pt.eigs_nonsym(C, v0=_scatter(C, idx_map, _v0(E.shape[0])), **kw).eigenvalues.numpy()
    assert np.min(np.abs(ell)) > 0.1
    assert np.min(np.abs(unmasked)) < 1e-10
    assert np.min(np.abs(masked)) > 0.1


def test_arnoldi_matches_jax(ops):
    J, E, _, _ = ops
    v0 = _v0(E.shape[0], seed=7)
    fj = jax_arnoldi_kernel(J.matvec, v0, 12)
    fp = arnoldi_kernel(E.matvec, torch.from_numpy(v0), 12)
    scale = float(np.abs(np.asarray(fj.H)).max())
    np.testing.assert_allclose(fp.H.numpy(), np.asarray(fj.H), atol=1e-10 * scale)
    np.testing.assert_allclose(fp.V.numpy(), np.asarray(fj.V), atol=1e-9)
    assert int(fp.breakdown_iter) == int(fj.breakdown_iter) == 12
    fa = pt.arnoldi(E, 12, v0=v0)
    np.testing.assert_array_equal(fa.H.numpy(), fp.H.numpy())


def test_two_sided_matches_jax(ops):
    J, E, C, idx_map = ops
    p = E.shape[0]
    v0, w0 = _v0(p, 8), _v0(p, 9)
    n = 20
    fj = jax_two_sided_kernel(J.matvec, J.rmatvec, v0, w0, n)
    fp = pt.two_sided_lanczos(E, n, v0=v0, w0=w0, op_transpose=E.transpose())
    assert int(fp.breakdown_iter) == int(fj.breakdown_iter) == n
    for name in ("alpha", "beta", "gamma"):
        a, b = getattr(fp, name).numpy(), np.asarray(getattr(fj, name))
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8 * np.abs(b).max(), err_msg=name)
    vj, _ = jax_two_sided_eigs(fj)
    vp, _ = pt.two_sided_eigs(fp)
    np.testing.assert_allclose(vp.real, np.asarray(vj).real, rtol=1e-8, atol=1e-8)
    assert "iter  biorth-drift" in fp.health_report()
    # The same recurrence on v2 (matvec + the transpose operator), masked.
    fc = pt.two_sided_lanczos(
        C, n, v0=_scatter(C, idx_map, v0), w0=_scatter(C, idx_map, w0),
        op_transpose=C.transpose(),
    )
    np.testing.assert_allclose(fc.alpha.numpy(), fp.alpha.numpy(), rtol=1e-8, atol=1e-8)


def test_two_sided_on_v2_finds_the_extremal_eigenvalues(ops):
    """tests/test_composite2.py's check on the port: n=120 two-sided steps
    over v2, the largest Ritz value against a dense eig of the same matrix,
    and the residual-filtered EigResult, whose every pair is an eigenpair
    (the unfiltered Ritz values hold ghosts, e.g. a second copy near the
    largest)."""
    _, E, C, idx_map = ops
    p = E.shape[0]
    fac = pt.two_sided_lanczos(
        C, 120, v0=_scatter(C, idx_map, _v0(p, 10)), w0=_scatter(C, idx_map, _v0(p, 11)),
        op_transpose=C.transpose(),
    )
    vals, _ = pt.two_sided_eigs(fac)
    A = E.to_scipy()
    assert isinstance(A, scipy.sparse.csr_matrix)
    exact = np.sort(np.linalg.eigvals(A.toarray()).real)
    np.testing.assert_allclose(np.max(vals.real), exact[-1], rtol=1e-5)
    res = pt.two_sided_eigs(fac, k=3, op=C, residual_tol=1e-6)
    assert res.k >= 1 and (res.residuals.numpy() < 1e-6).all()
    for lam in res.eigenvalues.numpy():
        assert np.min(np.abs(exact - lam)) < 1e-6 * max(abs(lam), 1.0)


def test_nonsymmetric_tridiag_eig_matches_jax():
    from lanczos_tpu.solver.two_sided import nonsymmetric_tridiag_eig as jax_tridiag

    rng = np.random.default_rng(12)
    a, b, g = rng.standard_normal(8), rng.uniform(0.5, 1, 7), rng.uniform(0.5, 1, 7)
    for beta, gamma in ((b, g), (b, -g)):  # symmetrizable, and the eig branch
        vp, wp = nonsymmetric_tridiag_eig(a, beta, gamma)
        vj, wj = jax_tridiag(a, beta, gamma)
        np.testing.assert_allclose(vp, vj, rtol=1e-12)
        np.testing.assert_allclose(np.abs(wp), np.abs(wj), atol=1e-12)


def test_entry_point_checks(ops):
    _, E, _, _ = ops
    with pytest.raises(ValueError):
        pt.eigs_nonsym(E, k=2, dtype=torch.float32)
    with pytest.raises(ValueError):
        pt.two_sided_lanczos(E, E.shape[0] + 1)
    # Default start vectors come from a seeded torch.Generator.
    f1, f2 = pt.arnoldi(E, 5, seed=3), pt.arnoldi(E, 5, seed=3)
    np.testing.assert_array_equal(f1.H.numpy(), f2.H.numpy())


def test_sorted_schur_survives_lapack_reordering(monkeypatch):
    """The v1 composite of tests/test_torch_composite_v1.py (n=12) with a
    14-vector basis: in one cycle LAPACK's reordering moves a copy of a
    Ritz value across the sort threshold, where the JAX package's
    _schur_sort_select raises; the port lowers the threshold past the
    rounding and goes on.  Every other cycle's selection (T, Z, l) is the
    JAX function's, bit for bit, and the solve converges to the values of
    a 36-vector basis (1e-9)."""
    import importlib

    from lanczos_tpu.solver.arnoldi import _schur_sort_select as jax_select

    arnoldi = importlib.import_module("lanczos_tpu_torch.solver.arnoldi")
    lat = pt.build_lattice(12, 25.0, 3, overwrite_spacing=True)
    comp, _ = pt.assemble_irregular_hamiltonian_composite(
        lat, pt.deuteron_potential_3d, dtype=torch.float64, device="cpu")
    kw = dict(k=3, tol=1e-9, max_cycles=80, which="SR")
    want = pt.eigs_nonsym(comp, max_basis=36, **kw)
    select = arnoldi._schur_sort_select
    outcomes = []

    def spy(Bm, which, k):
        out = select(Bm, which, k)
        try:
            ref = jax_select(Bm, which, k)
        except np.linalg.LinAlgError:
            outcomes.append("raised")
        else:
            outcomes.append(all(np.array_equal(a, b) for a, b in zip(ref[:2], out[:2]))
                            and ref[2] == out[2])
        return out

    monkeypatch.setattr(arnoldi, "_schur_sort_select", spy)
    got = pt.eigs_nonsym(comp, max_basis=14, **kw)
    assert "raised" in outcomes
    assert all(o is True for o in outcomes if o != "raised")
    np.testing.assert_allclose(got.eigenvalues.numpy(), want.eigenvalues.numpy(), rtol=0,
                               atol=1e-9)
    assert float(got.residuals.max()) < 1e-8
