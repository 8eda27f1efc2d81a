"""The port's thick-restart Lanczos against lanczos_tpu.eigsh_restarted.

Both packages get the same numpy start vector; converged float64 eigenvalues
agree to 1e-10 relative.  Also: the float32 compensated floor of
tests/test_compensated.py on the port, the non-finite guard, and a numpy
model of ``_ritz_update``'s chunked in-place rotation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.solver.restart import eigsh_restarted as jax_restarted  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.solver.restart import _ritz_update, eigsh_restarted  # noqa: E402


def _dense(m, seed):
    A = np.random.default_rng(seed).normal(size=(m, m))
    return (A + A.T) / 2


def _case(name):
    """(JAX operator, port operator, kwargs, oracle eigenvalues)."""
    if name == "dense_SA":
        A = _dense(300, 0)
        return (lt.as_operator(A), pt.as_operator(A, device="cpu"),
                dict(k=6, max_basis=40, tol=1e-10), np.linalg.eigvalsh(A)[:6])
    if name == "dense_LA":
        A = _dense(200, 1)
        return (lt.as_operator(A), pt.as_operator(A, device="cpu"),
                dict(k=4, which="LA", max_basis=30, tol=1e-10), np.linalg.eigvalsh(A)[::-1][:4])
    if name == "deuteron_1d":
        n = 1001
        r = np.linspace(0, 25.0, n)
        hj = lt.build_chain_hamiltonian_1d(n, 25.0, np.asarray(lt.deuteron_potential_radial(r)))
        ht = pt.build_chain_hamiltonian_1d(n, 25.0, pt.deuteron_potential_radial(r), device="cpu")
        oracle = np.sort(scipy.sparse.linalg.eigsh(ht.to_scipy(), k=5, which="SA")[0])
        return hj, ht, dict(k=5, max_basis=80, tol=1e-10, max_cycles=300), oracle
    hj = lt.build_regular_hamiltonian(16, 25.0, lt.deuteron_potential_3d, stencil="27",
                                      dtype=np.float64)
    ht = pt.build_regular_hamiltonian(16, 25.0, pt.deuteron_potential_3d, stencil="27",
                                      dtype=torch.float64, device="cpu")
    oracle = np.sort(scipy.sparse.linalg.eigsh(ht.to_scipy(), k=10, which="SA")[0])
    return hj, ht, dict(k=4, max_basis=60, tol=1e-9), oracle


CASES = ["dense_SA", "dense_LA", "deuteron_1d", "stencil_3d_N16"]


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's solve of every case, computed once."""
    out = {}
    for name in CASES:
        hj, ht, kw, oracle = _case(name)
        v0 = np.random.default_rng(11).uniform(-1, 1, ht.shape[0])
        res = jax_restarted(hj, v0=jnp.asarray(v0), dtype=np.float64, **kw)
        out[name] = (ht, kw, oracle, v0, np.asarray(res.eigenvalues))
    return out


@pytest.mark.parametrize("name", CASES)
def test_eigenvalues_match_jax(name, jax_runs):
    ht, kw, oracle, v0, want = jax_runs[name]
    res = eigsh_restarted(ht, v0=v0, **kw)
    got = res.eigenvalues.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    if name == "stencil_3d_N16":
        # The lattice has degenerate multiplets that single-vector Lanczos
        # reports with reduced multiplicity: match each value to the oracle.
        np.testing.assert_allclose(got[:2], oracle[:2], atol=1e-7)
        assert np.abs(got[:, None] - oracle[None, :]).min(axis=1).max() < 1e-7
    else:
        np.testing.assert_allclose(got, oracle, atol=1e-7)
    assert res.good_mask(1e-6).all()


def test_locked_block_without_rr_verify_stays_on_the_device():
    A = _dense(120, 2)
    op = pt.as_operator(A, device="cpu")
    v0 = np.random.default_rng(3).uniform(-1, 1, 120)
    res = eigsh_restarted(op, k=4, max_basis=30, tol=1e-10, v0=v0, rr_verify=False)
    assert res.residuals_are_estimates and torch.isnan(res.inner_prod).all()
    assert res.eigenvectors.shape == (120, 4) and res.eigenvectors.is_contiguous()
    np.testing.assert_allclose(res.eigenvalues.numpy(), np.linalg.eigvalsh(A)[:4], atol=1e-9)


def test_solve_level_fp32_compensated_floor():
    """tests/test_compensated.py's pin on the port: the compensated float32
    thick restart reaches the float32 storage floor (~2 eps relative to
    ||H||) on the N=32 deuteron.  The JAX test also finds the plain float32
    solve twice as far off; the port's plain ``torch.dot`` (blocked sums in
    MKL and cuBLAS) already lands near the floor at M = 32768, so here the
    compensated solve is held to be no worse than it."""
    H = pt.build_regular_hamiltonian(32, 25.0, pt.deuteron_potential_3d, stencil="27",
                                     dtype=torch.float32, device="cpu")
    csr = H.to_ell().to_scipy().astype(np.float64)
    hn = np.abs(csr).sum(axis=1).max()

    def true_rel(res):
        lam = res.eigenvalues.numpy().astype(np.float64)
        X = res.eigenvectors.numpy().astype(np.float64)
        R = csr @ X - X * lam[None]
        return (np.linalg.norm(R, axis=0) / np.linalg.norm(X, axis=0) / hn).max()

    kw = dict(k=8, tol=1e-10, which="SA", max_cycles=40)
    r_comp = true_rel(eigsh_restarted(H, compensated=True, **kw))
    r_plain = true_rel(eigsh_restarted(H, compensated=False, **kw))
    assert r_comp < 2.5e-7, r_comp
    assert r_comp <= r_plain, (r_comp, r_plain)


def test_restart_surfaces_nonfinite():
    a = np.diag(np.linspace(1.0, 2.0, 40))
    a[0, 0] = np.inf
    with pytest.raises(FloatingPointError, match="non-finite"):
        eigsh_restarted(pt.as_operator(a, device="cpu"), k=3, tol=1e-8, max_cycles=3)
    with pytest.raises(ValueError, match="n_locked"):
        eigsh_restarted(pt.as_operator(_dense(40, 4), device="cpu"), k=8, n_locked=4)


def _ritz_update_model(V, evecs, l, col_chunk):
    """numpy model of the in-place rotation: per column chunk, read the
    chunk of rows [0, m) whole, then write y into rows [0, l) and zeros
    into rows [l, m] of that chunk only."""
    V = V.copy()
    m = V.shape[0] - 1
    e = evecs[:, :l] / np.linalg.norm(evecs[:, :l], axis=0, keepdims=True)
    writes = np.zeros(V.shape, dtype=int)
    for a in range(0, V.shape[1], col_chunk):
        b = min(a + col_chunk, V.shape[1])
        chunk = V[:m, a:b].copy()  # read before any write to these columns
        V[:l, a:b] = e.T @ chunk
        V[l:, a:b] = 0.0
        writes[:, a:b] += 1
    assert (writes == 1).all()  # every element written exactly once
    return V


@pytest.mark.parametrize("mdim,col_chunk", [(37, 5), (64, 64), (100, 7), (50, 1000)])
def test_ritz_update_chunked_rotation(mdim, col_chunk):
    rng = np.random.default_rng(mdim)
    m, l = 12, 5
    V = rng.normal(size=(m + 1, mdim))
    Y = np.linalg.qr(rng.normal(size=(m, m)))[0] * rng.uniform(0.5, 2.0, m)
    model = _ritz_update_model(V, Y, l, col_chunk)
    E = Y[:, :l] / np.linalg.norm(Y[:, :l], axis=0)
    np.testing.assert_allclose(model[:l], E.T @ V[:m], atol=1e-13)
    assert (model[l:] == 0).all()
    got = _ritz_update(torch.from_numpy(V.copy()), torch.from_numpy(Y), l, col_chunk=col_chunk)
    np.testing.assert_allclose(got.numpy(), model, atol=1e-13)


def test_northstar_default_basis_is_the_restart_rule():
    """scripts/northstar_torch.py's default basis is 2 kk + 30 at every
    size: 250 for k = 100 and the default 10 buffer pairs (no 16 GB TPU
    cap above 4M points)."""
    import inspect
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "scripts"))
    import northstar_torch

    defaults = inspect.signature(northstar_torch.run).parameters
    kk = defaults["k"].default + defaults["k_buffer"].default
    assert (kk, defaults["max_basis"].default) == (110, 0)
    assert northstar_torch.default_max_basis(kk) == 250
    assert northstar_torch.default_max_basis(20) == 70  # eigsh_restarted's own default
