"""The port's double-word path (ops/dd.py, solver/refine.py) against lanczos_tpu.

matvec_dd: the port applies the float32-stored operator's float64 copy; it
must agree with the float64 promotion of the stored coefficients to 5e-12
and with the JAX package's error-free (hi, lo) result to 1e-12.  The
refinements run at the JAX tests' sizes from the same float32 start pairs
on both sides: the JAX tests' thresholds, and eigenvalues within 1e-9 of
the JAX package's refined ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.sparse
import scipy.sparse.linalg
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.models.lattice import build_lattice as jax_build_lattice  # noqa: E402
from lanczos_tpu.ops.composite2 import build_composite_v2 as jax_build_v2  # noqa: E402
from lanczos_tpu.ops.dd import matvec_dd as jax_matvec_dd  # noqa: E402
from lanczos_tpu.solver import refine as jref  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch import native  # noqa: E402
from lanczos_tpu_torch.convert import from_jax  # noqa: E402
from lanczos_tpu_torch.models.lattice import find_neighbors  # noqa: E402
from lanczos_tpu_torch.ops import stencil_kernels as sk  # noqa: E402
from lanczos_tpu_torch.ops.composite2 import build_composite_v2  # noqa: E402
from lanczos_tpu_torch.ops.dd import matmat_dd, matvec_dd, to_float64  # noqa: E402
from lanczos_tpu_torch.solver import refine as tref  # noqa: E402
from lanczos_tpu_torch.solver.restart import eigsh_restarted  # noqa: E402


def _reciprocal_numpy(nbrs):
    p, k = nbrs.shape
    rows = np.repeat(np.arange(p, dtype=np.int64), k)
    cols = nbrs.reshape(-1)
    valid = cols >= 0
    fwd = rows[valid] * p + cols[valid]
    bwd = np.sort(cols[valid] * p + rows[valid])
    pos = np.minimum(np.searchsorted(bwd, fwd), len(bwd) - 1)
    keep = np.zeros(p * k, dtype=bool)
    keep[valid] = bwd[pos] == fwd
    return keep.reshape(p, k)


def _graph_laplacian_rows(lat):
    """The north-star graph Laplacian's rows (tests/test_dd_refine.py):
    the lattice's neighbor graph with non-reciprocal edges dropped."""
    nbrs, rels = find_neighbors(lat, 1)
    keep = _reciprocal_numpy(nbrs)
    nbrs = np.where(keep, nbrs, -1)
    return nbrs, rels, np.where(keep, -1.0, 0.0), keep.sum(axis=1).astype(np.float64)


def _mixed_spacings(bd=3):
    sp = np.full(bd**3, 2, dtype=np.int64)
    sp[bd**3 // 2] = 1
    return sp


def _composites(n, shift, dtypes=(torch.float32,), with_jax=True):
    """(port ops by dtype, JAX float32 op or None, idx_map, rows) of the
    mixed lattice's graph Laplacian + shift."""
    sp = _mixed_spacings()
    lat = pt.build_lattice(n, 25.0, 3, spacings=sp)
    nbrs, rels, weights, deg = _graph_laplacian_rows(lat)
    kw = dict(scale=1.0, interior_weights=lambda a: np.full(26, -1.0), symmetric=True,
              min_grid_rows=4)
    ops = {}
    for dt in dtypes:
        ops[dt], idx_map = build_composite_v2(lat, nbrs, rels, weights, deg + shift, dtype=dt,
                                              device="cpu", **kw)
    jop = None
    if with_jax:
        jlat = jax_build_lattice(n, 25.0, 3, spacings=sp)
        jop, jidx = jax_build_v2(jlat, nbrs, rels, weights, deg + shift, dtype=np.float32, **kw)
        np.testing.assert_array_equal(idx_map, jidx)
    return ops, jop, idx_map, (lat, nbrs, deg)


def test_native_reciprocal_mask_matches_numpy():
    lat = pt.build_lattice(18, 25.0, 3, spacings=_mixed_spacings())
    nbrs, _ = find_neighbors(lat, 1)
    keep = native.reciprocal_mask_native(nbrs)
    if keep is None:
        pytest.skip("no C++ compiler: the native engine is unavailable")
    want = _reciprocal_numpy(nbrs)
    np.testing.assert_array_equal(keep, want)
    assert (~want & (nbrs >= 0)).any()  # the lattice has one-way edges to drop


def _split(x64):
    xh = x64.astype(np.float32)
    return xh, (x64 - xh.astype(np.float64)).astype(np.float32)


def test_matvec_dd_stencil_reads_the_stored_weights():
    # The JAX package's float32 operator carried across, so both sides hold
    # the same stored coefficients (its diag rounds the potential its own way).
    Hj = lt.build_regular_hamiltonian(16, 25.0, lt.deuteron_potential_3d, stencil="27",
                                      dtype="float32")
    H = from_jax(Hj, device="cpu")
    H64 = to_float64(H)
    assert H.dtype == torch.float32 and H64 is not H  # the operator itself is left as it is
    # The copy's weights, diag, kernel cache and ladder are the float32 values, exactly.
    w32 = H.weights.double()
    assert torch.equal(H64.weights, w32) and torch.equal(H64.diag, H.diag.double())
    dense = [0.0] * 27
    for (dz, dy, dx), w in zip(H.offsets, w32.tolist()):
        dense[(dz + 1) * 9 + (dy + 1) * 3 + dx + 1] += w
    assert list(sk._cache(H64).w27) == dense
    assert H64.graded == tuple(float(np.float32(g)) for g in H.graded)

    rng = np.random.default_rng(0)
    x64 = rng.normal(size=H.shape[0])
    xh, xl = _split(x64)
    yh, yl = matvec_dd(H, torch.from_numpy(xh), torch.from_numpy(xl))
    y_dd = yh.double().numpy() + yl.double().numpy()
    y64 = sk.stencil_spmv_reference(H64, torch.from_numpy(x64)).numpy()
    assert np.abs(y_dd - y64).max() / np.abs(y64).max() < 5e-12
    jh, jl = jax_matvec_dd(Hj, jnp.asarray(xh), jnp.asarray(xl))
    y_jax = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    assert np.abs(y_dd - y_jax).max() / np.abs(y_jax).max() < 1e-12


def test_matvec_dd_composite2():
    ops, jop, idx_map, (lat, _, _) = _composites(18, 0.0, (torch.float32, torch.float64))
    comp, comp64 = ops[torch.float32], ops[torch.float64]
    x64 = np.zeros(comp.shape[0])
    x64[idx_map] = np.random.default_rng(1).normal(size=lat.num_points)
    xh, xl = _split(x64)
    yh, yl = matvec_dd(comp, torch.from_numpy(xh), torch.from_numpy(xl))
    y_dd = yh.double().numpy() + yl.double().numpy()
    # Integer coefficients: the float64 build is the exact promotion.
    y64 = comp64.matvec(torch.from_numpy(x64)).numpy()
    assert np.abs(y_dd - y64).max() / np.abs(y64).max() < 5e-12
    jh, jl = jax_matvec_dd(jop, jnp.asarray(xh), jnp.asarray(xl))
    y_jax = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    assert np.abs(y_dd - y_jax).max() / np.abs(y_jax).max() < 1e-12
    # The column-wise matmat is the matvec per column.
    X = np.stack([x64, 2 * x64 + 1e-9], axis=1) * np.asarray(comp.live)[:, None]
    Xh, Xl = _split(X)
    Yh, Yl = matmat_dd(comp, torch.from_numpy(Xh), torch.from_numpy(Xl))
    for j in range(2):
        vh, vl = matvec_dd(comp, torch.from_numpy(Xh[:, j].copy()), torch.from_numpy(Xl[:, j].copy()))
        assert torch.equal(Yh[:, j], vh) and torch.equal(Yl[:, j], vl)


K, BUFFER = 6, 6


@pytest.fixture(scope="module")
def symmetric_case():
    """The mixed n=24 graph Laplacian + 1 (scipy, float64), float32
    compensated thick-restart pairs (k + buffer) from the port, and the
    JAX package's refinement of those same pairs.  The JAX package's
    double-word path runs eagerly on the CPU and takes minutes here; its
    building block is held to the port's above (matvec_dd, 1e-12).  The
    eigenvalues come from its float64 host refinement against the same
    matrix, whose integer coefficients the float32 operator stores
    exactly, so both refinements aim at the same eigenvalues."""
    ops, _, idx_map, (lat, nbrs, deg) = _composites(24, 1.0, with_jax=False)
    comp = ops[torch.float32]
    p = lat.num_points
    v0 = np.zeros(comp.shape[0], dtype=np.float32)
    v0[idx_map] = np.random.default_rng(5).normal(size=p).astype(np.float32)
    res = eigsh_restarted(comp, k=K + BUFFER, tol=1e-6, which="SA", v0=v0, compensated=True,
                          max_cycles=60)
    lam0 = res.eigenvalues.numpy().astype(np.float64)
    X0 = res.eigenvectors.numpy()
    rows = np.repeat(np.arange(p), nbrs.shape[1])
    valid = nbrs.reshape(-1) >= 0
    A = scipy.sparse.csr_matrix((np.ones(valid.sum()), (rows[valid], nbrs.reshape(-1)[valid])),
                                shape=(p, p))
    L = scipy.sparse.diags(deg + 1.0) - A
    exact = np.sort(scipy.sparse.linalg.eigsh(L, k=K + BUFFER, which="SA", tol=1e-12)[0])[:K]
    jlam, _, jrel = jref.refine_eigenpairs_fp64_host(L.tocsr(), lam0, X0[idx_map], tol=1e-11,
                                                     max_rounds=6, cg_steps=300)
    return comp, idx_map, lam0, X0, L, exact, jlam, jrel


def _check_symmetric(lam, X, rel, case, jax_lam):
    comp, idx_map, _, _, L, exact, *_ = case
    assert rel[:K].max() <= 3e-8, rel
    Xlat = X[idx_map, :K]
    R = L @ Xlat - Xlat * lam[None, :K]
    true_rel = np.linalg.norm(R, axis=0) / np.linalg.norm(Xlat, axis=0) / lam[:K]
    assert true_rel.max() <= 3e-8, true_rel
    l_norm = float(abs(L).sum(axis=1).max())
    assert (true_rel * lam[:K] / l_norm).max() <= 1e-9  # ARPACK-tol semantics
    np.testing.assert_allclose(np.sort(lam[:K]), exact, atol=1e-8, rtol=1e-10)
    np.testing.assert_allclose(lam[:K], jax_lam[:K], atol=1e-9, rtol=0)


def test_refine_dd_small_irregular(symmetric_case):
    comp, _, lam0, X0, *_, jlam, jrel = symmetric_case
    lam, Xh, Xl, rel = tref.refine_eigenpairs_dd(comp, lam0, X0, tol=1e-9, max_rounds=6,
                                                 cg_steps=60)
    assert Xh.dtype == Xl.dtype == torch.float32
    X = Xh.double().numpy() + Xl.double().numpy()
    _check_symmetric(lam, X, rel, symmetric_case, jlam)
    assert jrel[:K].max() <= 1e-9


def test_refine_dd_hosted_small_irregular(symmetric_case):
    comp, _, lam0, X0, *_, jlam, _ = symmetric_case
    X64 = X0.astype(np.float64)
    lam, Xout, rel = tref.refine_eigenpairs_dd_hosted(comp, lam0, X64, tol=1e-9, max_rounds=6,
                                                      cg_steps=60, col_chunk=5)
    assert Xout is X64  # updated in place, as the JAX package does
    _check_symmetric(lam, Xout, rel, symmetric_case, jlam)


@pytest.fixture(scope="module")
def nonsym_case():
    """tests/test_dd_refine.py's non-symmetric case: the debug-spacing n=24
    lattice's LSQ deuteron Hamiltonian (ELL, float32); float32 Krylov–Schur
    pairs from the port; the JAX package's dd and float64-host refinements
    of those pairs."""
    lat = pt.build_lattice(24, 25.0, 3, overwrite_spacing=True)
    H = pt.assemble_irregular_hamiltonian(lat, pt.deuteron_potential_3d, dtype=torch.float32,
                                          device="cpu")
    jlat = jax_build_lattice(24, 25.0, 3, overwrite_spacing=True)
    Hj = lt.assemble_irregular_hamiltonian(jlat, lt.deuteron_potential_3d, symmetrize=None,
                                           dtype=np.float32)
    # The JAX test refines the 4 lowest pairs of a k=4 solve.  The port's
    # k=4 solve returns one copy of the 2-fold 2.34106 (the start vectors
    # differ), and a refinement cannot complete a multiplet it holds one
    # vector of (on either side): refine the 5 lowest of a k=6 solve, which
    # holds both copies (its 6th pair is one copy of the 2-fold 2.35126).
    res = pt.eigs_nonsym(H, k=6, tol=1e-6, which="SR", max_cycles=40)
    lam0 = res.eigenvalues.numpy().astype(np.float64)[:5]
    X0 = res.eigenvectors.numpy()[:, :5]
    jlam, *_, jrel = jref.refine_eigenpairs_dd_nonsym(Hj, lam0, X0, tol=1e-9, max_rounds=8,
                                                      cg_steps=60)
    A64 = pt.assemble_irregular_hamiltonian(lat, pt.deuteron_potential_3d, dtype=torch.float64,
                                            device="cpu").to_scipy()
    hlam, _, _ = jref.refine_eigenpairs_fp64_host(A64, lam0, X0, tol=1e-10, max_rounds=6,
                                                  cg_steps=200)
    return H, lam0, X0, A64, np.asarray(jlam), jrel, hlam


def test_refine_dd_nonsym(nonsym_case):
    H, lam0, X0, _, jlam, jrel, _ = nonsym_case
    lam, Xh, Xl, rel = tref.refine_eigenpairs_dd_nonsym(H, lam0, X0, tol=1e-9, max_rounds=8,
                                                        cg_steps=60)
    assert rel.max() <= 1e-8, rel
    assert np.asarray(jrel).max() <= 1e-8
    # float64 oracle on the stored float32 coefficients (what dd applies exactly).
    A = H.to_scipy().astype(np.float64)
    X = Xh.double().numpy() + Xl.double().numpy()
    R = A @ X - X * lam[None, :]
    true_rel = np.linalg.norm(R, axis=0) / np.linalg.norm(X, axis=0) / np.maximum(np.abs(lam), 1)
    assert true_rel.max() <= 1e-8, true_rel
    w = scipy.linalg.eig(A.toarray(), right=False)
    w = np.sort(w.real[np.abs(w.imag) < 1e-8])
    np.testing.assert_allclose(np.sort(lam), w[:5], atol=1e-7, rtol=1e-9)
    np.testing.assert_allclose(np.sort(lam), np.sort(jlam), atol=1e-9, rtol=0)


def test_refine_fp64_host(nonsym_case):
    _, lam0, X0, A64, _, _, hlam = nonsym_case
    lam, X, rel = tref.refine_eigenpairs_fp64_host(A64, lam0, X0, tol=1e-10, max_rounds=6,
                                                   cg_steps=200)
    assert rel.max() <= 1e-9, rel
    np.testing.assert_allclose(lam, hlam, atol=1e-9, rtol=0)
    w = scipy.linalg.eig(A64.toarray(), right=False)
    w = np.sort(w.real[np.abs(w.imag) < 1e-8])
    assert max(np.abs(w - v).min() for v in lam) <= 1e-9


def test_fp64_host_refinement_keeps_a_near_real_pair_apart():
    """A Rayleigh-Ritz step whose eigenvalues come as a conjugate pair with
    |Im mu| ~ 1e-14 |mu| (a near-degenerate real eigenvalue under
    rounding) keeps two independent columns, (Re z, Im z).  Taking Re z for
    both made them one vector, and the N=120 irregular refinement lost a
    copy of the doubled 2.5735733.  Here A holds lam = 2 +- 1e-14 i in its
    first two coordinates; tol=0 forces the Rayleigh-Ritz rounds."""
    n = 40
    rng = np.random.default_rng(3)
    A = np.diag(np.concatenate([[2.0, 2.0], np.linspace(3.0, 9.0, n - 2)]))
    A[0, 1], A[1, 0] = 1e-14, -1e-14
    X0 = np.eye(n)[:, :3] + 1e-6 * rng.standard_normal((n, 3))
    lam, X, rel = tref.refine_eigenpairs_fp64_host(scipy.sparse.csr_matrix(A), np.array(
        [2.0, 2.0, 3.0]), X0, tol=0.0, max_rounds=3, cg_steps=50)
    cos = abs(X[:, 0] @ X[:, 1]) / (np.linalg.norm(X[:, 0]) * np.linalg.norm(X[:, 1]))
    assert cos < 0.5, cos  # one vector twice has cos = 1
    assert np.linalg.svd(X, compute_uv=False).min() > 0.1
    np.testing.assert_allclose(lam, [2.0, 2.0, 3.0], atol=1e-12)
    assert rel.max() < 1e-10
