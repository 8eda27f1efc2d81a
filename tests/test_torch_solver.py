"""Port's Lanczos solver against lanczos_tpu and scipy, on the same inputs."""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (kept on the CPU by conftest)
import numpy as np
import pytest
import scipy.sparse.linalg
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.solver.lanczos import lanczos_kernel as jax_lanczos_kernel  # noqa: E402
from lanczos_tpu.solver.results import acceptance_inner_prod as jax_acceptance  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.convert import from_jax  # noqa: E402
from lanczos_tpu_torch.solver.lanczos import lanczos_kernel  # noqa: E402
from lanczos_tpu_torch.solver.results import acceptance_inner_prod  # noqa: E402


def _deuteron(n):
    H = lt.build_regular_hamiltonian(n, 25.0, lt.deuteron_potential_3d, stencil="27", dtype="float64")
    return H, from_jax(H, device="cpu")


# fp64, same operator arrays and start vector.  With full or selective
# reorthogonalization the two recurrences agree to rounding; with less, the
# rounding differences grow once orthogonality is lost, so those runs stop
# before that happens on this operator.
# The port's full runs take the lagged recurrence (solver/lanczos.py:
# _lagged_row) at 2 and 3 passes; the JAX package's the plain one.
@pytest.mark.parametrize(
    "reorth,n,tol,passes",
    [pytest.param("full", 40, 1e-10, 2, id="full-40-1e-10"),
     pytest.param("full", 40, 1e-10, 3, id="full-40-1e-10-passes3"),
     pytest.param("selective", 40, 1e-10, 2, id="selective-40-1e-10"),
     pytest.param("periodic", 20, 1e-10, 2, id="periodic-20-1e-10"),
     pytest.param("none", 15, 1e-8, 2, id="none-15-1e-08")],
)
def test_lanczos_matches_jax(reorth, n, tol, passes):
    H, P = _deuteron(8)
    v0 = np.random.default_rng(1).uniform(-1, 1, H.shape[0])
    fj = jax_lanczos_kernel(H.matvec, v0, n, reorth=reorth, reorth_passes=passes)
    fp = lanczos_kernel(P.matvec, torch.from_numpy(v0), n, reorth=reorth, reorth_passes=passes)
    scale = float(np.max(np.abs(np.asarray(fj.alpha))))
    np.testing.assert_allclose(fp.alpha.numpy(), np.asarray(fj.alpha), atol=tol * scale)
    np.testing.assert_allclose(fp.beta.numpy(), np.asarray(fj.beta), atol=tol * scale)
    # Later Lanczos vectors amplify rounding by 1/gap of the unconverged
    # directions; entries are O(1/sqrt(M)) = 0.04, so 1e-6 is still tight.
    np.testing.assert_allclose(fp.V.abs().numpy(), np.abs(np.asarray(fj.V)), atol=1e-6)
    assert int(fp.breakdown_iter) == int(fj.breakdown_iter) == n
    assert fp.V.shape == (n, H.shape[0]) and fp.resid.shape == (H.shape[0],)


def test_lanczos_breakdown_matches_jax():
    # v0 spans a 2-dim invariant subspace: beta underflows at step 2.
    a = np.diag(np.arange(1.0, 7.0))
    v0 = np.array([1.0, 1.0, 0, 0, 0, 0])
    fj = jax_lanczos_kernel(lambda x: a @ x, v0, 6)
    fp = lanczos_kernel(lambda x: torch.from_numpy(a) @ x, torch.from_numpy(v0), 6)
    assert int(fp.breakdown_iter) == int(fj.breakdown_iter) == 2
    np.testing.assert_allclose(fp.alpha.numpy(), np.asarray(fj.alpha), atol=1e-14)
    assert np.all(np.isfinite(fp.V.numpy()))


def test_lanczos_entry_point_checks():
    P = pt.build_regular_hamiltonian(
        4, 25.0, pt.deuteron_potential_3d, dtype=torch.float64, device="cpu"
    )
    with pytest.raises(ValueError):
        pt.lanczos(P, 65)
    with pytest.raises(ValueError):
        pt.lanczos(P, 10, dtype=torch.float32)
    with pytest.raises(ValueError, match="compensated is not supported"):
        pt.eigsh(P, k=2, n=10, block_size=2, compensated=True)
    # The default start vector comes from a seeded torch.Generator.
    f1, f2 = pt.lanczos(P, 10, seed=5), pt.lanczos(P, 10, seed=5)
    np.testing.assert_array_equal(f1.alpha.numpy(), f2.alpha.numpy())


def test_tridiag_ritz_and_acceptance_match():
    H, P = _deuteron(6)
    v0 = np.random.default_rng(2).uniform(-1, 1, H.shape[0])
    fj = jax_lanczos_kernel(H.matvec, v0, 30)
    fp = from_jax(fj, device="cpu")  # identical factorization on both sides
    tj, Wj = lt.tridiag_eigh(fj.alpha, fj.beta)
    tp, Wp = pt.tridiag_eigh(fp.alpha, fp.beta)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), rtol=1e-11, atol=1e-10)
    thj, Xj, rj = lt.ritz_from_factorization(fj)
    thp, Xp, rp = pt.ritz_from_factorization(fp)
    np.testing.assert_allclose(thp.numpy(), np.asarray(thj), rtol=1e-11, atol=1e-10)
    # Eigenvectors are defined up to sign.
    Xj = np.asarray(Xj)
    signs = np.sign(np.sum(Xp.numpy() * Xj, axis=0))
    np.testing.assert_allclose(Xp.numpy() * signs, Xj, atol=1e-9)
    np.testing.assert_allclose(rp.numpy(), np.asarray(rj), rtol=1e-6, atol=1e-9)
    mj = lt.cullum_willoughby_mask(np.asarray(fj.alpha), np.asarray(fj.beta), np.asarray(thj))
    mp = pt.cullum_willoughby_mask(fp.alpha.numpy(), fp.beta.numpy(), thp.numpy())
    np.testing.assert_array_equal(mp, mj)
    # Column 0 has eigenvalue ~0, where the statistic is 0/0; skip it.
    np.testing.assert_allclose(
        acceptance_inner_prod(P, torch.from_numpy(Xj[:, 1:6].copy())).numpy(),
        np.asarray(jax_acceptance(H, Xj[:, 1:6])), rtol=1e-12,
    )
    ref = lt.match_eigs(np.asarray(thj)[:4], Xj[:, :4], np.asarray(thj)[:4], Xj[:, :4])
    got = pt.match_eigs(thp[:4], Xp[:, :4], thp[:4], Xp[:, :4])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-9)


@pytest.mark.parametrize("reorth", ["full", "selective"])
def test_eigsh_matches_jax(reorth):
    H, P = _deuteron(10)
    v0 = np.random.default_rng(3).uniform(-1, 1, H.shape[0])
    rj = lt.eigsh(H, k=5, n=80, v0=v0, reorth=reorth, dtype=np.float64)
    rp = pt.eigsh(P, k=5, n=80, v0=v0, reorth=reorth)
    # Same operator, same v0, fp64: eigenvalues agree to rounding.
    np.testing.assert_allclose(rp.eigenvalues.numpy(), np.asarray(rj.eigenvalues), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(rp.inner_prod.numpy(), np.asarray(rj.inner_prod), atol=1e-8)
    np.testing.assert_array_equal(rp.good_mask(), rj.good_mask())
    assert rp.eigenvectors.shape == (1000, 5)
    assert "EIGENVALUE AND EIGENVECTOR SUMMARY" in rp.summary()


def _spy_on_ritz_vectors(monkeypatch):
    """Record the (fac, W, cols) of eigsh's call of ritz_vectors."""
    from lanczos_tpu_torch.solver import api

    seen = {}
    real = api.ritz_vectors

    def spy(fac, W, cols=None):
        seen.update(fac=fac, W=W, cols=cols)
        return real(fac, W, cols)

    monkeypatch.setattr(api, "ritz_vectors", spy)
    return seen


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("reorth,ghost_filter", [("full", False), ("full", True),
                                                 ("selective", True)])
@pytest.mark.parametrize("which", ["SA", "LA", "SM", "LM"])
def test_eigsh_rotates_only_the_selected_pairs(monkeypatch, which, reorth, ghost_filter, dtype):
    """eigsh selects from the Ritz values and rotates only the k selected
    pairs: the same pairs, in the same order, as selecting columns of the
    full rotation; eigenvalues and residuals bitwise, eigenvectors to the
    rounding of n-term sums."""
    from lanczos_tpu_torch.solver import api

    P = pt.build_regular_hamiltonian(6, 25.0, pt.deuteron_potential_3d, dtype=dtype,
                                     device="cpu")
    k, n = 5, 30
    seen = _spy_on_ritz_vectors(monkeypatch)
    v0 = np.random.default_rng(7).uniform(-1, 1, P.shape[0])
    res = pt.eigsh(P, k=k, n=n, which=which, v0=v0, reorth=reorth, ghost_filter=ghost_filter)
    fac = seen["fac"]
    theta, X, resid = pt.ritz_from_factorization(fac)
    assert X.shape == (P.shape[0], n)
    theta_np = theta.numpy()
    keep = api._ghost_mask(fac, theta_np, resid) if ghost_filter else np.ones(n, dtype=bool)
    kept = np.nonzero(keep)[0]
    sel = kept[api._select(theta_np[kept], which, k)]
    assert seen["cols"].tolist() == sel.tolist() and len(sel) == k
    assert torch.equal(res.eigenvalues, theta[sel])
    assert torch.equal(res.residuals, resid[sel])
    assert res.eigenvectors.is_contiguous() and res.eigenvectors.dtype == dtype
    eps = torch.finfo(dtype).eps
    bound = n * eps * (fac.V.abs().T @ seen["W"][:, sel].abs())
    assert bool(((res.eigenvectors - X[:, sel]).abs() <= bound).all())


def test_ritz_columns_counter_counts_the_rotated_pairs():
    """COUNTERS["lt.ritz.columns"] grows by k for an eigsh call and by n for
    ritz_from_factorization, which still returns all n Ritz vectors."""
    from lanczos_tpu_torch._util import COUNTERS

    P = pt.build_regular_hamiltonian(6, 25.0, pt.deuteron_potential_3d, dtype=torch.float64,
                                     device="cpu")
    v0 = np.random.default_rng(8).uniform(-1, 1, P.shape[0])
    before = COUNTERS["lt.ritz.columns"]
    for k in (3, 7):
        pt.eigsh(P, k=k, n=30, v0=v0)
    assert COUNTERS["lt.ritz.columns"] - before == 10
    fac = pt.lanczos(P, 30, v0=v0)
    before = COUNTERS["lt.ritz.columns"]
    theta, X, _ = pt.ritz_from_factorization(fac)
    assert COUNTERS["lt.ritz.columns"] - before == 30
    assert X.shape == (P.shape[0], 30) and theta.shape == (30,)
    _, W = pt.tridiag_eigh(fac.alpha, fac.beta)
    assert torch.equal(X, fac.V.T @ W)


def test_ritz_rotate_off_the_card_is_the_plain_product():
    """ops/ritz_kernels.py:rotate on CPU tensors is V.T @ W[:, cols], any k
    and any strides of W (V.T @ W for cols=None), and launches nothing;
    indices given on the host are checked."""
    from lanczos_tpu_torch._util import COUNTERS
    from lanczos_tpu_torch.ops import ritz_kernels as rk

    rng = np.random.default_rng(9)
    V = torch.from_numpy(rng.standard_normal((12, 50)))
    W = torch.from_numpy(rng.standard_normal((12, 12))).T  # column-major, as eigh gives it
    launches = COUNTERS["lt.ritz.launches"]
    for cols in ([4, 0, 11], list(range(12)) * 3, [7]):
        got = rk.rotate(V, W, cols)
        assert torch.equal(got, V.T @ W[:, cols]) and got.shape == (50, len(cols))
    assert torch.equal(rk.rotate(V, W), V.T @ W)
    assert COUNTERS["lt.ritz.launches"] == launches
    with pytest.raises(IndexError):
        rk.rotate(V, W, [0, 12])
    with pytest.raises(IndexError):
        rk.rotate(V, W, torch.tensor([-1]))
    with pytest.raises(ValueError):
        rk.rotate(V, W, torch.zeros(2, 2, dtype=torch.int64))
    with pytest.raises(ValueError):
        rk.rotate(V, W[:5], [0])


@pytest.mark.parametrize("k", [1, 3, 20, 24, 25, 47, 48, 49, 400, 1000])
def test_ritz_rotation_chunks_are_aligned_and_few(k):
    """The kernel's chunks of columns: one chunk of k up to K_MAX (the
    source's kMaxCols), so the cell's k = 20 is one pass over V; past it,
    chunks at most K_MAX wide, as few as K_MAX allows, each starting on a
    multiple of 4 columns, the last one not empty."""
    from lanczos_tpu_torch.ops import ritz_kernels as rk

    src = (Path(pt.__file__).parent / "csrc" / "ritz.cu").read_text()
    assert f"constexpr int kMaxCols = {rk.K_MAX};" in src
    width = rk.chunk_width(k)
    chunks = -(-k // width)
    assert 1 <= width <= rk.K_MAX and chunks == -(-k // rk.K_MAX)
    assert width == k if k <= rk.K_MAX else width % 4 == 0
    assert 0 < k - (chunks - 1) * width <= width


def test_cpu_oracle_chain():
    """The verify recipe on the port: 1D chain, full Krylov depth, vs scipy."""
    N, L = 1001, 25.0
    v = pt.deuteron_potential_radial(np.linspace(0, L, N))
    H = pt.build_chain_hamiltonian_1d(N, L, v, device="cpu")
    res = pt.eigsh(H, k=5, n=N, which="SA", dtype=torch.float64)
    oracle = np.sort(scipy.sparse.linalg.eigsh(H.to_scipy(), k=5, which="SA")[0])
    # Full Krylov depth in fp64: the Lanczos eigenvalues are scipy's to 1e-8.
    np.testing.assert_allclose(res.eigenvalues.numpy(), oracle, atol=1e-8, rtol=0)
    assert abs(float(res.eigenvalues[0]) - (-2.51712608)) < 1e-8


def test_import_turns_tf32_off():
    # TF32 keeps ~3 decimal digits in fp32 products and degrades Krylov
    # orthogonality; importing the port must turn it off.
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        importlib.reload(pt)
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import lanczos_tpu_torch, lanczos_tpu_torch.cli, lanczos_tpu_torch.convert\n"
        "import lanczos_tpu_torch.ops.stencil_kernels, lanczos_tpu_torch.ops._build\n"
        "import lanczos_tpu_torch.ops.interface_kernel, lanczos_tpu_torch.ops.composite2\n"
        "import lanczos_tpu_torch.solver.arnoldi, lanczos_tpu_torch.solver.two_sided\n"
        "import lanczos_tpu_torch.models.lattice, lanczos_tpu_torch.native\n"
        "import lanczos_tpu_torch.models.irr_hamiltonian, lanczos_tpu_torch.utils.io\n"
        "import lanczos_tpu_torch.solver.block, lanczos_tpu_torch.solver.look_ahead\n"
        "import lanczos_tpu_torch.utils.bench_impl, lanczos_tpu_torch.ops.ritz_kernels\n"
        "assert not [m for m in sys.modules if m.startswith('lanczos_tpu.') or m == 'lanczos_tpu']\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _imports(path: Path, package: str):
    """(module, name) for each name imported by the module at ``path`` of
    ``package``, relative imports resolved (``from . import x`` gives
    (package, x) and (package.x, "*"))."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name, "*") for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package.rsplit(".", node.level - 1)[0] if node.level else ""
            module = ".".join(p for p in (base, node.module) if p)
            out += [(module, a.name) for a in node.names]
            if node.module is None:
                out += [(f"{module}.{a.name}", "*") for a in node.names]
    return out


def test_cgs2_choice_and_reductions_each_have_one_home():
    """How a step orthogonalizes against the basis is decided in
    ops/cgs2_kernels.py and the reductions live in solver/rows.py: no module
    of the port imports an underscore name from solver/lanczos.py, rows.py
    imports nothing from it, ops/ imports nothing from solver/, and only
    cgs2_kernels.py names MAX_ROWS or an lt.cgs2.* counter."""
    root = Path(pt.__file__).resolve().parent
    lanczos_mod = "lanczos_tpu_torch.solver.lanczos"
    files = sorted(root.rglob("*.py"))
    assert len(files) > 40
    for path in files:
        rel = path.relative_to(root)
        package = ".".join(("lanczos_tpu_torch", *rel.parts[:-1]))
        for module, name in _imports(path, package):
            assert not (module == lanczos_mod and name.startswith("_")), (str(rel), name)
            if rel.as_posix() == "solver/rows.py":
                assert module != lanczos_mod, str(rel)
            if rel.parts[0] == "ops":
                assert not module.startswith("lanczos_tpu_torch.solver"), (str(rel), module)
        if rel.as_posix() != "ops/cgs2_kernels.py":
            text = path.read_text()
            assert "lt.cgs2." not in text and "MAX_ROWS" not in text, str(rel)
