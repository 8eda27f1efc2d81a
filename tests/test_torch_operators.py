"""Port's operators, grids and potentials against lanczos_tpu on the same inputs."""

import jax  # noqa: F401  (kept on the CPU by conftest)
import numpy as np
import pytest
import scipy.sparse
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.ops import make_stencil_operator as jax_make_stencil  # noqa: E402
from lanczos_tpu.ops import stencil_to_ell as jax_stencil_to_ell  # noqa: E402
from lanczos_tpu.solver.lanczos import lanczos_kernel as jax_lanczos_kernel  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.convert import from_jax  # noqa: E402
from lanczos_tpu_torch.ops import make_stencil_operator, stencil_to_ell  # noqa: E402

from conftest import random_sparse_symmetric  # noqa: E402

# fp64 throughout: both sides do the same arithmetic, up to summation order
# and the last bit of exp/pow, so 1e-12 relative is the bar.
RTOL = 1e-12


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_potentials_match():
    r = np.linspace(0.0, 25.0, 301)
    np.testing.assert_allclose(
        pt.deuteron_potential_radial(r).numpy(),
        np.asarray(lt.deuteron_potential_radial(r)), rtol=1e-13, atol=1e-12,
    )
    x, y, z = np.random.default_rng(0).uniform(-3, 3, (3, 50))
    np.testing.assert_allclose(
        pt.deuteron_potential_3d(_t(x), _t(y), _t(z)).numpy(),
        np.asarray(lt.deuteron_potential_3d(x, y, z)), rtol=1e-13, atol=1e-12,
    )
    assert pt.kinetic_prefactor(0.25) == lt.kinetic_prefactor(0.25)
    np.testing.assert_array_equal(
        pt.square_well_1d(20, dtype=torch.float64, device="cpu").numpy(),
        np.asarray(lt.square_well_1d(20)),
    )


@pytest.mark.parametrize("ndim,points", [(1, "auto"), (2, "auto"), (3, "7"), (3, "27")])
def test_laplacian_stencil_matches(ndim, points):
    offs_p, w_p = pt.laplacian_stencil(ndim, points)
    offs_j, w_j = lt.laplacian_stencil(ndim, points)
    assert offs_p == offs_j
    np.testing.assert_array_equal(w_p, w_j)


@pytest.mark.parametrize(
    "n,ndim,stencil", [(10, 3, "27"), (8, 3, "7"), (12, 2, "auto"), (30, 1, "auto")]
)
def test_build_regular_hamiltonian_matches(n, ndim, stencil):
    H = lt.build_regular_hamiltonian(
        n, 25.0, lt.deuteron_potential_3d if ndim == 3 else None,
        ndim=ndim, stencil=stencil, dtype="float64",
    )
    P = pt.build_regular_hamiltonian(
        n, 25.0, pt.deuteron_potential_3d if ndim == 3 else None,
        ndim=ndim, stencil=stencil, dtype="float64", device="cpu",
    )
    assert P.grid_shape == H.grid_shape and P.offsets == H.offsets
    assert P.graded == H.graded
    np.testing.assert_array_equal(P.weights.numpy(), np.asarray(H.weights))
    if ndim == 3:
        np.testing.assert_allclose(P.diag.numpy(), np.asarray(H.diag), rtol=1e-13, atol=1e-12)
    else:
        assert P.diag is None and H.diag is None
    assert P.dtype == torch.float64
    assert pt.build_regular_hamiltonian(
        n, 25.0, ndim=ndim, stencil=stencil, device="cpu"
    ).dtype == torch.float32


def test_build_chain_hamiltonian_matches():
    n = 60
    v = np.asarray(lt.deuteron_potential_radial(np.linspace(0, 25.0, n)))
    H = lt.build_chain_hamiltonian_1d(n, 25.0, v)
    P = pt.build_chain_hamiltonian_1d(n, 25.0, v, device="cpu")
    assert P.dtype == torch.float64
    np.testing.assert_array_equal(P.to_scipy().toarray(), H.to_scipy().toarray())


def test_ell_operator_matches(rng):
    m, b = 120, 5
    sym = random_sparse_symmetric(rng, m)
    nonsym = scipy.sparse.random(
        m, m, density=0.06, random_state=np.random.RandomState(7), dtype=np.float64
    ).tocsr()
    x = rng.standard_normal(m)
    X = rng.standard_normal((m, b))
    for a in (sym, nonsym):
        J = lt.ell_from_scipy(a, dtype=np.float64)
        P = pt.ell_from_scipy(a, dtype=np.float64, device="cpu")
        assert isinstance(P, pt.EllOperator) and P.cols.dtype == torch.int64
        np.testing.assert_allclose(P.matvec(_t(x)).numpy(), np.asarray(J.matvec(x)), rtol=RTOL)
        np.testing.assert_allclose(P.rmatvec(_t(x)).numpy(), np.asarray(J.rmatvec(x)), rtol=RTOL)
        np.testing.assert_allclose(
            P.matmat(_t(X)).numpy(), np.asarray(J.matmat(X)), rtol=RTOL, atol=1e-13
        )
        np.testing.assert_allclose(
            P.transpose().matvec(_t(x)).numpy(), np.asarray(J.transpose().matvec(x)),
            rtol=RTOL,
        )
        np.testing.assert_allclose(P.to_scipy().toarray(), a.toarray(), rtol=RTOL)


def test_ell_from_coo_padding_and_duplicates():
    rows, cols, vals = [0, 0, 2, 2, 2], [1, 1, 0, 2, 1], [1.0, 2.0, 3.0, 4.0, 5.0]
    J = lt.ell_from_coo(rows, cols, vals, 3, dtype=np.float64)
    P = pt.ell_from_coo(rows, cols, vals, 3, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(P.to_scipy().toarray(), J.to_scipy().toarray())
    # Row 1 is empty: padded with a self reference of weight 0.
    assert P.cols[1].tolist() == [1, 1, 1] and P.vals[1].tolist() == [0.0, 0.0, 0.0]


def _stencil_pair(ndim, kind):
    """(JAX, port) stencil operators in fp64 for 1D/2D/3D test cases."""
    rng = np.random.default_rng(ndim * 10 + len(kind))
    shape = {1: (17,), 2: (6, 9), 3: (5, 6, 7)}[ndim]
    if kind == "asym":
        offs = [tuple(int(o) for o in rng.integers(-1, 2, ndim)) for _ in range(5)]
        w = rng.standard_normal(5)
    else:
        offs, w = lt.laplacian_stencil(ndim, kind)
    diag = rng.standard_normal(int(np.prod(shape)))
    J = jax_make_stencil(shape, offs, w, diag=diag, dtype=np.float64)
    return J, make_stencil_operator(shape, offs, w, diag=diag, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize(
    "ndim,kind", [(1, "auto"), (2, "auto"), (3, "7"), (3, "27"), (1, "asym"), (3, "asym")]
)
def test_stencil_operator_matches(ndim, kind):
    J, P = _stencil_pair(ndim, kind)
    assert P.graded == J.graded
    assert P.is_symmetric_stencil == J.is_symmetric_stencil
    rng = np.random.default_rng(5)
    m = J.shape[0]
    x, X = rng.standard_normal(m), rng.standard_normal((m, 3))
    np.testing.assert_allclose(P.matvec(_t(x)).numpy(), np.asarray(J.matvec(x)), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(P.rmatvec(_t(x)).numpy(), np.asarray(J.rmatvec(x)), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(P.matmat(_t(X)).numpy(), np.asarray(J.matmat(X)), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(P(_t(x)).numpy(), P.matvec(_t(x)).numpy(), rtol=0)
    # The ELL materialization agrees with both the port and the JAX package.
    E = stencil_to_ell(P)
    np.testing.assert_allclose(E.to_scipy().toarray(), jax_stencil_to_ell(J).to_scipy().toarray(), rtol=RTOL)
    np.testing.assert_allclose(E.matvec(_t(x)).numpy(), P.matvec(_t(x)).numpy(), rtol=1e-11, atol=1e-11)


def test_as_operator():
    a = np.random.default_rng(0).standard_normal((6, 6))
    D = pt.as_operator(a, device="cpu")
    assert isinstance(D, pt.DenseOperator) and D.dtype == torch.float64
    x = np.ones(6)
    np.testing.assert_allclose(D.matvec(_t(x)).numpy(), a @ x, rtol=RTOL)
    np.testing.assert_allclose(D.rmatvec(_t(x)).numpy(), a.T @ x, rtol=RTOL)
    assert pt.as_operator(a, dtype="float32", device="cpu").dtype == torch.float32
    S = pt.as_operator(scipy.sparse.csr_matrix(a), device="cpu")
    assert isinstance(S, pt.EllOperator)
    np.testing.assert_allclose(S.to_dense().numpy(), a, rtol=RTOL)
    assert pt.as_operator(S) is S


def test_operators_are_modules_with_buffers():
    P = pt.build_regular_hamiltonian(6, 25.0, pt.deuteron_potential_3d, device="cpu")
    assert set(dict(P.named_buffers())) == {"weights", "diag"}
    assert P.to("cpu") is P and P.device.type == "cpu"
    assert P.vec_shape == (216,)


def test_from_jax_round_trips():
    H = lt.build_regular_hamiltonian(6, 25.0, lt.deuteron_potential_3d, stencil="27", dtype="float64")
    P = from_jax(H, device="cpu")
    assert isinstance(P, pt.StencilOperator)
    assert (P.grid_shape, P.offsets, P.graded) == (H.grid_shape, H.offsets, H.graded)
    np.testing.assert_array_equal(P.weights.numpy(), np.asarray(H.weights))
    np.testing.assert_array_equal(P.diag.numpy(), np.asarray(H.diag))
    assert from_jax(H, dtype=torch.float32, device="cpu").dtype == torch.float32

    E = lt.ell_from_scipy(random_sparse_symmetric(np.random.default_rng(1), 40), dtype=np.float64)
    PE = from_jax(E, device="cpu")
    np.testing.assert_array_equal(PE.cols.numpy(), np.asarray(E.cols))
    np.testing.assert_array_equal(PE.vals.numpy(), np.asarray(E.vals))

    a = np.random.default_rng(2).standard_normal((5, 5))
    np.testing.assert_array_equal(from_jax(lt.DenseOperator(jax.numpy.asarray(a)), device="cpu").A.numpy(), a)

    fac = jax_lanczos_kernel(H.matvec, np.ones(H.shape[0]), 6)
    pf = from_jax(fac, device="cpu")
    assert isinstance(pf, pt.LanczosFactorization)
    for name in ("alpha", "beta", "V", "resid"):
        np.testing.assert_array_equal(getattr(pf, name).numpy(), np.asarray(getattr(fac, name)))
    assert int(pf.breakdown_iter) == int(fac.breakdown_iter)

    with pytest.raises(TypeError):
        from_jax(np.zeros(3))


def test_default_device_is_cuda():
    """A constructor called without ``device`` builds on the card; with no
    card visible it raises from PyTorch instead of quietly using the CPU."""
    import os
    import subprocess
    import sys

    code = (
        "import lanczos_tpu_torch as lt\n"
        "from lanczos_tpu_torch._util import DEFAULT_DEVICE\n"
        "assert DEFAULT_DEVICE == 'cuda'\n"
        "try:\n"
        "    H = lt.build_regular_hamiltonian(8, 25.0)\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__)\n"
        "else:\n"
        "    print('built on', H.device)\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised"), out.stdout

