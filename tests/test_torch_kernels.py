"""Port's stencil SpMV/SpMM against the JAX package's Pallas kernels.

The plain PyTorch versions (``stencil_spmv_reference`` /
``stencil_spmm_reference``) are held against ``stencil_spmv_pallas`` /
``stencil_spmm_pallas`` run in interpret mode, at every shape of
tests/test_pallas.py, and against ``lanczos_tpu``'s StencilOperator in fp64.
The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import jax  # noqa: F401  (kept on the CPU by conftest)
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.ops.operators import make_stencil_operator as jax_make_stencil  # noqa: E402
from lanczos_tpu.ops.pallas_kernels import (  # noqa: E402
    stencil_spmm_pallas,
    stencil_spmv_pallas,
)

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.convert import from_jax  # noqa: E402
from lanczos_tpu_torch.ops import stencil_kernels as sk  # noqa: E402

ANISO = (
    (6, 10, 14),
    [(0, 0, 0), (1, 0, 0), (0, -1, 0), (0, 0, 1), (-1, 1, -1)],
    [2.0, -1.0, 0.5, 0.25, 1.5],
)
FLAT_OFFS = [
    (0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0),
    (1, 0, 0), (-1, 0, 0), (1, 1, 1), (-1, -1, -1), (0, 1, -1),
]
FLAT_W = [1.0, 0.5, -0.5, 0.25, 2.0, -1.5, 3.0, 0.125, -0.25, 0.75]


def _jax_op(case, dtype):
    """The JAX package's operator for a named test shape."""
    if case == "aniso":
        shape, offs, w = ANISO
        return jax_make_stencil(shape, offs, w, dtype=dtype)
    if case == "flat":
        diag = np.linspace(-1.0, 1.0, 8 * 16 * 8)
        return jax_make_stencil((8, 16, 8), FLAT_OFFS, FLAT_W, diag=diag, dtype=dtype)
    n, stencil = case
    return lt.build_regular_hamiltonian(
        n, 25.0, lt.deuteron_potential_3d, stencil=stencil, dtype=dtype
    )


# fp32 tolerances are test_pallas.py's: the Pallas kernel sums the taps in
# another order (grouped by in-plane shift, or the graded ladder).
PALLAS_CASES = [
    ((12, "27"), 2e-5, 1e-4),
    ((10, "7"), 2e-5, 1e-4),
    ((8, "27"), 2e-5, 1e-4),
    ("aniso", 1e-5, 1e-4),  # non-cubic grid, asymmetric taps, no diag
    ("flat", 1e-5, 1e-4),  # the Pallas flat-plane branch, with diag
    ((16, "27"), 2e-5, 1e-4),  # the Pallas graded-ladder branch
]


@pytest.mark.parametrize("case,atol_scale,rtol", PALLAS_CASES)
def test_spmv_reference_matches_pallas(case, atol_scale, rtol):
    H = _jax_op(case, np.float32)
    P = from_jax(H, device="cpu")
    if case == (16, "27"):
        assert H.graded is not None and P.graded == H.graded
    x = np.random.default_rng(0).standard_normal(H.shape[0]).astype(np.float32)
    y_pal = np.asarray(stencil_spmv_pallas(H, x, interpret=True))
    y_ref = sk.stencil_spmv_reference(P, torch.from_numpy(x)).numpy()
    scale = float(np.max(np.abs(y_pal)))
    np.testing.assert_allclose(y_ref, y_pal, atol=atol_scale * scale, rtol=rtol)
    # On a CPU tensor the wrapper is the plain version, bit for bit.
    np.testing.assert_array_equal(sk.stencil_spmv(P, torch.from_numpy(x)).numpy(), y_ref)


# The SpMM at every SpMV shape, plus the 27-point N=10 grid, at b=3.
@pytest.mark.parametrize("case,atol_scale,rtol", PALLAS_CASES + [((10, "27"), 2e-5, 1e-4)])
def test_spmm_reference_matches_pallas(case, atol_scale, rtol):
    H = _jax_op(case, np.float32)
    P = from_jax(H, device="cpu")
    X = np.random.default_rng(2).standard_normal((H.shape[0], 3)).astype(np.float32)
    Y_pal = np.asarray(stencil_spmm_pallas(H, X, interpret=True))
    Y_ref = sk.stencil_spmm_reference(P, torch.from_numpy(X)).numpy()
    scale = float(np.max(np.abs(Y_pal)))
    np.testing.assert_allclose(Y_ref, Y_pal, atol=atol_scale * scale, rtol=rtol)
    np.testing.assert_array_equal(sk.stencil_spmm(P, torch.from_numpy(X)).numpy(), Y_ref)


def test_offsets_beyond_unit_rejected():
    op = pt.ops.make_stencil_operator((8, 8, 8), [(2, 0, 0)], [1.0], device="cpu")
    assert not sk.kernel_supported(op)
    with pytest.raises(ValueError):
        sk.stencil_spmv(op, torch.zeros(512))
    with pytest.raises(ValueError):
        sk.stencil_spmm(op, torch.zeros(512, 2))
    # The operator itself takes the roll path for such a stencil, as the JAX
    # package does: x[c + 2] along z.
    x = torch.arange(512, dtype=torch.float32)
    expected = torch.roll(x.reshape(8, 8, 8), -2, dims=0).reshape(-1)
    np.testing.assert_array_equal(op.matvec(x).numpy(), expected.numpy())


# fp64: the roll sums taps in the same order as lanczos_tpu's roll path;
# only the rounding of the last bits may differ.
@pytest.mark.parametrize("case", [(8, "27"), (6, "7"), "aniso", "flat"])
def test_reference_matches_lanczos_tpu_fp64(case):
    H = _jax_op(case, np.float64)
    P = from_jax(H, device="cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal(H.shape[0])
    X = rng.standard_normal((H.shape[0], 4))
    np.testing.assert_allclose(
        sk.stencil_spmv_reference(P, torch.from_numpy(x)).numpy(),
        np.asarray(H.matvec(x)), rtol=1e-12, atol=1e-12 * np.max(np.abs(x)) * 100,
    )
    np.testing.assert_allclose(
        sk.stencil_spmm_reference(P, torch.from_numpy(X)).numpy(),
        np.asarray(H.matmat(X)), rtol=1e-12, atol=1e-12 * np.max(np.abs(X)) * 100,
    )


def test_wrapper_rejects_bad_operands():
    P = pt.build_regular_hamiltonian(
        6, 25.0, pt.deuteron_potential_3d, stencil="27", device="cpu"
    )
    m = P.shape[0]
    with pytest.raises(TypeError):  # dtype differs from the operator's
        sk.stencil_spmv(P, torch.zeros(m, dtype=torch.float64))
    with pytest.raises(TypeError):  # not float32/float64
        sk.stencil_spmv(P, torch.zeros(m, dtype=torch.float16))
    with pytest.raises(ValueError):  # wrong length
        sk.stencil_spmv(P, torch.zeros(m + 1))
    with pytest.raises(ValueError):  # not contiguous
        sk.stencil_spmm(P, torch.zeros(3, m).T)
    with pytest.raises(ValueError):  # a device that is neither CPU nor CUDA
        sk.stencil_spmv(P, torch.zeros(m, device="meta"))


def test_cpu_calls_do_not_count_launches():
    P = pt.build_regular_hamiltonian(
        6, 25.0, pt.deuteron_potential_3d, stencil="27", device="cpu"
    )
    before = (sk.stencil_spmv.launches, sk.stencil_spmm.launches)
    P.matvec(torch.ones(P.shape[0]))
    P.matmat(torch.ones(P.shape[0], 2))
    assert (sk.stencil_spmv.launches, sk.stencil_spmm.launches) == before
