"""The port's native ELL packer (``lanczos_tpu_torch/native``: ``pack_ell``
in ``neighbor_engine.cpp``) against the JAX package's, and the port's
``ell_from_coo`` against ``lanczos_tpu.ops.assemble.ell_from_coo`` through
both of its paths: the native packer, and numpy with the engine patched
away.  Packing moves numbers without arithmetic, so every comparison is
exact.  Skips cleanly when no C++ compiler is present.
"""

import numpy as np
import pytest
import torch

import lanczos_tpu as ltj
import lanczos_tpu_torch as lt
from lanczos_tpu import native as native_jax
from lanczos_tpu.ops.assemble import ell_from_coo as ell_from_coo_jax
from lanczos_tpu_torch import native
from lanczos_tpu_torch.ops.assemble import coo_sum_duplicates, ell_from_coo

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native engine unavailable (no g++?)"
)


def random_coo(m=50, nnz=400, seed=0):
    """``tests/test_native.py``'s random COO: duplicates and empty rows."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, m, nnz), rng.integers(0, m, nnz), rng.normal(size=nnz), m


def sorted_unique(rows, cols, vals, m):
    rows, cols, vals = coo_sum_duplicates(rows, cols, vals, m)
    order = np.argsort(rows, kind="stable")
    return rows[order], cols[order], vals[order]


@pytest.fixture
def numpy_path(monkeypatch):
    monkeypatch.setattr(native, "_lib", lambda: None)


@pytest.mark.parametrize("k_extra", [0, 3])
def test_pack_ell_native_matches_jax(k_extra):
    rows, cols, vals, m = random_coo()
    rows, cols, vals = sorted_unique(rows, cols, vals, m)
    k = int(np.bincount(rows, minlength=m).max()) + k_extra
    got = native.pack_ell_native(rows, cols, vals, m, k)
    ref = native_jax.pack_ell_native(rows, cols, vals, m, k)
    assert got is not None and ref is not None
    assert got[0].shape == (m, k) and got[0].dtype == np.int64
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    empty = np.setdiff1d(np.arange(m), rows)  # padding: col = row, val = 0
    np.testing.assert_array_equal(got[0][empty], np.repeat(empty[:, None], k, axis=1))
    assert not got[1][empty].any()


@pytest.mark.parametrize("case", ["unsorted", "out_of_range", "row_too_long"])
def test_pack_ell_native_rejects_bad_coo(case):
    rows, cols, vals = np.array([0, 1, 1, 3]), np.array([0, 1, 2, 3]), np.ones(4)
    m, k = 4, 2
    if case == "unsorted":
        rows = rows[::-1].copy()
    elif case == "out_of_range":
        m = 3
    else:
        k = 1
    with pytest.raises(ValueError):
        native.pack_ell_native(rows, cols, vals, m, k)


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k_pad", [None, 16])
def test_ell_from_coo_matches_jax(request, path, dtype, k_pad):
    if path == "numpy":
        request.getfixturevalue("numpy_path")
    rows, cols, vals, m = random_coo()
    ell = ell_from_coo(rows, cols, vals, m, dtype=dtype, k_pad=k_pad, device="cpu")
    ref = ell_from_coo_jax(rows, cols, vals, m, dtype=np.dtype(str(dtype)[6:]), k_pad=k_pad)
    assert ell.vals.dtype == dtype
    np.testing.assert_array_equal(ell.cols.numpy(), np.asarray(ref.cols))
    np.testing.assert_array_equal(ell.vals.numpy(), np.asarray(ref.vals))


def test_irregular_assembly_same_through_both_paths(monkeypatch):
    """The port's ELL assembly of a mixed lattice is the same operator
    through the native packer and through numpy, and equals the JAX
    package's (1e-14 relative: the two packages' potentials may differ in
    the last bit)."""
    sp = np.full(27, 2, dtype=np.int64)
    sp[13] = 1
    lat = lt.build_lattice(12, 25.0, 3, spacings=sp)
    args = (lt.deuteron_potential_3d,)
    kw = dict(symmetrize=None, dtype=torch.float64, device="cpu")
    a = lt.assemble_irregular_hamiltonian(lat, *args, **kw)
    monkeypatch.setattr(native, "_lib", lambda: None)
    b = lt.assemble_irregular_hamiltonian(lat, *args, **kw)
    np.testing.assert_array_equal(a.cols.numpy(), b.cols.numpy())
    np.testing.assert_array_equal(a.vals.numpy(), b.vals.numpy())
    lat_j = ltj.build_lattice(12, 25.0, 3, spacings=sp)
    ref = ltj.assemble_irregular_hamiltonian(lat_j, ltj.deuteron_potential_3d, symmetrize=None,
                                             dtype=np.float64).to_scipy().toarray()
    got = a.to_scipy().toarray()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-14 * np.abs(ref).max())
