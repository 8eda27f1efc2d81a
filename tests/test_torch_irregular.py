"""Port's irregular lattice, neighbor search, LSQ weights and ELL assembly
against lanczos_tpu on the same inputs (host numpy on both sides)."""

import jax  # noqa: F401  (kept on the CPU by conftest)
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.models import irr_hamiltonian as jax_irr  # noqa: E402
from lanczos_tpu.models import lattice as jax_lattice  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch import native  # noqa: E402
from lanczos_tpu_torch.models import irr_hamiltonian as irr  # noqa: E402
from lanczos_tpu_torch.models import irrlap, lattice  # noqa: E402

LATTICE_FIELDS = ("n_fine", "length", "box_depth", "spacings", "coords",
                  "box_of_point", "occupancy", "box_starts", "ndim")


def _mixed_spacings(bd=3):
    sp = np.full(bd**3, 2, dtype=np.int64)
    sp[bd**3 // 2] = 1
    return sp


def _assert_lattices_equal(a, b):
    for f in LATTICE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f)


@pytest.mark.parametrize("n,kwargs", [
    (24, dict(spacings=_mixed_spacings())),
    (48, dict(potential="deuteron")),  # potential-driven: spacings {1, 2}
    (24, dict(overwrite_spacing=True)),
])
def test_build_lattice_matches(n, kwargs):
    kj, kp = dict(kwargs), dict(kwargs)
    if kwargs.get("potential"):
        kj["potential"], kp["potential"] = lt.deuteron_potential_3d, pt.deuteron_potential_3d
    J = lt.build_lattice(n, 25.0, 3, **kj)
    P = pt.build_lattice(n, 25.0, 3, **kp)
    _assert_lattices_equal(P, J)
    assert P.num_points == J.num_points and P.s == J.s
    np.testing.assert_array_equal(P.physical_coords(), J.physical_coords())
    if kwargs.get("potential"):
        assert sorted(set(P.spacings.tolist())) == [1, 2]


def test_potential_spacings_unbalanced_and_exact_clamp_match():
    for kw in (dict(balance=False), dict(power_of_two=False), dict(samples=9)):
        np.testing.assert_array_equal(
            lattice.potential_spacings(72, 25.0, 3, pt.deuteron_potential_3d, **kw),
            jax_lattice.potential_spacings(72, 25.0, 3, lt.deuteron_potential_3d, **kw),
        )


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_find_neighbors_matches(backend):
    if backend == "native":
        assert native.available()
    J = lt.build_lattice(24, 25.0, 3, spacings=_mixed_spacings())
    P = pt.build_lattice(24, 25.0, 3, spacings=_mixed_spacings())
    for d, idx in ((1, None), (2, np.arange(0, P.num_points, 7))):
        nj, rj = jax_lattice.find_neighbors(J, d, idx, backend="numpy")
        npt, rp = lattice.find_neighbors(P, d, idx, backend=backend)
        np.testing.assert_array_equal(npt, nj)
        np.testing.assert_array_equal(rp, rj)


def test_laplacian_rows_match():
    lat_j = lt.build_lattice(24, 25.0, 3, spacings=_mixed_spacings())
    lat_p = pt.build_lattice(24, 25.0, 3, spacings=_mixed_spacings())
    nj, rj, wj = jax_irr.irregular_laplacian_rows(lat_j)
    npt, rp, wp = irr.irregular_laplacian_rows(lat_p)
    np.testing.assert_array_equal(npt, nj)
    np.testing.assert_array_equal(rp, rj)
    np.testing.assert_allclose(wp, wj, rtol=0, atol=1e-12)


def test_weights_and_mirror_filter_match():
    from lanczos_tpu.models import irrlap as jax_irrlap

    cloud = np.array([v for v in np.ndindex(3, 3, 3) if v != (1, 1, 1)]) - 1
    np.testing.assert_array_equal(
        pt.laplacian_weights(cloud * 2.0), lt.laplacian_weights(cloud * 2.0)
    )
    batch = np.random.default_rng(0).integers(-3, 4, (5, 30, 3))
    mask = np.random.default_rng(1).random((5, 30)) > 0.2
    np.testing.assert_array_equal(
        irrlap.laplacian_weights_batch(batch, mask), jax_irrlap.laplacian_weights_batch(batch, mask)
    )
    cache = irrlap.WeightCache()
    np.testing.assert_array_equal(cache.get(cloud), lt.laplacian_weights(cloud))
    assert len(cache) == 1
    pts = np.random.default_rng(2).integers(-2, 3, (40, 3))
    np.testing.assert_array_equal(
        lattice.mirror_symmetric_filter(pts), jax_lattice.mirror_symmetric_filter(pts)
    )


@pytest.mark.parametrize("symmetrize", [None, "average", "volume", "normal"])
def test_ell_assembly_matches(symmetrize):
    lat_j = lt.build_lattice(24, 25.0, 3, spacings=_mixed_spacings())
    lat_p = pt.build_lattice(24, 25.0, 3, spacings=_mixed_spacings())
    J = lt.assemble_irregular_hamiltonian(
        lat_j, lt.deuteron_potential_3d, symmetrize=symmetrize, dtype=np.float64
    )
    P = pt.assemble_irregular_hamiltonian(
        lat_p, pt.deuteron_potential_3d, symmetrize=symmetrize, dtype=torch.float64,
        device="cpu",
    )
    assert isinstance(P, pt.EllOperator) and P.dtype == torch.float64
    x = np.random.default_rng(3).standard_normal(lat_p.num_points)
    yj = np.asarray(J.matvec(x))
    # Same rows and the same potential up to the last bit of exp/pow.
    np.testing.assert_allclose(
        P.matvec(torch.from_numpy(x)).numpy(), yj, rtol=0, atol=1e-12 * np.abs(yj).max()
    )
    if symmetrize is None:
        np.testing.assert_array_equal(P.cols.numpy(), np.asarray(J.cols))


def test_neighbor_backends_agree_at_n60():
    lat = pt.build_lattice(60, 25.0, 3, potential=pt.deuteron_potential_3d)
    assert lat.num_points == 34000 and sorted(set(lat.spacings.tolist())) == [1, 2]
    for d in (1, 2):
        idx = None if d == 1 else np.arange(0, lat.num_points, 11)
        nn, rn = lattice.find_neighbors(lat, d, idx, backend="numpy")
        nv, rv = lattice.find_neighbors(lat, d, idx, backend="native")
        np.testing.assert_array_equal(nv, nn)
        np.testing.assert_array_equal(rv, rn)


def test_native_backend_errors_and_auto():
    lat2 = pt.build_lattice(16, 25.0, 2, ndim=2, spacings=np.array([1, 2, 2, 2]))
    with pytest.raises(RuntimeError, match="3D only"):
        lattice.find_neighbors(lat2, 1, backend="native")
    with pytest.raises(ValueError):
        lattice.find_neighbors(lat2, 1, backend="cuda")
    # "auto" on a 2D lattice takes the numpy path, as in the JAX package.
    na, ra = lattice.find_neighbors(lat2, 1)
    J = lt.build_lattice(16, 25.0, 2, ndim=2, spacings=np.array([1, 2, 2, 2]))
    nj, rj = jax_lattice.find_neighbors(J, 1)
    np.testing.assert_array_equal(na, nj)
    np.testing.assert_array_equal(ra, rj)
