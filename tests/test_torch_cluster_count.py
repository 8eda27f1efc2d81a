"""How many copies of the N=60 lattice's 2.514/2.524 cluster a single-vector
Krylov–Schur solve holds, in both packages (the card's phase 16 solve, on
the CPU).

The cluster is five exactly degenerate copies (2.51392 x3, 2.52358 x2;
``scripts/compare_nonsym_refine.py``).  In exact arithmetic a single-vector
Krylov space holds one copy of each eigenvalue; the others enter through
rounding, so their count depends on the operator's rounding, not on the
package.  Both packages run ``eigs_nonsym(k=8, max_basis=120, tol=1e-4,
compensated=True)`` in fp32 (phase 16's arguments) from the same
lattice-order start (``default_rng(99)``), on the ELL assembly and on the
CompositeV2 (the start scattered through ``idx_map``).  Held: on the ELL
both packages hold the same copies and the same values (to the fp32
solve's tolerance, 5e-4); the port's CompositeV2 solve holds at least four
copies, and its values up to the ELL solve's top one lie on the ELL
solve's.  Printed (``-s``): each count, and the JAX package's CompositeV2
outcome.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402

KW = dict(k=8, max_basis=120, tol=1e-4, compensated=True)
TOL = 5e-4


def _copies(vals):
    v = np.asarray(vals)
    return int(((v > 2.5) & (v < 2.53)).sum())


def _nearest(a, b):
    """Largest distance from a value of ``a`` to the nearest of ``b``."""
    return float(np.abs(np.asarray(a)[:, None] - np.asarray(b)[None, :]).min(axis=1).max())


@pytest.fixture(scope="module")
def lattices():
    return (lt.build_lattice(60, 25.0, 3, potential=lt.deuteron_potential_3d),
            pt.build_lattice(60, 25.0, 3, potential=pt.deuteron_potential_3d))


@pytest.fixture(scope="module")
def ell_solves(lattices):
    lat_j, lat_p = lattices
    v0 = np.random.default_rng(99).uniform(-1, 1, lat_j.num_points)
    hj = lt.assemble_irregular_hamiltonian(lat_j, lt.deuteron_potential_3d, dtype=np.float32)
    hp = pt.assemble_irregular_hamiltonian(lat_p, pt.deuteron_potential_3d, dtype=torch.float32,
                                           device="cpu")
    rj = lt.eigs_nonsym(hj, v0=v0, dtype="float32", **KW)
    rp = pt.eigs_nonsym(hp, v0=v0, **KW)
    return np.sort(np.asarray(rj.eigenvalues)), np.sort(rp.eigenvalues.numpy())


def test_ell_cluster_copies_equal_jax(ell_solves):
    jax_vals, port_vals = ell_solves
    print(f"ELL: lanczos_tpu holds {_copies(jax_vals)} copies, lanczos_tpu_torch "
          f"{_copies(port_vals)}; {np.round(port_vals, 5).tolist()}")
    assert _copies(port_vals) == _copies(jax_vals) == 5
    np.testing.assert_allclose(port_vals, jax_vals, rtol=0, atol=TOL)


def test_composite_v2_cluster_copies(lattices, ell_solves):
    lat_j, lat_p = lattices
    cp, idx_map = pt.assemble_irregular_hamiltonian_composite2(
        lat_p, pt.deuteron_potential_3d, dtype=torch.float32, device="cpu")
    v0 = np.zeros(cp.shape[0])
    v0[idx_map] = np.random.default_rng(99).uniform(-1, 1, lat_p.num_points)
    port_vals = np.sort(pt.eigs_nonsym(cp, v0=v0, **KW).eigenvalues.numpy())
    cj, idx_j = lt.assemble_irregular_hamiltonian_composite2(
        lat_j, lt.deuteron_potential_3d, dtype=np.float32)
    assert np.array_equal(np.asarray(idx_j), idx_map)
    try:
        rj = lt.eigs_nonsym(cj, v0=v0, dtype="float32", **KW)
        jax_outcome = f"{_copies(rj.eigenvalues)} copies"
    except np.linalg.LinAlgError as e:  # scipy's sorted Schur form, in the JAX package's cycle
        jax_outcome = f"{type(e).__name__}: {e}"
    print(f"CompositeV2: lanczos_tpu_torch holds {_copies(port_vals)} copies "
          f"({np.round(port_vals, 5).tolist()}); lanczos_tpu: {jax_outcome}")
    assert _copies(port_vals) >= 4
    # With a copy fewer, the solve reaches past the ELL solve's top value.
    inside = port_vals[port_vals <= ell_solves[1].max() + TOL]
    assert len(inside) >= 7 and _nearest(inside, ell_solves[1]) <= TOL
