"""The port's v1 CompositeOperator and its sharded form against the JAX
package's ``ops/composite.py``.

Unsharded (``tests/test_composite.py``'s mixed lattice, n=24, fp64): the
port's build equals JAX's array for array (``perm``, level adjacency and
weights, interface rows and buckets; floats to 1e-14 relative, since the
two packages' potentials may differ in the last bit), its matvec and rmatvec equal the
port's padded-ELL assembly and JAX's composite to 1e-12 max|y|, and
``from_jax`` carries the JAX operator over unchanged.  Sharded
(``tests/test_distributed.py``'s lattice, n=12): ``shard_composite``'s host
arrays equal JAX's; one gloo world of 4 spawned ranks
(``tests/test_torch_rank_work.py:composite_v1``, no JAX) runs the matvec, equal
to JAX's sharded matvec on a 4-device mesh (1e-12), and the sharded
``eigs_nonsym``, equal to JAX's and the port's unsharded solves (k=3,
tol 1e-9: 1e-9 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.ops.composite import shard_composite as jax_shard_composite  # noqa: E402
from lanczos_tpu.parallel import make_row_mesh as jax_mesh  # noqa: E402
from lanczos_tpu.parallel import shard_operator as jax_shard  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.convert import from_jax  # noqa: E402
from lanczos_tpu_torch.ops.composite import shard_composite  # noqa: E402
from lanczos_tpu_torch.parallel.launch import run_ranks  # noqa: E402

import test_torch_rank_work  # noqa: E402

D = 4


def _mixed(pkg, n=24, bd=3):
    sp = np.full(bd**3, 2, dtype=np.int64)
    sp[bd**3 // 2] = 1
    return pkg.build_lattice(n, 25.0, bd, spacings=sp)


@pytest.fixture(scope="module")
def ops():
    comp_j, perm_j = lt.assemble_irregular_hamiltonian_composite(
        _mixed(lt), lt.deuteron_potential_3d, dtype=np.float64)
    lat = _mixed(pt)
    comp_t, perm_t = pt.assemble_irregular_hamiltonian_composite(
        lat, pt.deuteron_potential_3d, dtype=torch.float64, device="cpu")
    ell = pt.assemble_irregular_hamiltonian(lat, pt.deuteron_potential_3d,
                                            dtype=torch.float64, device="cpu")
    return comp_j, perm_j, comp_t, perm_t, ell


def test_build_equals_jax(ops):
    comp_j, perm_j, comp_t, perm_t, _ = ops
    np.testing.assert_array_equal(perm_t, perm_j)
    np.testing.assert_allclose(comp_t.diag.numpy(), np.asarray(comp_j.diag), rtol=1e-14)
    assert len(comp_t.levels) == len(comp_j.levels)
    for lt_, lj in zip(comp_t.levels, comp_j.levels):
        assert (lt_.start, lt_.nbox, lt_.m) == (lj.start, lj.nbox, lj.m)
        np.testing.assert_array_equal(lt_.adjacency.numpy(), np.asarray(lj.adjacency))
        np.testing.assert_allclose(lt_.weights.numpy(), np.asarray(lj.weights), rtol=1e-14)
    for name in ("ifc_rows", "ifc_cols"):
        np.testing.assert_array_equal(getattr(comp_t, name).numpy(),
                                      np.asarray(getattr(comp_j, name)))
    np.testing.assert_allclose(comp_t.ifc_vals.numpy(), np.asarray(comp_j.ifc_vals),
                               rtol=1e-14, atol=0)
    assert len(comp_t.ifc_buckets) == len(comp_j.ifc_buckets)
    for bt, bj in zip(comp_t.ifc_buckets, comp_j.ifc_buckets):
        for a, b in zip(bt, bj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14, atol=0)


@pytest.mark.parametrize("which", ["matvec", "rmatvec"])
def test_composite_matches_ell_and_jax(ops, which):
    """tests/test_composite.py:33,46 on the port, and against JAX's."""
    comp_j, perm_j, comp_t, perm, ell = ops
    x = np.random.default_rng(0 if which == "matvec" else 1).normal(size=len(perm))
    y_ell = getattr(ell, which)(torch.as_tensor(x)).numpy()
    y = np.empty_like(y_ell)
    y[perm] = getattr(comp_t, which)(torch.as_tensor(x[perm])).numpy()
    tol = 1e-12 * np.abs(y_ell).max()
    np.testing.assert_allclose(y, y_ell, rtol=0, atol=tol)
    y_j = np.asarray(jax.jit(getattr(comp_j, which))(jnp.asarray(x[perm])))
    np.testing.assert_allclose(y[perm], y_j, rtol=0, atol=tol)


def test_from_jax_composite(ops):
    comp_j, perm_j, comp_t, _, _ = ops
    conv = from_jax(comp_j, device="cpu")
    x = torch.as_tensor(np.random.default_rng(3).normal(size=comp_t.shape[0]))
    for which in ("matvec", "rmatvec"):
        y = getattr(comp_t, which)(x).numpy()
        np.testing.assert_allclose(getattr(conv, which)(x).numpy(), y, rtol=0,
                                   atol=1e-12 * np.abs(y).max())


def test_interface_fraction_is_small(ops):
    comp_t, perm = ops[2], ops[3]
    assert 0 < comp_t.ifc_rows.shape[0] / len(perm) < 0.5


@pytest.fixture(scope="module")
def small():
    """tests/test_distributed.py's composite_pair, in both packages."""
    comp_j, _ = lt.assemble_irregular_hamiltonian_composite(
        lt.build_lattice(12, 25.0, 3, overwrite_spacing=True), lt.deuteron_potential_3d,
        dtype=np.float64)
    comp_t, _ = pt.assemble_irregular_hamiltonian_composite(
        pt.build_lattice(12, 25.0, 3, overwrite_spacing=True), pt.deuteron_potential_3d,
        dtype=torch.float64, device="cpu")
    return comp_j, comp_t


@pytest.fixture(scope="module")
def case(small):
    return {"x": np.random.default_rng(4).standard_normal(small[0].shape[0])}


@pytest.fixture(scope="module")
def ranks(case):
    return run_ranks(test_torch_rank_work.composite_v1, D, case, device="cpu", timeout=240.0)


def test_shard_composite_equals_jax(small):
    comp_j, comp_t = small
    sj, st = jax_shard_composite(comp_j, D), shard_composite(comp_t, D)
    assert (st.P_loc, st.level_meta) == (sj.P_loc, sj.level_meta)
    np.testing.assert_array_equal(st.idx_map, sj.idx_map)
    for name in ("keep", "ifc_rows", "ifc_blk_ids"):
        np.testing.assert_array_equal(getattr(st, name), np.asarray(getattr(sj, name)), name)
    # The potential's float64 values may differ in the last bit between the
    # packages' evaluations.
    for name in ("diag", "ifc_blk_w"):
        np.testing.assert_allclose(getattr(st, name), np.asarray(getattr(sj, name)),
                                   rtol=1e-14, atol=0, err_msg=name)
    for a, b in zip(st.level_adj, sj.level_adj):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(st.live_mask(), sj.live_mask())


def test_sharded_matvec_matches_jax(small, case, ranks):
    """The 4-rank matvec == JAX's sharded composite on a 4-device mesh and
    the unsharded one; ghost slots stay exactly zero."""
    comp_j, comp_t = small
    op_j = jax_shard(comp_j, jax_mesh(D))
    sc = op_j.host
    y = np.concatenate([r["y"] for r in ranks])
    y_j = np.asarray(jax.jit(op_j.matvec)(jnp.asarray(sc.to_sharded(case["x"]))))
    tol = 1e-12 * np.abs(y_j).max()
    np.testing.assert_allclose(y, y_j, rtol=0, atol=tol)
    y1 = comp_t.matvec(torch.as_tensor(case["x"])).numpy()
    np.testing.assert_allclose(sc.from_sharded(y), y1, rtol=0, atol=tol)
    np.testing.assert_array_equal(y * (1 - sc.live_mask()), 0.0)
    np.testing.assert_array_equal(np.concatenate([r["live"] for r in ranks]), sc.live_mask())


def test_sharded_eigs_nonsym_matches(small, ranks):
    """Krylov-Schur on the 4-rank composite == JAX's and the port's
    unsharded solves (k=3, tol=1e-9, fp64)."""
    comp_j, comp_t = small
    vals = ranks[0]["vals"]
    for r in ranks:
        np.testing.assert_array_equal(r["vals"], vals)
    ref = lt.eigs_nonsym(comp_j, k=3, tol=1e-9, which="SR", dtype="float64")
    np.testing.assert_allclose(vals, np.asarray(ref.eigenvalues), rtol=1e-9, atol=1e-9)
    one = pt.eigs_nonsym(comp_t, k=3, tol=1e-9, which="SR")
    np.testing.assert_allclose(vals, one.eigenvalues.numpy(), rtol=1e-9, atol=1e-9)
    assert ranks[0]["resid"].max() < 1e-9
