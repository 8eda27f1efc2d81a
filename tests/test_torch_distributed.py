"""The port's row sharding (``lanczos_tpu_torch.parallel``) against the
JAX package's, at D = 4 ranks.

One gloo world of 4 spawned ranks (``tests/test_torch_rank_work.py:distributed``,
which imports no JAX) runs the sharded stencil, ELL and halo-ELL matvecs
and Lanczos, the sharded restarted solve and its checkpoint resume; this
process computes the JAX side on a 4-device mesh of the virtual CPU devices
(``make_row_mesh(4)``), with the same numpy inputs, and the port's
unsharded side.  Tolerances: fp64 matvecs to 1e-12 max|y|; alpha/beta to
1e-9 relative (the JAX tests' own); Ritz values of converged restarted
solves to 1e-9 relative.  Each rank's slab arithmetic is also checked in
this process at D = 4 and 8 (``local_matvec`` fed the halo planes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.ops import ell_from_scipy as jax_ell  # noqa: E402
from lanczos_tpu.parallel import lanczos_sharded as jax_sharded  # noqa: E402
from lanczos_tpu.parallel import make_row_mesh as jax_mesh  # noqa: E402
from lanczos_tpu.parallel import shard_ell_halo as jax_halo  # noqa: E402
from lanczos_tpu.parallel import shard_operator as jax_shard  # noqa: E402
from lanczos_tpu.solver.restart import eigsh_restarted as jax_restarted  # noqa: E402
from lanczos_tpu.utils.metrics import exchange_stats as jax_exchange  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.parallel import RowMesh, shard_operator  # noqa: E402
from lanczos_tpu_torch.parallel.distributed import ShardedStencilOperator  # noqa: E402
from lanczos_tpu_torch.parallel.launch import run_ranks  # noqa: E402

import test_torch_rank_work  # noqa: E402
from conftest import random_sparse_symmetric  # noqa: E402

D = 4
WORLD_TIMEOUT = 240.0


def _jax_h(n, dtype=np.float64):
    return lt.build_regular_hamiltonian(n, 25.0, lt.deuteron_potential_3d, stencil="27",
                                        dtype=dtype)


def _port_h(n, dtype=torch.float64):
    return pt.build_regular_hamiltonian(n, 25.0, pt.deuteron_potential_3d, stencil="27",
                                        dtype=dtype, device="cpu")


def _cat(ranks, key):
    """A rank-sharded result put back together in rank order."""
    return np.concatenate([r[key] for r in ranks])


def _ell(case, package):
    a = scipy.sparse.csr_matrix(case["ell"])
    if package == "jax":
        return jax_ell(a, dtype=np.float64)
    return pt.ell_from_scipy(a, dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(1234)
    a = random_sparse_symmetric(rng, 400)
    return {
        "x16": rng.standard_normal(16**3), "v0_16": rng.standard_normal(16**3), "n16": 40,
        "ell": a.toarray(), "x_ell": rng.standard_normal(400),
        "v0_ell": rng.standard_normal(400), "n_ell": 50,
        "x32": rng.standard_normal(32**3), "v0_32": rng.standard_normal(32**3), "n32": 30,
        "tmp": str(tmp_path_factory.mktemp("ck")),
    }


@pytest.fixture(scope="module")
def ranks(case):
    return run_ranks(test_torch_rank_work.distributed, D, case, device="cpu",
                     timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def mesh4():
    return jax_mesh(D)


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.max(np.abs(b)))


def test_sharded_matvecs_match_unsharded(case, ranks):
    """Each sharded matvec, put together, is the unsharded one (1e-12 max|y|)."""
    H16, H32 = _port_h(16), _port_h(32)
    ell = _ell(case, "port")
    for key, op, x in (("stencil_y", H16, "x16"), ("ell_y", ell, "x_ell"),
                       ("halo_y", H32.to_ell(), "x32")):
        ref = op.matvec(torch.as_tensor(case[x])).numpy()
        np.testing.assert_allclose(_cat(ranks, key), ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("name,n,x,v0", [("stencil", 16, "x16", "v0_16"),
                                         ("halo", 32, "x32", "v0_32")])
def test_sharded_lanczos_matches_jax(case, ranks, mesh4, name, n, x, v0):
    """lanczos_sharded of the stencil and halo ELL == JAX's lanczos_sharded
    on a 4-device mesh (and the port's unsharded Lanczos)."""
    steps = case[{"stencil": "n16", "halo": "n32"}[name]]
    H = _jax_h(n)
    op = jax_shard(H, mesh4) if name == "stencil" else jax_halo(H.to_ell(), mesh4)
    ref = jax_sharded(op, steps, mesh4, v0=jnp.asarray(case[v0]), dtype="float64")
    alpha = np.stack([r[name]["alpha"] for r in ranks])
    assert (alpha == alpha[0]).all(), "ranks disagree on alpha"
    _close(ranks[0][name]["alpha"], ref.alpha, 1e-9)
    _close(ranks[0][name]["beta"], ref.beta, 1e-9)
    V = np.concatenate([r[name]["V"] for r in ranks], axis=1)
    np.testing.assert_allclose(V, np.asarray(ref.V), rtol=1e-8, atol=1e-9)
    one = pt.lanczos(_port_h(n) if name == "stencil" else _port_h(n).to_ell(), steps,
                     v0=case[v0])
    _close(ranks[0][name]["alpha"], one.alpha.numpy(), 1e-9)


def test_sharded_ell_lanczos_matches_jax(case, ranks, mesh4):
    """The all-gather ELL's Lanczos == JAX's sharded ELL (random sparse, M=400)."""
    ell = _ell(case, "jax")
    ref = jax_sharded(jax_shard(ell, mesh4), case["n_ell"], mesh4,
                      v0=jnp.asarray(case["v0_ell"]), dtype="float64")
    _close(ranks[0]["ell"]["alpha"], ref.alpha, 1e-9)
    _close(ranks[0]["ell"]["beta"], ref.beta, 1e-9)


def test_seeded_start_does_not_depend_on_d(ranks):
    """The default start vector is drawn whole on every rank, each keeping
    its rows: the 4-rank factorization is the unsharded one from the seed."""
    one = pt.lanczos(_port_h(16), 8, seed=3)
    _close(ranks[0]["stencil_seeded"]["alpha"], one.alpha.numpy(), 1e-12)


def test_shard_ell_halo_tables_equal_jax(ranks, mesh4):
    """export_ids and the remapped columns, number for number."""
    ref = jax_halo(_jax_h(32).to_ell(), mesh4)
    np.testing.assert_array_equal(ranks[0]["halo_export_ids"], np.asarray(ref.export_ids))
    np.testing.assert_array_equal(_cat(ranks, "halo_cols"), np.asarray(ref.cols))


def test_exchange_stats_equal_jax(case, ranks, mesh4):
    H16, ell = _jax_h(16), _ell(case, "jax")
    for key, op in (("stencil", jax_shard(H16, mesh4)), ("ell", jax_shard(ell, mesh4)),
                    ("halo", jax_halo(_jax_h(32).to_ell(), mesh4))):
        assert ranks[0]["exchange"][key] == jax_exchange(op, D), key


def test_sharded_restarted_matches_unsharded(case, ranks):
    """eigsh_restarted on the 4-rank stencil == JAX's and the port's
    unsharded solves (converged fp64, 1e-9 relative)."""
    res = ranks[0]["restarted"]
    ref = jax_restarted(_jax_h(16), k=3, tol=1e-9, max_cycles=60, dtype="float64",
                        v0=jnp.asarray(case["v0_16"]))
    _close(res["full"], np.asarray(ref.eigenvalues), 1e-9)
    one = pt.eigsh_restarted(_port_h(16), k=3, tol=1e-9, max_cycles=60, v0=case["v0_16"])
    _close(res["full"], one.eigenvalues.numpy(), 1e-9)
    assert res["full_resid"].max() < 1e-8
    X = np.concatenate([r["restarted"]["vecs"] for r in ranks])
    overlap = np.abs(np.sum(X * one.eigenvectors.numpy(), axis=0))
    np.testing.assert_allclose(overlap, 1.0, atol=1e-8)


def test_sharded_checkpoint_resume_reads_only_own_rows(ranks):
    """A run stopped after 2 cycles resumes, rank by rank, from files that
    hold only that rank's rows, and ends where the uninterrupted run does."""
    for r, out in enumerate(ranks):
        res = out["restarted"]
        assert res["read"] == [res["mine"]] and res["mine"] == f"ck.rank{r}of{D}.npz"
        assert res["file_rows"][1] == 16**3 // D and res["file_u"] == (16**3 // D,)
        assert res["file_cycle"] == 2 and res["resumed_cycles"] > 2
        _close(res["resumed"], res["full"], 1e-9)


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_local_matvec_with_halo_planes(d, dtype):
    """Every rank's slab arithmetic (the kernel's plain version on the slab
    plus the two-plane correction), fed its halo planes cut from the global
    x, gives the global matvec's rows: fp64 to 1e-12 max|y|, fp32 to
    2e-5 max|y| (float32 rounding of the 27-tap sums)."""
    H = _port_h(16, dtype)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(H.shape[0]), dtype=dtype)
    y_ref = H.matvec(x).double().numpy()
    plane, rows = 16 * 16, H.shape[0] // d
    tol = (1e-12 if dtype == torch.float64 else 2e-5) * np.abs(y_ref).max()
    for r in range(d):
        op = ShardedStencilOperator(H, RowMesh(None, r, d, torch.device("cpu")))
        assert op.kernel and op.slab.grid_shape == (16 // d, 16, 16)
        xr = x[r * rows:(r + 1) * rows]
        prev = x[(r * rows - plane) % H.shape[0]:][:plane]
        nxt = x[((r + 1) * rows) % H.shape[0]:][:plane]
        y = op.local_matvec(xr, prev, nxt).double().numpy()
        np.testing.assert_allclose(y, y_ref[r * rows:(r + 1) * rows], rtol=0, atol=tol)


def test_roll_path_slab_matches_jax():
    """A stencil outside the kernel's domain (a 2D grid) takes the roll
    path on a halo-padded slab: equal to JAX's sharded roll path (1e-12)."""
    from jax.sharding import PartitionSpec as P
    from lanczos_tpu.parallel.distributed import _stencil_local_matvec

    def well(x, y):
        return 0.5 * (x * x + y * y)

    hj = lt.build_regular_hamiltonian(16, 25.0, well, ndim=2, dtype=np.float64)
    ht = pt.build_regular_hamiltonian(16, 25.0, well, ndim=2, dtype=torch.float64,
                                      device="cpu")
    m = ht.shape[0]
    x = np.random.default_rng(2).standard_normal(m)
    mv = _stencil_local_matvec(hj, D, "rows", use_pallas=False)
    y_jax = np.asarray(jax.jit(jax.shard_map(
        mv, mesh=jax_mesh(D), in_specs=(P(), P("rows"), P("rows")), out_specs=P("rows"),
        check_vma=False))(hj.weights, hj.diag.reshape(-1), jnp.asarray(x)))
    xt = torch.as_tensor(x)
    rows = m // D
    for rk in range(D):
        op = ShardedStencilOperator(ht, RowMesh(None, rk, D, torch.device("cpu")))
        assert not op.kernel
        n = op.halo * op.plane
        y = op.local_matvec(xt[rk * rows:(rk + 1) * rows], xt.roll(n - rk * rows)[:n],
                            xt.roll(-(rk + 1) * rows)[:n])
        np.testing.assert_allclose(y.numpy(), y_jax[rk * rows:(rk + 1) * rows],
                                   rtol=0, atol=1e-12 * np.abs(y_jax).max())


def test_shard_operator_rejects_indivisible():
    op = pt.ell_from_coo([0, 1, 2], [0, 1, 2], [1.0, 2.0, 3.0], 3, dtype=torch.float64,
                         device="cpu")
    with pytest.raises(ValueError, match="divide"):
        shard_operator(op, RowMesh(None, 0, 4, torch.device("cpu")))
    with pytest.raises(TypeError, match="cannot shard"):
        shard_operator(pt.DenseOperator(torch.eye(4)), RowMesh(None, 0, 4, torch.device("cpu")))
