"""The port's sharded CompositeV2 (``parallel/composite2.py``) against the
JAX package's, at D = 4 ranks.

The operators are ``tests/test_distributed.py``'s: the symmetric graph
Laplacian + 1 of the mixed lattice at n=24 (thin surface runs forced with
``degenerate_frac=10``, as its fused-interface case) and n=48 (its
``composite_v2_pair``).  One gloo world of 4 spawned ranks
(``tests/test_torch_rank_work.py:composite_v2``, no JAX) runs the matvecs and
the restarted solve; this process builds the same operators in both
packages.  Host plans (the surface runs, the device-major index map, the
exchange counts) must equal JAX's exactly; fp64 matvecs agree to 1e-12
max|y|, converged Ritz values to 1e-9 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lanczos_tpu.models.lattice import build_lattice, find_neighbors  # noqa: E402
from lanczos_tpu.ops.composite2 import build_composite_v2  # noqa: E402
from lanczos_tpu.parallel import make_row_mesh as jax_mesh  # noqa: E402
from lanczos_tpu.parallel.composite2 import _plan_support as jax_plan  # noqa: E402
from lanczos_tpu.parallel.composite2 import shard_composite_v2 as jax_shard_v2  # noqa: E402
from lanczos_tpu.solver.restart import eigsh_restarted as jax_restarted  # noqa: E402
from lanczos_tpu.utils.metrics import exchange_stats as jax_exchange  # noqa: E402

from lanczos_tpu_torch.parallel.composite2 import _plan_support, plan_composite_v2  # noqa: E402
from lanczos_tpu_torch.parallel.dryrun import graph_laplacian_v2  # noqa: E402
from lanczos_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from lanczos_tpu_torch.solver.restart import eigsh_restarted  # noqa: E402
from lanczos_tpu_torch.utils.metrics import exchange_stats  # noqa: E402

import test_torch_rank_work  # noqa: E402

D = 4
FRAC = {24: 10.0, 48: 0.6}


def _jax_comp(n):
    """tests/test_distributed.py's composite_v2_pair builder at n_fine=n."""
    bd = 3
    sp = np.full(bd**3, 2, dtype=np.int64)
    sp[bd**3 // 2] = 1
    lat = build_lattice(n, 25.0, bd, spacings=sp)
    nbrs, rels = find_neighbors(lat, 1)
    p, k = nbrs.shape
    rows = np.repeat(np.arange(p, dtype=np.int64), k)
    cols = nbrs.reshape(-1)
    valid = cols >= 0
    fwd = rows[valid] * p + cols[valid]
    bwd = np.sort(cols[valid] * p + rows[valid])
    pos = np.minimum(np.searchsorted(bwd, fwd), len(bwd) - 1)
    keep = np.zeros(len(rows), dtype=bool)
    keep[valid] = bwd[pos] == fwd
    keep = keep.reshape(p, k)
    comp, _ = build_composite_v2(
        lat, np.where(keep, nbrs, -1), rels, np.where(keep, -1.0, 0.0),
        keep.sum(axis=1).astype(np.float64) + 1.0, scale=1.0, dtype=np.float64,
        interior_weights=lambda a: np.full(26, -1.0), symmetric=True, min_grid_rows=4,
    )
    return comp


@pytest.fixture(scope="module")
def pairs():
    """{n: (JAX CompositeV2, port CompositeV2)}."""
    return {n: (_jax_comp(n), graph_laplacian_v2(n, dtype=torch.float64, device="cpu")[0]) for n in FRAC}


@pytest.fixture(scope="module")
def case(pairs):
    rng = np.random.default_rng(7)
    out = {}
    for n, (cj, _) in pairs.items():
        out[f"x{n}"] = rng.standard_normal(cj.shape[0]) * np.asarray(cj.live)
    v0 = np.random.default_rng(5).standard_normal(pairs[24][0].shape[0])
    v0 *= np.asarray(pairs[24][0].live)
    out["v0_24"] = v0 / np.linalg.norm(v0)
    return out


@pytest.fixture(scope="module")
def ranks(case):
    return run_ranks(test_torch_rank_work.composite_v2, D, case, device="cpu", timeout=240.0)


@pytest.mark.parametrize("n", sorted(FRAC))
@pytest.mark.parametrize("frac", [0.6, 10.0])
def test_plan_support_equals_jax(pairs, n, frac):
    """The surface runs and their stats, number for number."""
    cj, ct = pairs[n]
    assert _plan_support(ct, frac) == jax_plan(cj, frac)


@pytest.mark.parametrize("n", sorted(FRAC))
def test_host_plan_and_exchange_equal_jax(pairs, n):
    """The device-major index map, the live mask and exchange_elements /
    exchange_stats of the host plan equal the JAX sharded operator's."""
    cj, ct = pairs[n]
    sj = jax_shard_v2(cj, jax_mesh(D), degenerate_frac=FRAC[n])
    host = plan_composite_v2(ct, D, FRAC[n])
    np.testing.assert_array_equal(host.idx_map, sj.host.idx_map)
    np.testing.assert_array_equal(host.live_mask(), sj.host.live_mask())
    assert host.exchange_elements() == sj.exchange_elements()
    assert exchange_stats(host, D) == jax_exchange(sj, D)
    assert host.level_meta == tuple(tuple(lm) for lm in sj.level_meta)


@pytest.mark.parametrize("n", sorted(FRAC))
def test_sharded_matvec_matches(pairs, case, ranks, n):
    """The 4-rank matvec == the JAX operator's and the port's unsharded
    matvec (1e-12 max|y|); dead and ghost slots stay exactly zero."""
    cj, ct = pairs[n]
    host = plan_composite_v2(ct, D, FRAC[n])
    y = np.concatenate([r[n]["y"] for r in ranks])
    ref = np.asarray(jax.jit(cj.matvec)(jnp.asarray(case[f"x{n}"])))
    tol = 1e-12 * np.abs(ref).max()
    np.testing.assert_allclose(host.from_sharded(y), ref, rtol=0, atol=tol)
    one = ct.matvec(torch.as_tensor(case[f"x{n}"])).numpy()
    np.testing.assert_allclose(host.from_sharded(y), one, rtol=0, atol=tol)
    np.testing.assert_array_equal(y * (1 - host.live_mask()), 0.0)
    np.testing.assert_array_equal(np.concatenate([r[n]["live"] for r in ranks]),
                                  host.live_mask())
    assert ranks[0][n]["exchange"] == exchange_stats(host, D)


def test_thin_runs_are_in_play(pairs, ranks):
    """degenerate_frac=10 keeps every n=24 level on the thin-run path (the
    z-run all-reduce and the x/y-run all-gather), as the JAX test forces."""
    host = plan_composite_v2(pairs[24][1], D, FRAC[24])
    assert ranks[0][24]["runs"] == host.support_runs
    for runs, (a, ext, st, sl, nzl) in zip(host.support_runs, host.level_meta):
        assert runs != ((0, 0, ext[0]),), "degenerated to a whole-level gather"
    assert {ax for lv in host.support_runs for ax, _, _ in lv} >= {0, 2}


def test_sharded_restarted_solve_matches(pairs, case, ranks):
    """eigsh_restarted on the 4-rank CompositeV2 == JAX's and the port's
    unsharded solves (k=4, tol=1e-9, fp64: 1e-9 relative)."""
    cj, ct = pairs[24]
    host = plan_composite_v2(ct, D, FRAC[24])
    res = ranks[0]["restarted"]
    for r in ranks:
        np.testing.assert_array_equal(r["restarted"]["vals"], res["vals"])
    ref = jax_restarted(cj, k=4, tol=1e-9, max_cycles=80, dtype="float64",
                        v0=jnp.asarray(case["v0_24"]))
    np.testing.assert_allclose(res["vals"], np.asarray(ref.eigenvalues), rtol=1e-9, atol=1e-9)
    one = eigsh_restarted(ct, k=4, tol=1e-9, max_cycles=80, v0=case["v0_24"])
    np.testing.assert_allclose(res["vals"], one.eigenvalues.numpy(), rtol=1e-9, atol=1e-9)
    assert res["resid"].max() < 1e-8
    X = host.from_sharded(np.concatenate([r["restarted"]["vecs"] for r in ranks]))
    np.testing.assert_allclose(np.linalg.norm(X, axis=0), 1.0, atol=1e-10)
