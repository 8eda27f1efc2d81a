"""Row-sharded restart cycles behind ``solver/graphs.py``.

On a card a row-sharded operator over an NCCL group runs every
thick-restart and Krylov–Schur cycle after the first as a CUDA graph
replay, its all-reduces, all-gathers and halo all-to-all captured with the
cycle; over gloo (the CPU) the cycles stay eager.  Here one gloo world of
2 spawned ranks (``tests/test_torch_rank_work.py:sharded_graphs``, no JAX)
runs the sharded solves through the card path with stub graphs
(``torch_graph_stub``) and again under ``graphs.eager()``.  Held: the two
bitwise equal on every rank, with one eager cycle, one capture per static
key and a replay every later cycle; each within today's tolerance of the
unsharded solve (and of the JAX package's, for the stencil: 1e-9 relative,
as in tests/test_torch_distributed.py); ``capturable`` takes an NCCL mesh
and refuses a gloo one; every tensor a sharded operator's matvec reads is
a buffer, so the graph cache's key follows it.  fp64.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.solver.restart import eigsh_restarted as jax_restarted  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.ops.composite import shard_composite  # noqa: E402
from lanczos_tpu_torch.parallel import RowMesh  # noqa: E402
from lanczos_tpu_torch.parallel.composite2 import shard_composite_v2  # noqa: E402
from lanczos_tpu_torch.parallel.distributed import ShardedStencilOperator  # noqa: E402
from lanczos_tpu_torch.parallel.dryrun import graph_laplacian_v2  # noqa: E402
from lanczos_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from lanczos_tpu_torch.solver import graphs  # noqa: E402

import test_torch_rank_work  # noqa: E402
from torch_graph_stub import replay_counts  # noqa: E402

D = 2
SOLVES = ("restarted", "restarted_compensated", "nonsym_v2", "nonsym_v1")


def _regular(n=16):
    return pt.build_regular_hamiltonian(n, 25.0, pt.deuteron_potential_3d, stencil="27",
                                        dtype=torch.float64, device="cpu")


def _v1_lattice():
    return pt.build_lattice(12, 25.0, 3, overwrite_spacing=True)


@pytest.fixture(scope="module")
def case():
    comp = graph_laplacian_v2(24, dtype=torch.float64, device="cpu")[0]
    v0 = np.random.default_rng(5).standard_normal(comp.shape[0]) * comp.live.numpy()
    return {
        # Small bases, so that every solve runs several cycles.
        "restarted": dict(k=3, max_basis=16, tol=1e-9, max_cycles=80,
                          v0=np.random.default_rng(3).uniform(-1, 1, 16**3)),
        "nonsym_v2": dict(k=4, max_basis=20, tol=1e-9, max_cycles=80),
        "v0_24": v0 / np.linalg.norm(v0),
        "nonsym_v1": dict(k=3, max_basis=16, tol=1e-9, max_cycles=80, which="SR"),
    }


@pytest.fixture(scope="module")
def ranks(case):
    return run_ranks(test_torch_rank_work.sharded_graphs, D, case, device="cpu", timeout=240.0)


def _unsharded(name, case):
    """The port's unsharded solve of the same problem (eigenvalues)."""
    if name.startswith("restarted"):
        kw = dict(case["restarted"], compensated=name.endswith("compensated"))
        return pt.eigsh_restarted(_regular(), **kw).eigenvalues.numpy()
    if name == "nonsym_v2":
        comp = graph_laplacian_v2(24, dtype=torch.float64, device="cpu")[0]
        return pt.eigs_nonsym(comp, v0=case["v0_24"], **case["nonsym_v2"]).eigenvalues.numpy()
    comp, _ = pt.assemble_irregular_hamiltonian_composite(
        _v1_lattice(), pt.deuteron_potential_3d, dtype=torch.float64, device="cpu")
    return pt.eigs_nonsym(comp, **case["nonsym_v1"]).eigenvalues.numpy()


@pytest.mark.parametrize("name", SOLVES)
def test_sharded_captured_cycles_equal_eager_bitwise(ranks, name):
    """On every rank the solve through the stub graphs equals its eager
    solve bit for bit (eigenvalues, the rank's rows of the vectors,
    residuals, acceptance), with one eager cycle, one capture per static
    key and a replay every later cycle; the ranks agree on the values."""
    for out in ranks:
        cap, eag = out[name]["captured"], out[name]["eager"]
        for key in ("vals", "vecs", "resid", "inner"):
            np.testing.assert_array_equal(cap[key], eag[key], err_msg=key)
        seen, plain = cap["stats"], eag["stats"]
        assert plain["captures"] == plain["replays"] == plain["eager"] == 0
        assert seen["cycles"] == plain["cycles"] and len(seen["cycles"]) >= 3
        assert (seen["eager"], seen["captures"], seen["replays"]) == replay_counts(plain)
        np.testing.assert_array_equal(cap["vals"], ranks[0][name]["captured"]["vals"])


@pytest.mark.parametrize("name", SOLVES)
def test_sharded_captured_solve_matches_unsharded(case, ranks, name):
    """The captured 2-rank solve against the port's unsharded one, 1e-9
    relative (converged fp64); the stencil solves also against the JAX
    package's eigsh_restarted."""
    got = ranks[0][name]["captured"]["vals"]
    want = _unsharded(name, case)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    assert ranks[0][name]["captured"]["resid"].max() < 1e-8
    if name.startswith("restarted"):
        kw = dict(case["restarted"], v0=jnp.asarray(case["restarted"]["v0"]),
                  compensated=name.endswith("compensated"))
        ref = jax_restarted(lt.build_regular_hamiltonian(16, 25.0, lt.deuteron_potential_3d,
                                                         stencil="27", dtype=np.float64),
                            dtype="float64", **kw)
        np.testing.assert_allclose(got, np.asarray(ref.eigenvalues), rtol=1e-9, atol=0)


def test_capturable_takes_nccl_meshes_only(ranks, monkeypatch):
    """An operator on a card is captured unsharded or over an NCCL group;
    over gloo (the ranks' real group, and a stubbed one) it is not, and a
    CPU operator never is."""
    for out in ranks:
        assert out["backend"] == "gloo" and out["capturable"] is False
    nccl, gloo = object(), object()
    monkeypatch.setattr(dist, "get_backend", {nccl: "nccl", gloo: "gloo"}.__getitem__)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def op(device, group=None):
        mesh = None if group is None else RowMesh(group, 0, 2, device)
        return types.SimpleNamespace(device=device, mesh=mesh)

    assert graphs.capturable(op(cuda, nccl)) and graphs.capturable(op(cuda))
    assert not graphs.capturable(op(cuda, gloo))
    assert not graphs.capturable(op(cpu, nccl)) and not graphs.capturable(op(cpu))


def _sharded_operators():
    """Rank 0's sharded stencil, CompositeV2 and v1 composite at D = 2,
    built in this process (building needs no collective)."""
    mesh = RowMesh(None, 0, D, torch.device("cpu"))
    v1 = pt.assemble_irregular_hamiltonian_composite(
        _v1_lattice(), pt.deuteron_potential_3d, dtype=torch.float64, device="cpu")[0]
    return {
        "stencil": ShardedStencilOperator(_regular(), mesh),
        "composite_v2": shard_composite_v2(
            graph_laplacian_v2(24, dtype=torch.float64, device="cpu")[0], mesh,
            degenerate_frac=10.0),
        "composite_v1": shard_composite(v1, D).as_operator(mesh),
    }


@pytest.mark.parametrize("name", ["stencil", "composite_v2", "composite_v1"])
def test_sharded_operator_tables_are_buffers(name):
    """Every tensor of a sharded operator and of its submodules is a
    registered buffer (no plain tensor attribute that could change behind
    the graph cache's back), and a new version of any of them changes the
    cache key."""
    op = _sharded_operators()[name]
    for mod in op.modules():
        for attr, val in vars(mod).items():
            assert not isinstance(val, torch.Tensor), (type(mod).__name__, attr)
    buffers = [t for _, t in op.named_buffers()]
    assert len(buffers) >= 2  # the slab's weights (shared with the correction), diag
    key = graphs.cycle_key(op, ("krylov_schur", 3, 20))
    for t in buffers:
        t.add_(0)  # the same values, a new version
        new = graphs.cycle_key(op, ("krylov_schur", 3, 20))
        assert new != key
        key = new
