"""The restart cycles behind ``solver/graphs.py`` against lanczos_tpu.

On a card ``eigs_nonsym`` and ``eigsh_restarted`` run each cycle after the
first as a CUDA graph replay over buffers of fixed address.  Here, on the
CPU, the same in-place buffers run the eager body: the solves are held to
the JAX package's over several cycles (l = 0, then the locked count, every
later cycle reusing the buffers), the in-place Schur rotation to the old
allocating one, and the graph cache's control flow (first cycle eager,
one capture per key, a replay for every later cycle, a new capture after a
change of the operator's tensors, launches counted per replay) to the
eager solve, bitwise, through a stand-in for ``torch.cuda.CUDAGraph``.
fp64 throughout.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.solver.restart import eigsh_restarted as jax_restarted  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.ops import interface_kernel as ik  # noqa: E402
from lanczos_tpu_torch.ops import stencil_kernels as sk  # noqa: E402
from lanczos_tpu_torch.ops.operators import StencilOperator  # noqa: E402
from lanczos_tpu_torch.solver import graphs  # noqa: E402
from lanczos_tpu_torch.solver.arnoldi import _rotate_basis  # noqa: E402

from torch_graph_stub import StubGraph, install, replay_counts  # noqa: E402


def _mixed(pkg):
    sp = np.full(27, 2, dtype=np.int64)
    sp[13] = 1
    return pkg.build_lattice(24, 25.0, 3, spacings=sp)


#: Small bases, so that each solve runs many cycles.
NONSYM_KW = dict(k=4, max_basis=30, tol=1e-10)
RESTART_KW = dict(k=4, max_basis=20, tol=1e-9)


@pytest.fixture(scope="module")
def nonsym():
    """(JAX ELL, port CompositeV2, the live-masked v2 start, the ELL start)."""
    J = lt.assemble_irregular_hamiltonian(_mixed(lt), lt.deuteron_potential_3d, dtype=np.float64)
    C, idx_map = pt.assemble_irregular_hamiltonian_composite2(
        _mixed(pt), pt.deuteron_potential_3d, dtype=torch.float64, min_grid_rows=4, device="cpu")
    v0 = np.random.default_rng(5).uniform(-1, 1, J.shape[0])
    v2 = np.zeros(C.shape[0])
    v2[idx_map] = v0
    return J, C, v2, v0


@pytest.fixture(scope="module")
def stencil():
    hj = lt.build_regular_hamiltonian(16, 25.0, lt.deuteron_potential_3d, stencil="27",
                                      dtype=np.float64)
    ht = pt.build_regular_hamiltonian(16, 25.0, pt.deuteron_potential_3d, stencil="27",
                                      dtype=torch.float64, device="cpu")
    return hj, ht, np.random.default_rng(11).uniform(-1, 1, ht.shape[0])


def _cycles_seen():
    ls = [static[1] for static in graphs.stats["cycles"]]
    return len(ls), sorted(set(ls))


def test_eigs_nonsym_in_place_cycles_match_jax(nonsym):
    J, C, v2, v0 = nonsym
    want = np.asarray(lt.eigs_nonsym(J, v0=v0, dtype=np.float64, **NONSYM_KW).eigenvalues)
    graphs.reset_stats()
    res = pt.eigs_nonsym(C, v0=v2, **NONSYM_KW)
    n_cycles, ls = _cycles_seen()
    assert n_cycles >= 3 and ls[0] == 0 and len(ls) >= 2
    np.testing.assert_allclose(res.eigenvalues.numpy(), want, rtol=0, atol=1e-8)
    assert (res.residuals.numpy() < 1e-10).all()


def test_eigsh_restarted_in_place_cycles_match_jax(stencil):
    hj, ht, v0 = stencil
    want = np.asarray(jax_restarted(hj, v0=jnp.asarray(v0), dtype=np.float64,
                                    **RESTART_KW).eigenvalues)
    graphs.reset_stats()
    res = pt.eigsh_restarted(ht, v0=v0, **RESTART_KW)
    n_cycles, ls = _cycles_seen()
    assert n_cycles >= 3 and ls[0] == 0 and len(ls) >= 2
    np.testing.assert_allclose(res.eigenvalues.numpy(), want, rtol=1e-10, atol=0)


def _rotate_basis_allocating(V, Z, l):
    """The rotation as it was before the basis became a static buffer."""
    m = V.shape[0] - 1
    out = torch.zeros_like(V)
    out[:l] = Z.T @ V[:m]
    out[l] = V[m]
    return out


@pytest.mark.parametrize("l", [1, 5, 12])
def test_in_place_rotation_equals_the_allocating_one(l):
    rng = np.random.default_rng(l)
    m, n = 12, 257
    V = torch.from_numpy(rng.standard_normal((m + 1, n)))
    Z = torch.from_numpy(rng.standard_normal((m, l)))
    want = _rotate_basis_allocating(V, Z, l)
    V_in = V.clone()
    assert _rotate_basis(V_in, Z, l) is V_in
    assert torch.equal(V_in, want)


def test_cycle_key_follows_static_arguments_and_tensor_versions(nonsym):
    _, C, _, _ = nonsym
    base = (3, 30, 2, False, torch.float64)
    key = graphs.cycle_key(C, base)
    assert graphs.cycle_key(C, base) == key
    C.matvec(torch.ones(C.shape[0], dtype=torch.float64))
    assert graphs.cycle_key(C, base) == key
    for other in ((4, 30, 2, False, torch.float64), (3, 31, 2, False, torch.float64),
                  (3, 30, 2, True, torch.float64), (3, 30, 2, False, torch.float32)):
        assert graphs.cycle_key(C, other) != key
    tensors = [C.diag]
    for level in C.level_ops:
        assert isinstance(level, StencilOperator)
        tensors += [t for t in (level.weights, level.diag) if t is not None]
    assert len(tensors) >= 3
    for t in tensors:
        t.add_(0.0)  # same values, a new version
        new = graphs.cycle_key(C, base)
        assert new != key
        key = new


def test_no_cuda_graph_is_built_on_the_cpu(monkeypatch, nonsym, stencil):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph or stream was made for CPU tensors")

    for name in ("CUDAGraph", "graph", "Stream", "stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    _, C, v2, _ = nonsym
    pt.eigs_nonsym(C, v0=v2, k=2, max_basis=16, tol=1e-6, max_cycles=3)
    _, ht, v0 = stencil
    pt.eigsh_restarted(ht, v0=v0, k=2, max_basis=12, tol=1e-6, max_cycles=3)


@pytest.fixture
def stub_cuda(monkeypatch):
    """Runs CycleGraphs' card path on CPU tensors (``torch_graph_stub``)."""
    return install(monkeypatch.setattr)


def test_captured_eigs_nonsym_equals_eager_bitwise(stub_cuda, nonsym):
    _, C, v2, _ = nonsym
    kw = dict(k=4, max_basis=24, tol=1e-10)
    captured = pt.eigs_nonsym(C, v0=v2, **kw)
    seen = dict(graphs.stats)
    graphs.reset_stats()
    with graphs.eager():
        plain = pt.eigs_nonsym(C, v0=v2, **kw)
    assert graphs.stats["captures"] == graphs.stats["replays"] == graphs.stats["eager"] == 0
    assert seen["cycles"] == graphs.stats["cycles"] and len(seen["cycles"]) >= 3
    assert (seen["eager"], seen["captures"], seen["replays"]) == replay_counts(graphs.stats)
    assert seen["captures"] == len(stub_cuda)
    assert sum(g.graph.replays for g in stub_cuda) == seen["replays"]
    for name in ("eigenvalues", "eigenvectors", "residuals", "inner_prod"):
        assert torch.equal(getattr(captured, name), getattr(plain, name)), name


def test_captured_eigsh_restarted_equals_eager_bitwise(stub_cuda, stencil):
    _, ht, v0 = stencil
    captured = pt.eigsh_restarted(ht, v0=v0, **RESTART_KW)
    seen = dict(graphs.stats)
    graphs.reset_stats()
    with graphs.eager():
        plain = pt.eigsh_restarted(ht, v0=v0, **RESTART_KW)
    assert seen["cycles"] == graphs.stats["cycles"] and len(seen["cycles"]) >= 3
    assert (seen["eager"], seen["captures"], seen["replays"]) == replay_counts(graphs.stats)
    assert seen["captures"] == 1
    for name in ("eigenvalues", "eigenvectors", "residuals", "inner_prod"):
        assert torch.equal(getattr(captured, name), getattr(plain, name)), name


def test_a_weight_change_forces_an_eager_cycle_and_a_new_capture(stub_cuda):
    op = pt.build_regular_hamiltonian(8, 25.0, pt.deuteron_potential_3d, stencil="27",
                                      dtype=torch.float64, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, op.shape[0]))
    out = torch.empty_like(x)

    def body(x, out):
        out.copy_(op.matvec(x))
        return out

    cg = graphs.CycleGraphs(op)
    for _ in range(3):
        assert torch.equal(cg.run(("s",), body, x, out), op.matvec(x))
    assert (graphs.stats["eager"], graphs.stats["captures"], graphs.stats["replays"]) == (1, 1, 2)
    op.weights.mul_(2.0)
    for _ in range(3):
        assert torch.equal(cg.run(("s",), body, x, out), op.matvec(x))
    assert (graphs.stats["eager"], graphs.stats["captures"], graphs.stats["replays"]) == (2, 2, 4)
    with pytest.raises(RuntimeError, match="other addresses"):
        cg.run(("s",), body, x.clone(), out)


def test_replays_count_launches_per_graph(monkeypatch):
    """A capture's launches are taken back from the wrappers' counts; each
    replay adds them once (a stub graph: no card here)."""
    stub = StubGraph()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: stub)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    wrappers = (sk.stencil_spmv, sk.stencil_spmm, ik.apply_fused_interface)
    per_graph = {sk.stencil_spmv: (3, 1), sk.stencil_spmm: (0, 2), ik.apply_fused_interface: (1, 0)}
    x = torch.zeros(4)

    def body(x):
        for w, (n32, n64) in per_graph.items():
            w.launches += n32 + n64
            w.launches_by_dtype[torch.float32] += n32
            w.launches_by_dtype[torch.float64] += n64
        return x

    before = [(w.launches, dict(w.launches_by_dtype)) for w in wrappers]
    g = graphs._capture(body, (x,), None)
    assert [(w.launches, dict(w.launches_by_dtype)) for w in wrappers] == before
    replays = 4
    for _ in range(replays):
        assert g.replay((x,)) is x
    assert stub.replays == replays
    for w, (n, by) in zip(wrappers, before):
        n32, n64 = per_graph[w]
        assert w.launches == n + replays * (n32 + n64)
        assert w.launches_by_dtype[torch.float32] == by[torch.float32] + replays * n32
        assert w.launches_by_dtype[torch.float64] == by[torch.float64] + replays * n64
