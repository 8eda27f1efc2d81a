"""The refinement's units behind ``solver/graphs.py``, against the eager
bodies and against lanczos_tpu/solver/refine.py.

On a card ``refine_eigenpairs_dd_hosted``, ``refine_eigenpairs_dd`` and
``refine_eigenpairs_dd_nonsym`` run each unit (a chunk's residual; its
residual fed into the deflated CG or BiCGStab) through ``CycleGraphs``
with one key per unit and width: the first call of a key eager, the
second captured, every later one a replay, on fixed buffers.  Here, on the
CPU, a stand-in for ``torch.cuda.CUDAGraph`` (``torch_graph_stub``) takes
the same control flow.  Held: each refinement through the stub equals the
same call under ``graphs.eager()`` bitwise, with k not a multiple of
``col_chunk`` (the tail chunk has its own keys); the captures and replays
per key; a changed operator buffer forces an eager call and a new capture;
and the stubbed results against the JAX package's refinements at
tests/test_torch_dd_refine.py's sizes and tolerances.  fp64 refinement of
float32 pairs throughout.
"""

import collections

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.solver import graphs  # noqa: E402
from lanczos_tpu_torch.solver import refine as tref  # noqa: E402

from test_torch_dd_refine import K, _check_symmetric, nonsym_case, symmetric_case  # noqa: E402,F401
from torch_graph_stub import install  # noqa: E402

#: test_torch_dd_refine.py's arguments; 12 pairs in chunks of 5 leave a
#: tail of 2.
HOSTED_KW = dict(tol=1e-9, max_rounds=6, cg_steps=60, col_chunk=5)
DD_KW = dict(tol=1e-9, max_rounds=6, cg_steps=60)
NONSYM_KW = dict(tol=1e-9, max_rounds=8, cg_steps=60)


def _counts(keys):
    """(eager calls, captures, replays) that the card path owes a run
    whose units' static keys were ``keys``: per key the first call eager,
    the second a capture, and every call after the first a replay."""
    n = collections.Counter(keys)
    return len(n), sum(c > 1 for c in n.values()), sum(c - 1 for c in n.values())


def _captured_and_eager(run):
    """``run()`` through the stub and under ``graphs.eager()``: (captured
    result, its graph stats, the stub graphs, eager result, eager stats)."""
    with pytest.MonkeyPatch.context() as mp:
        captured_graphs = install(mp.setattr)
        captured = run()
        seen = dict(graphs.stats)
    graphs.reset_stats()
    with graphs.eager():
        plain = run()
    return captured, seen, captured_graphs, plain, dict(graphs.stats)


def _hold_graph_counts(seen, captured_graphs, plain_stats):
    assert plain_stats["eager"] == plain_stats["captures"] == plain_stats["replays"] == 0
    assert seen["cycles"] == plain_stats["cycles"]
    assert (seen["eager"], seen["captures"], seen["replays"]) == _counts(seen["cycles"])
    assert seen["captures"] == len(captured_graphs)
    assert sum(g.graph.replays for g in captured_graphs) == seen["replays"]


def _same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def hosted_runs(symmetric_case):
    comp, _, lam0, X0, *_ = symmetric_case
    return _captured_and_eager(lambda: tref.refine_eigenpairs_dd_hosted(
        comp, lam0, X0.astype(np.float64), **HOSTED_KW))


def test_hosted_captured_equals_eager_bitwise(hosted_runs):
    captured, seen, captured_graphs, plain, plain_stats = hosted_runs
    _same(captured, plain)
    _hold_graph_counts(seen, captured_graphs, plain_stats)
    keys = collections.Counter(seen["cycles"])
    # A residual sweep a round (the last one may find convergence) and a
    # closing one; the corrections of each round that did not converge.
    sweeps, rounds = keys[("residual", 2)], keys[("cg", 60, 2, torch.float32)]
    assert rounds >= 2 and sweeps in (rounds + 1, rounds + 2)
    assert keys[("residual", 5)] == 2 * sweeps
    assert keys[("cg", 60, 5, torch.float32)] == 2 * rounds
    assert set(keys) == {("residual", 5), ("residual", 2), ("cg", 60, 5, torch.float32),
                         ("cg", 60, 2, torch.float32)}
    # Every chunk after the first of its width replays.
    assert seen["replays"] == len(seen["cycles"]) - 4


def test_hosted_through_the_stub_matches_jax(hosted_runs, symmetric_case):
    """test_torch_dd_refine.py's hosted test on the stubbed path: residuals
    at most 3e-8, eigenvalues within 1e-8 of scipy's and 1e-9 of the JAX
    package's float64 host refinement of the same pairs."""
    lam, X, rel = hosted_runs[0]
    _check_symmetric(lam, X, rel, symmetric_case, symmetric_case[-2])


@pytest.fixture(scope="module")
def dd_runs(symmetric_case):
    comp, _, lam0, X0, *_ = symmetric_case
    return _captured_and_eager(lambda: tref.refine_eigenpairs_dd(comp, lam0, X0, **DD_KW))


def test_dd_captured_equals_eager_bitwise(dd_runs, symmetric_case):
    captured, seen, captured_graphs, plain, plain_stats = dd_runs
    _same(captured, plain)
    _hold_graph_counts(seen, captured_graphs, plain_stats)
    k = symmetric_case[2].shape[0]
    assert set(seen["cycles"]) == {("residual", k), ("cg", 60, k, torch.float32)}
    assert seen["captures"] == 2
    lam, Xh, Xl, rel = captured
    _check_symmetric(lam, Xh.double().numpy() + Xl.double().numpy(), rel, symmetric_case,
                     symmetric_case[-2])


@pytest.fixture(scope="module")
def nonsym_runs(nonsym_case):
    H, lam0, X0, *_ = nonsym_case
    return _captured_and_eager(
        lambda: tref.refine_eigenpairs_dd_nonsym(H, lam0, X0, **NONSYM_KW))


def test_nonsym_captured_equals_eager_bitwise(nonsym_runs):
    captured, seen, captured_graphs, plain, plain_stats = nonsym_runs
    _same(captured, plain)
    _hold_graph_counts(seen, captured_graphs, plain_stats)
    assert {key[0] for key in seen["cycles"]} == {"residual", "bicgstab"}
    assert seen["captures"] == 2 and seen["replays"] >= 2


def test_nonsym_through_the_stub_matches_jax(nonsym_runs, nonsym_case):
    """test_torch_dd_refine.py's tolerances: relative residuals at most
    1e-8, eigenvalues within 1e-9 of the JAX package's
    refine_eigenpairs_dd_nonsym of the same pairs."""
    lam, _, _, rel = nonsym_runs[0]
    jlam = nonsym_case[4]
    assert rel.max() <= 1e-8, rel
    np.testing.assert_allclose(np.sort(lam), np.sort(jlam), atol=1e-9, rtol=0)


def _small_symmetric(n=12, k=7):
    """A float32 regular Hamiltonian and perturbed exact eigenpairs: a
    refinement's start."""
    op = pt.build_regular_hamiltonian(n, 25.0, pt.deuteron_potential_3d, stencil="27",
                                      dtype=torch.float32, device="cpu")
    dense = op.to_scipy().toarray().astype(np.float64)
    w, V = np.linalg.eigh((dense + dense.T) / 2)
    rng = np.random.default_rng(4)
    X0 = (V[:, :k] + 1e-5 * rng.standard_normal((V.shape[0], k))).astype(np.float32)
    return op, w[:k] + 1e-6, X0


def test_a_changed_operator_buffer_forces_an_eager_call_and_a_new_capture(monkeypatch):
    """A buffer of the operator changed between two units (here: the same
    values, a new version) clears the graphs: the next call of each key
    runs eagerly and is captured again, never replayed from the old
    graph; the result still equals the eager run's bitwise."""
    op, lam0, X0 = _small_symmetric()
    kw = dict(tol=0.0, max_rounds=3, cg_steps=8, col_chunk=3)
    calls = []
    correction = tref._Units.correction

    def touching(self, lam, lo, hi):
        calls.append(lo)
        if len(calls) == 4:  # the second round's first chunk
            op.weights.add_(0.0)
        return correction(self, lam, lo, hi)

    monkeypatch.setattr(tref._Units, "correction", touching)
    captured, seen, captured_graphs, plain, _ = _captured_and_eager(
        lambda: tref.refine_eigenpairs_dd_hosted(op, lam0, X0.astype(np.float64), **kw))
    _same(captured, plain)
    keys = seen["cycles"]
    # Without the change: 4 keys (widths 3 and 1, two units), each eager once.
    assert len(set(keys)) == 4
    # Round 0 (a sweep and the corrections) and round 1's sweep came before.
    before, after = keys[:9], keys[9:]
    want = [a + b for a, b in zip(_counts(before), _counts(after))]
    assert [seen["eager"], seen["captures"], seen["replays"]] == want == [8, 7, 13]
    assert len(captured_graphs) == 7


def test_cycle_graphs_key_on_every_operator():
    """CycleGraphs(op, op64) keys its graphs on both operators' buffers."""
    with pytest.MonkeyPatch.context() as mp:
        install(mp.setattr)
        op = pt.build_regular_hamiltonian(8, 25.0, pt.deuteron_potential_3d, stencil="27",
                                          dtype=torch.float32, device="cpu")
        op64 = tref.to_float64(op)
        x = torch.ones(op.shape[0], dtype=torch.float64)
        cg = graphs.CycleGraphs(op, op64, op64)
        assert cg.ops == (op, op64)

        def body(x):
            return op64.matvec(x)

        for _ in range(3):
            cg.run(("s",), body, x)
        assert (graphs.stats["eager"], graphs.stats["captures"], graphs.stats["replays"]) == (
            1, 1, 2)
        op64.weights.mul_(2.0)
        y = cg.run(("s",), body, x)
        assert torch.equal(y, op64.matvec(x))
        cg.run(("s",), body, x)
        assert (graphs.stats["eager"], graphs.stats["captures"], graphs.stats["replays"]) == (
            2, 2, 3)


def test_warm_each_key_runs_each_key_eagerly_first():
    with pytest.MonkeyPatch.context() as mp:
        install(mp.setattr)
        op = pt.build_regular_hamiltonian(8, 25.0, pt.deuteron_potential_3d, stencil="27",
                                          dtype=torch.float64, device="cpu")
        x = torch.ones(op.shape[0], dtype=torch.float64)
        cg = graphs.CycleGraphs(op, warm_each_key=True)
        for key in ("a", "b", "a", "b", "a", "c"):
            cg.run((key,), op.matvec, x)
        assert (graphs.stats["eager"], graphs.stats["captures"], graphs.stats["replays"]) == (
            3, 2, 3)


def test_no_cuda_graph_is_built_on_the_cpu(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph or stream was made for CPU tensors")

    for name in ("CUDAGraph", "graph", "Stream", "stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    op, lam0, X0 = _small_symmetric()
    graphs.reset_stats()
    tref.refine_eigenpairs_dd_hosted(op, lam0, X0.astype(np.float64), tol=0.0, max_rounds=1,
                                     cg_steps=4, col_chunk=3)
    tref.refine_eigenpairs_dd_nonsym(op, lam0, X0, tol=0.0, max_rounds=1, cg_steps=4)
    assert graphs.stats["eager"] == graphs.stats["captures"] == graphs.stats["replays"] == 0
    # hosted: two sweeps and a round's corrections of 3 chunks; nonsym: 3 units.
    assert len(graphs.stats["cycles"]) == 9 + 3


@pytest.mark.parametrize("rows", [1, 5, 64, 1 << 23])
def test_rotation_in_place_keeps_the_address(rows):
    rng = np.random.default_rng(rows)
    X = torch.from_numpy(rng.standard_normal((53, 6)))
    Z = rng.standard_normal((6, 6))
    want = X @ torch.from_numpy(Z)
    ptr = X.data_ptr()
    assert tref._rotate(X, Z, rows=rows) is X and X.data_ptr() == ptr
    torch.testing.assert_close(X, want, rtol=1e-14, atol=1e-14)


def test_normalization_in_place_equals_the_allocating_one():
    X = torch.from_numpy(np.random.default_rng(1).standard_normal((40, 5)))
    want = X / torch.linalg.vector_norm(X, dim=0)[None, :]
    ptr = X.data_ptr()
    assert tref._normalize_columns(X) is X and X.data_ptr() == ptr
    assert torch.equal(X, want)


def test_the_correction_unit_rounds_the_shift_as_the_host_did():
    """(lam + corr) in float64 on the device, then cast: bitwise the host's
    ``lam += corr`` followed by ``as_tensor(lam, dtype=float32)``."""
    rng = np.random.default_rng(2)
    lam = rng.uniform(0.5, 3.0, 64)
    corr = rng.standard_normal(64) * 1e-7
    device = (torch.from_numpy(lam) + torch.from_numpy(corr)).to(torch.float32)
    host = lam.copy()
    host += corr
    assert torch.equal(device, torch.as_tensor(host, dtype=torch.float32))

