"""The port's spans and counters (``_util.span``, ``_util.COUNTERS``) on the
single-vector ``eigsh`` path: the span tree one solve leaves in a
``torch.profiler`` trace, the counters' steps, and results that do not
depend on whether a profiler is listening.  CPU, the N=12^3 deuteron; the
span trees are taken on its dense form, whose matvec is one host op where
the stencil's plain version is hundreds (each a profiler event)."""

import numpy as np
import pytest
import torch

import lanczos_tpu_torch as lt
from lanczos_tpu_torch._util import COUNTERS
from lanczos_tpu_torch.utils import lanczos_checkpointed

N, K, STEPS = 12, 4, 40

SOLVE = ["lt.lanczos.start", "lt.lanczos.recurrence", "lt.ritz", "lt.select",
         "lt.acceptance"]


@pytest.fixture(scope="module")
def op():
    return lt.build_regular_hamiltonian(N, 25.0, lt.deuteron_potential_3d, stencil="27",
                                        dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def dense(op):
    return lt.as_operator(op.to_dense())


def start(op, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(op.shape[0], generator=gen, dtype=torch.float64) * 2 - 1


def profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("lt.")]


def lt_parent(event):
    """The nearest enclosing ``lt.*`` span, or None."""
    p = event.cpu_parent
    while p is not None and not p.name.startswith("lt."):
        p = p.cpu_parent
    return p


def children(events, parent):
    kids = [e for e in events if lt_parent(e) is parent]
    return [e.name for e in sorted(kids, key=lambda e: e.time_range.start)]


@pytest.mark.parametrize("reorth", ["full", "selective", "none"])
def test_span_tree_of_one_solve(dense, reorth):
    _, events = profiled(lambda: lt.eigsh(dense, k=K, n=STEPS, v0=start(dense), reorth=reorth))
    (root,) = [e for e in events if e.name == "lt.eigsh"]
    assert lt_parent(root) is None
    assert children(events, None) == ["lt.eigsh"]
    assert children(events, root) == SOLVE
    (ritz,) = [e for e in events if e.name == "lt.ritz"]
    assert children(events, ritz) == ["lt.ritz.eigh", "lt.ritz.rotate"]
    assert len(events) == 1 + len(SOLVE) + 2
    for e in events:
        if e is not root:
            assert root.time_range.start <= e.time_range.start <= e.time_range.end \
                <= root.time_range.end


def test_block_branch_has_the_solve_span_only(dense):
    _, events = profiled(lambda: lt.eigsh(dense, k=K, n=STEPS, block_size=2))
    assert [e.name for e in events] == ["lt.eigsh"]


@pytest.mark.parametrize("reorth", ["full", "selective"])
def test_counters_per_solve(op, reorth):
    before = COUNTERS.copy()
    for seed in (1, 2):
        lt.eigsh(op, k=K, n=STEPS, v0=start(op, seed), reorth=reorth)
    assert COUNTERS["lt.eigsh.calls"] - before["lt.eigsh.calls"] == 2
    assert (COUNTERS["lt.lanczos.recurrence.steps"]
            - before["lt.lanczos.recurrence.steps"]) == 2 * (STEPS - 1)


@pytest.mark.parametrize("layout", ["ck.npz", "ckdir"])
def test_checkpointed_segments_share_the_span(dense, tmp_path, layout):
    before = COUNTERS["lt.lanczos.recurrence.steps"]
    fac, events = profiled(lambda: lanczos_checkpointed(
        dense, STEPS, str(tmp_path / layout), every=15, v0=start(dense)))
    assert COUNTERS["lt.lanczos.recurrence.steps"] - before == STEPS - 1
    # Segments [1, 16), [16, 31), [31, 40): one span each.
    assert [e.name for e in events] == ["lt.lanczos.recurrence"] * 3
    ref = lt.lanczos(dense, STEPS, v0=start(dense))
    np.testing.assert_allclose(fac.alpha.numpy(), ref.alpha.numpy(), rtol=1e-12, atol=1e-12)


def test_results_bitwise_with_and_without_a_profiler(op):
    plain = lt.eigsh(op, k=K, n=STEPS, v0=start(op))
    traced, _ = profiled(lambda: lt.eigsh(op, k=K, n=STEPS, v0=start(op)))
    for name in ("eigenvalues", "eigenvectors", "residuals", "inner_prod"):
        assert torch.equal(getattr(plain, name), getattr(traced, name)), name
