"""The lagged Lanczos recurrence (``solver/lanczos.py:_lagged_row``) on
the CPU: its tridiagonal T against the plain recurrence's, its alpha
correction, segments split anywhere, the paths that keep the plain
recurrence, and the counters.

A plain run is forced by a ``dot`` that is not the default one (the same
``torch.dot``, wrapped): the lagged path takes the default dots only.  The
CUDA kernel behind the lagged step is held to the plain step on a card
(``tests/test_torch_cuda.py``) and its index math in
``tests/test_torch_cgs2.py``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch._util import COUNTERS  # noqa: E402
from lanczos_tpu_torch.ops import cgs2_kernels as ck  # noqa: E402
from lanczos_tpu_torch.solver.lanczos import lanczos_kernel, lanczos_segment  # noqa: E402
from lanczos_tpu_torch.utils import lanczos_checkpointed  # noqa: E402

N_STEPS = 40


@pytest.fixture(scope="module")
def op():
    return pt.build_regular_hamiltonian(10, 25.0, pt.deuteron_potential_3d, stencil="27",
                                        dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def norm(op):
    return float(op.weights.abs().sum()) + float(op.diag.abs().max())


def start(op, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, op.shape[0]))


def plain_dot(a, b):
    return torch.dot(a, b)


def tridiag_eigs(fac):
    a, b = fac.alpha.double().numpy(), fac.beta.double().numpy()
    return np.linalg.eigvalsh(np.diag(a) + np.diag(b, 1) + np.diag(b, -1))


def reads(fn):
    before = COUNTERS.copy()
    out = fn()
    return out, {k: COUNTERS[k] - before[k]
                 for k in ("lt.cgs2.basis_reads", "lt.cgs2.calls", "lt.cgs2.fused")}


@pytest.mark.parametrize("passes", [2, 3])
def test_lagged_ritz_values_match_the_plain_recurrence(op, norm, passes):
    """fp64: the lagged T's eigenvalues are the plain recurrence's to
    1e-12 ||H||, its rows as orthonormal, and the same Lanczos vectors."""
    v0 = start(op)
    lagged = lanczos_kernel(op.matvec, v0, N_STEPS, reorth_passes=passes)
    plain = lanczos_kernel(op.matvec, v0, N_STEPS, reorth_passes=passes, dot=plain_dot)
    np.testing.assert_allclose(tridiag_eigs(lagged), tridiag_eigs(plain), rtol=0,
                               atol=1e-12 * norm)
    V = lagged.V
    assert float((V @ V.T - torch.eye(N_STEPS, dtype=V.dtype)).abs().max()) < 1e-14
    np.testing.assert_allclose(lagged.V.numpy(), plain.V.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(lagged.resid.numpy(), plain.resid.numpy(), rtol=0,
                               atol=1e-10 * norm)


@pytest.mark.parametrize("delta", [3e-8, 1e-7])
def test_alpha_correction_holds_for_any_split_of_the_unfinished_row(op, norm, monkeypatch,
                                                                    delta):
    """The unfinished row v~ and its coefficients h~ are one vector, v~ -
    V^T h~, in many forms: add V^T d to v~ and d to h~ (|d| ~ delta) after
    every lagged step.  alpha = v~ . H v~ - 2 beta h~[j-1] still gives
    the plain T's eigenvalues to 1e-12 ||H|| (the remainder is
    O(delta^2 ||H||)), where leaving out the correction would move alpha
    by ~2 beta delta, which is checked to be 10^3 times that tolerance or
    more."""
    real = ck.cgs2_lagged
    gen = torch.Generator().manual_seed(7)
    moved = []

    def perturbed(V, j, v, h_pending, passes):
        h = real(V, j, v, h_pending, passes)
        d = (torch.rand(j, generator=gen, dtype=V.dtype) - 0.5) * 2 * delta
        V[j] += d @ V[:j]
        moved.append(float(d[j - 1]))
        return h + d

    monkeypatch.setattr(ck, "cgs2_lagged", perturbed)
    v0 = start(op, seed=2)
    lagged = lanczos_kernel(op.matvec, v0, N_STEPS)
    monkeypatch.undo()
    plain = lanczos_kernel(op.matvec, v0, N_STEPS, dot=plain_dot)
    assert len(moved) == N_STEPS - 1
    np.testing.assert_allclose(tridiag_eigs(lagged), tridiag_eigs(plain), rtol=0,
                               atol=1e-12 * norm)
    # beta_j * d[j-1] for the steps whose alpha took the correction (all but the last).
    uncorrected = 2 * np.abs(plain.beta.numpy()[:-1] * np.array(moved[:-1]))
    assert uncorrected.max() >= 1e3 * 1e-12 * norm


SPLITS = [(2,), (5, 6), (17, 29), (39,), (3, 10, 11, 12, 30)]


@pytest.mark.parametrize("splits", SPLITS, ids=lambda s: "-".join(map(str, s)))
def test_segments_split_anywhere_give_one_segments_factorization(op, norm, splits):
    """lanczos_segment over [1, a), [a, b), ... from the state each leaves
    equals one segment [1, n) to rounding: a segment finishes its last row
    before returning, so the next starts with every row finished; each
    segment costs one closing sweep."""
    v0 = start(op, seed=3)
    one = lanczos_kernel(op.matvec, v0, N_STEPS)
    V = torch.zeros(N_STEPS, op.shape[0], dtype=torch.float64)
    V[0] = v0 / v0.norm()
    w = op.matvec(V[0])
    alpha = torch.zeros(N_STEPS, dtype=torch.float64)
    alpha[0] = torch.dot(V[0], w)
    r = w - alpha[0] * V[0]
    beta = torch.zeros(N_STEPS - 1, dtype=torch.float64)
    bki = torch.tensor(N_STEPS)
    edges = [1, *splits, N_STEPS]
    before = COUNTERS["lt.cgs2.basis_reads"]
    for j0, j1 in zip(edges, edges[1:]):
        V, r, alpha, beta, bki = lanczos_segment(op.matvec, V, r, alpha, beta, bki, j0, j1)
    assert COUNTERS["lt.cgs2.basis_reads"] - before == 2 * (N_STEPS - 1) + len(edges) - 1
    assert int(bki) == N_STEPS
    np.testing.assert_allclose(alpha.numpy(), one.alpha.numpy(), rtol=0, atol=1e-12 * norm)
    np.testing.assert_allclose(beta.numpy(), one.beta.numpy(), rtol=0, atol=1e-12 * norm)
    np.testing.assert_allclose(V.numpy(), one.V.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(r.numpy(), one.resid.numpy(), rtol=0, atol=1e-10 * norm)


@pytest.mark.parametrize("every", [1, 7, 13])
def test_checkpointed_segments_give_one_segments_factorization(op, norm, tmp_path, every):
    v0 = start(op, seed=4)
    one = lanczos_kernel(op.matvec, v0, N_STEPS)
    fac, got = reads(lambda: lanczos_checkpointed(op, N_STEPS, str(tmp_path / "ck"),
                                                  every=every, v0=v0))
    segments = -(-(N_STEPS - 1) // every)
    assert got["lt.cgs2.basis_reads"] == 2 * (N_STEPS - 1) + segments
    assert got["lt.cgs2.calls"] == N_STEPS - 1
    np.testing.assert_allclose(fac.alpha.numpy(), one.alpha.numpy(), rtol=0, atol=1e-12 * norm)
    np.testing.assert_allclose(fac.beta.numpy(), one.beta.numpy(), rtol=0, atol=1e-12 * norm)
    np.testing.assert_allclose(fac.V.numpy(), one.V.numpy(), rtol=0, atol=1e-10)


# (keyword arguments of lanczos_kernel, sweeps over V a call makes, the
# number of calls): full with the default dots and p >= 2 lags (p a step
# and one to close); every other run keeps the plain recurrence, whose
# cgs2 makes p + 1 sweeps (2p in a mesh's loop) on the steps it
# reorthogonalizes.
STEPS = N_STEPS - 1
PATHS = {
    "lagged": (dict(), 2 * STEPS + 1, STEPS),
    "lagged-passes3": (dict(reorth_passes=3), 3 * STEPS + 1, STEPS),
    "compensated": (dict(compensated=True), 3 * STEPS, STEPS),
    "periodic": (dict(reorth="periodic", reorth_period=5), 3 * 7, 7),  # j = 5, 10, ..., 35
    "custom-dot": (dict(dot=plain_dot), 3 * STEPS, STEPS),
    "mesh-basis-dot": (dict(basis_dot=lambda V, v: V @ v), 4 * STEPS, STEPS),
    "passes1": (dict(reorth_passes=1), 2 * STEPS, STEPS),
    "none": (dict(reorth="none"), 0, 0),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_paths_told_apart_by_basis_reads(op, path):
    kw, want_reads, want_calls = PATHS[path]
    fac, got = reads(lambda: lanczos_kernel(op.matvec, start(op), N_STEPS, **kw))
    assert got == {"lt.cgs2.basis_reads": want_reads, "lt.cgs2.calls": want_calls,
                   "lt.cgs2.fused": 0}  # CPU tensors: no kernel
    assert fac.V.shape == (N_STEPS, op.shape[0])


def test_selective_keeps_the_plain_recurrence(op):
    """The selective kernel reorthogonalizes on some steps only, each with
    cgs2's p + 1 sweeps, and never lags."""
    _, got = reads(lambda: lanczos_kernel(op.matvec, start(op), N_STEPS, reorth="selective"))
    assert 0 < got["lt.cgs2.calls"] < STEPS
    assert got["lt.cgs2.basis_reads"] == 3 * got["lt.cgs2.calls"]


def test_eigsh_counts_one_call_and_two_sweeps_a_step(op):
    """The cell's path: eigsh with the defaults counts one CGS2 call and two
    sweeps a step, and one closing sweep a solve."""
    for seed in (1, 2):
        _, got = reads(lambda: pt.eigsh(op, k=4, n=N_STEPS, v0=start(op, seed)))
        assert got == {"lt.cgs2.basis_reads": 2 * STEPS + 1, "lt.cgs2.calls": STEPS,
                       "lt.cgs2.fused": 0}


def test_steps_past_the_tile_finish_the_row_and_run_unlagged(op, norm, monkeypatch):
    """Past MAX_ROWS rows a step finishes the unfinished row (one sweep)
    and runs cgs2 unlagged (2p sweeps, row blocks); the factorization is
    the all-lagged one to rounding.  MAX_ROWS is lowered to 12 to get
    there at a small size."""
    v0 = start(op, seed=5)
    lagged = lanczos_kernel(op.matvec, v0, N_STEPS)
    monkeypatch.setattr(ck, "MAX_ROWS", 12)
    mixed, got = reads(lambda: lanczos_kernel(op.matvec, v0, N_STEPS))
    assert got["lt.cgs2.basis_reads"] == 2 * 12 + 1 + 4 * (STEPS - 12)
    np.testing.assert_allclose(mixed.alpha.numpy(), lagged.alpha.numpy(), rtol=0,
                               atol=1e-12 * norm)
    np.testing.assert_allclose(mixed.V.numpy(), lagged.V.numpy(), rtol=0, atol=1e-10)


def test_breakdown_on_the_lagged_path():
    """beta underflows at step 2 (v0 spans a 2-dim invariant subspace): the
    lagged step gets a zero vector, stores zero and its T is the plain
    one's; every row stays finite."""
    a = torch.diag(torch.arange(1.0, 7.0, dtype=torch.float64))
    v0 = torch.tensor([1.0, 1.0, 0, 0, 0, 0], dtype=torch.float64)
    lagged = lanczos_kernel(lambda x: a @ x, v0, 6)
    plain = lanczos_kernel(lambda x: a @ x, v0, 6, dot=plain_dot)
    assert int(lagged.breakdown_iter) == int(plain.breakdown_iter) == 2
    np.testing.assert_allclose(lagged.alpha.numpy(), plain.alpha.numpy(), atol=1e-14)
    assert torch.equal(lagged.V[2:], torch.zeros(4, 6, dtype=torch.float64))


@pytest.mark.parametrize("pending", [False, True])
def test_lagged_step_is_a_cgs2_step(pending):
    """cgs2_lagged on the CPU: V[j] - h~ @ V[:j] is the unit vector plain
    CGS2 stores, and with a pending row, V[j-1] comes back finished."""
    m, j = 300, 25
    q = torch.linalg.qr(torch.from_numpy(np.random.default_rng(8).standard_normal((m, j + 1))))[0]
    V = q.T.contiguous().clone()
    v = torch.from_numpy(np.random.default_rng(9).standard_normal(m)) + 3 * V[:j].sum(0)
    hp = None
    finished = V[j - 1].clone()
    if pending:
        hp = torch.from_numpy(np.random.default_rng(10).uniform(-1e-3, 1e-3, j - 1))
        V[j - 1] += hp @ V[: j - 1]
    h = ck.cgs2_lagged(V, j, v, hp, 2)
    np.testing.assert_allclose(V[j - 1].numpy(), finished.numpy(), rtol=0, atol=1e-15)
    want = ck.cgs2_reference(V[:j], v, 2)
    want = want / want.norm()
    np.testing.assert_allclose((V[j] - h @ V[:j]).numpy(), want.numpy(), rtol=0, atol=1e-14)
    ck.cgs2_finish(V, j + 1, h)
    np.testing.assert_allclose(V[j].numpy(), want.numpy(), rtol=0, atol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lagged_continues_past_an_exhausted_krylov_space(dtype):
    """Five distinct eigenvalues, so the Krylov space is spent after five
    steps and r is rounding noise from then on, above the breakdown test:
    the lagged path, as the plain one, keeps unit rows orthogonal to the
    dtype's precision and a T whose eigenvalues are H's."""
    d = torch.from_numpy(np.repeat(np.arange(1.0, 6.0), 40) * 1e3).to(dtype)
    v0 = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, 200)).to(dtype)
    eps = float(torch.finfo(dtype).eps)
    for dot in (torch.dot, plain_dot):
        fac = lanczos_kernel(lambda x: d * x, v0, 20, dot=dot)
        V = fac.V.double()
        assert int(fac.breakdown_iter) == 20
        assert float((V @ V.T - torch.eye(20, dtype=torch.float64)).abs().max()) < 20 * eps
        ritz = tridiag_eigs(fac)
        assert np.abs(ritz / 1e3 - np.round(ritz / 1e3)).max() < 1e4 * eps, ritz


def test_a_vector_mostly_in_the_span_is_finished_at_once():
    """A unit v of which the passes keep |v_p| = 0.3 < 1/2 (a spent Krylov
    space): the row is finished before the step returns, and the h~ it
    returns is zero; with |v_p| = 0.6 the row is left unfinished."""
    m, j = 300, 25
    rng = np.random.default_rng(11)
    q = torch.linalg.qr(torch.from_numpy(rng.standard_normal((m, j + 2))))[0]
    for kept, finished in ((0.3, True), (0.6, False)):
        V = q.T[: j + 1].contiguous().clone()
        c = torch.from_numpy(rng.standard_normal(j))
        v = kept * q[:, j + 1] + (1 - kept**2) ** 0.5 * (c / c.norm()) @ V[:j]
        h = ck.cgs2_lagged(V, j, v, None, 2)
        want = ck.cgs2_reference(V[:j], v, 2)
        want = want / want.norm()
        assert bool((h == 0).all()) == finished
        np.testing.assert_allclose((V[j] - h @ V[:j]).numpy(), want.numpy(), rtol=0, atol=1e-14)
        if finished:
            np.testing.assert_allclose(V[j].numpy(), want.numpy(), rtol=0, atol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_full_krylov_depth(monkeypatch, dtype):
    """n = M = 512 on the N=8 deuteron: once the Krylov space is spent, r is
    rounding and mostly in the span, and the steps whose passes keep less
    than half of it finish their row before the SpMV (lagging them would
    feed |H| eps / |v_p| into the next residual, step after step).  The
    rows stay orthonormal and T's eigenvalues are H's, as in the plain
    recurrence."""
    op = pt.build_regular_hamiltonian(8, 25.0, pt.deuteron_potential_3d, stencil="27",
                                      dtype=dtype, device="cpu")
    v0 = start(op).to(dtype)
    real, finished = ck.cgs2_lagged, []

    def counting(V, j, v, h_pending, passes):
        h = real(V, j, v, h_pending, passes)
        finished.append(bool((h == 0).all()) and j > 1)
        return h

    monkeypatch.setattr(ck, "cgs2_lagged", counting)
    lagged = lanczos_kernel(op.matvec, v0, 512)
    monkeypatch.undo()
    plain = lanczos_kernel(op.matvec, v0, 512, dot=plain_dot)
    assert 0 < sum(finished) < 100  # only where the space is spent
    eps = float(torch.finfo(dtype).eps)
    V = lagged.V.double()
    assert float((V @ V.T - torch.eye(512, dtype=torch.float64)).abs().max()) < 4 * 512**0.5 * eps
    exact = np.linalg.eigvalsh(op.to_dense().double().numpy())
    err = np.abs(tridiag_eigs(lagged) - exact).max()
    assert err <= 2 * max(np.abs(tridiag_eigs(plain) - exact).max(), 1e-12 * np.abs(exact).max())
