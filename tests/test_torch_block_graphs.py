"""The block restart cycle behind ``solver/graphs.py``, against
lanczos_tpu/solver/block.py and against the port's checked cycle.

On a card ``eigsh_block_restarted`` runs each block cycle speculatively
(Cholesky QR twice, no cure, the steps' breakdown flags written to a device
buffer) as a CUDA graph replay after the first cycle, reads the flags once
with the cycle's blocks, and runs a cycle in which a step broke down again,
eagerly and cured.  Here, on the CPU, a stand-in for ``torch.cuda.CUDAGraph``
(``torch_graph_stub``) takes the same control flow.  Held: the speculative
cycle without flags equals the checked cycle bitwise; the captured solve
equals the eager one bitwise (one capture, a replay every later cycle); a
rank-deficient operator forces a redo and still equals the eager solve;
a solve with every cycle redone equals the speculative one; the solve
stays within the JAX package's tolerance.  fp64 unless stated.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.ops.operators import DenseOperator as JaxDense  # noqa: E402
from lanczos_tpu.solver import block as jb  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.ops.operators import DenseOperator  # noqa: E402
from lanczos_tpu_torch.solver import block as pb  # noqa: E402
from lanczos_tpu_torch.solver import graphs  # noqa: E402
from lanczos_tpu_torch.solver.restart import _ritz_update  # noqa: E402

from torch_graph_stub import install, replay_counts  # noqa: E402

FIELDS = ("eigenvalues", "eigenvectors", "residuals", "inner_prod")


@pytest.fixture
def stub_cuda(monkeypatch):
    """Runs CycleGraphs' card path on CPU tensors (``torch_graph_stub``)."""
    return install(monkeypatch.setattr)


def _regular(dtype=torch.float64, n=8):
    return pt.build_regular_hamiltonian(n, 25.0, pt.deuteron_potential_3d, stencil="27",
                                        dtype=dtype, device="cpu")


def _rank_deficient(rank=6):
    """A rank-``rank`` operator of dimension 120 (test_torch_block.py:
    test_breakdown_rank_deficient's at rank 6) and the solve's arguments.
    Rank 6: a b=4 block's Krylov space (at most 4 + 6 dimensions) is
    exhausted in the first cycle, which converges.  Rank 10 with 3 blocks
    a cycle: the first cycle does not reach the end of the space, the
    second (the first one captured) breaks down, and the solve runs out
    its 10 cycles near the four largest eigenvalues."""
    B = np.random.default_rng(5).standard_normal((120, rank))
    kw = (dict(k=6, block_size=4, num_blocks=4, n_locked=8, tol=1e-9, max_cycles=6)
          if rank == 6 else
          dict(k=4, block_size=4, num_blocks=3, n_locked=4, tol=1e-9, max_cycles=10))
    return B @ B.T, dict(kw, which="LA")


def _same(a, b):
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.cycles == b.cycles


def _captured_and_eager(op, **kw):
    """The solve through the (stub) card path, its graph counts, and the
    same solve under graphs.eager() with its counts."""
    graphs.reset_stats()
    captured = pt.eigsh_block_restarted(op, **kw)
    seen = dict(graphs.stats)
    graphs.reset_stats()
    with graphs.eager():
        plain = pt.eigsh_block_restarted(op, **kw)
    return captured, seen, plain, dict(graphs.stats)


@pytest.mark.parametrize("l", [0, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_speculative_cycle_without_flags_equals_the_checked_cycle(l, dtype):
    """From the same V and q0, the speculative cycle (flags given) and the
    checked one (host-read QR, cure) write the same V and return the same
    blocks, bit for bit, and set no flag; l = 8 deflates against locked
    rows made by a first cycle and the Ritz rotation."""
    op = _regular(dtype)
    nb, b = 5, 4
    V = torch.zeros((l + nb * b + 1, op.shape[0]), dtype=dtype)
    q0 = pb._qr(pb._start_block(op, b, 7, dtype))[0].contiguous()
    if l:
        pb._block_cycle(op.matmat, V, q0, 0, nb, b)
        rot = torch.linalg.qr(torch.randn(nb * b, l, generator=torch.Generator().manual_seed(1),
                                          dtype=torch.float64))[0]
        e = torch.zeros((V.shape[0] - 1, l), dtype=dtype)
        e[:nb * b] = rot.to(dtype)
        _ritz_update(V, e, l)
    V_checked, V_spec = V.clone(), V.clone()
    flags = torch.ones((nb - 1, b + 1), dtype=torch.bool)
    checked = pb._block_cycle(op.matmat, V_checked, q0, l, nb, b)
    spec = pb._block_cycle(op.matmat, V_spec, q0, l, nb, b, flags)
    assert not bool(flags.any())
    assert torch.equal(V_checked, V_spec)
    for a, s in zip(checked, spec):
        assert torch.equal(a, s)


def test_captured_block_solve_equals_eager_bitwise(stub_cuda):
    """Through the stub graph: one eager cycle, one capture for the
    locked count, a replay every later cycle, no redo; the result equals
    the eager solve's, bit for bit."""
    a = np.random.default_rng(3).standard_normal((300, 300))
    op = DenseOperator(torch.as_tensor((a + a.T) / 2))
    kw = dict(k=6, block_size=4, num_blocks=5, tol=1e-9, max_cycles=60)
    captured, seen, plain, plain_stats = _captured_and_eager(op, **kw)
    assert plain_stats["captures"] == plain_stats["replays"] == plain_stats["eager"] == 0
    assert seen["cycles"] == plain_stats["cycles"] and len(seen["cycles"]) >= 3
    assert all(key[0] == "block" for key in seen["cycles"])
    assert (seen["eager"], seen["captures"], seen["replays"]) == replay_counts(plain_stats)
    assert seen["captures"] == len(stub_cuda) == 1 and stub_cuda[0].graph.replays == seen["replays"]
    assert seen["redo"] == plain_stats["redo"] == 0
    _same(captured, plain)


@pytest.mark.parametrize("rank", [6, 10])
def test_breakdown_drives_a_redo_that_equals_the_eager_solve(stub_cuda, monkeypatch, rank):
    """A step breaks down, its cycle is redone eagerly with the cure (at
    rank 10 in a captured cycle, l > 0), and the captured solve still
    equals the eager one, bit for bit; the eigenvalues are the dense
    ones (to 1e-8 at rank 6, where the solve converges; to 1e-6 relative
    at rank 10, where it runs out its cycles)."""
    A, kw = _rank_deficient(rank)
    op = DenseOperator(torch.as_tensor(A))
    redone_at = []
    cycle = pb._block_cycle

    def spy(*args):
        if len(args) == 6:
            redone_at.append(args[3])
        return cycle(*args)

    monkeypatch.setattr(pb, "_block_cycle", spy)
    captured, seen, plain, plain_stats = _captured_and_eager(op, **kw)
    assert seen["redo"] >= 1 and seen["redo"] == plain_stats["redo"]
    assert (seen["eager"], seen["captures"], seen["replays"]) == replay_counts(plain_stats)
    if rank == 10:
        assert seen["replays"] >= 8 and redone_at[0] > 0
    _same(captured, plain)
    exact = np.sort(np.linalg.eigvalsh(A))[::-1][:kw["k"]]
    tol = 1e-8 if rank == 6 else 1e-6 * exact[0]
    np.testing.assert_allclose(captured.eigenvalues.numpy(), exact, rtol=0, atol=tol)


@pytest.mark.parametrize("case", ["regular", "rank_deficient"])
def test_every_cycle_redone_equals_the_speculative_solve(monkeypatch, case):
    """A flag forced in every cycle makes every cycle the checked one, run
    again from the same start: the solve equals the speculative solve, bit
    for bit (where no step broke down, the speculative cycle is the checked
    one; where one did, both solves take the checked cycle)."""
    if case == "regular":
        op, kw = _regular(), dict(k=4, block_size=4, tol=1e-10)
    else:
        A, kw = _rank_deficient(10)
        op = DenseOperator(torch.as_tensor(A))
    graphs.reset_stats()
    want = pt.eigsh_block_restarted(op, **kw)
    natural = graphs.stats["redo"]
    cycle = pb._block_cycle

    def flagged(*args):
        out = cycle(*args)
        if len(args) == 7:
            args[6][0, 0] = True
        return out

    monkeypatch.setattr(pb, "_block_cycle", flagged)
    graphs.reset_stats()
    got = pt.eigsh_block_restarted(op, **kw)
    assert graphs.stats["redo"] == got.cycles >= 2
    assert (natural == 0) == (case == "regular")
    _same(got, want)


def test_captured_block_solve_matches_jax(stub_cuda):
    """test_torch_block.py's regular-stencil case through the stub graph:
    within 1e-8 of the JAX package's eigsh_block_restarted (N=8, k=4,
    b=4, fp64) and of the dense spectrum."""
    hj = lt.build_regular_hamiltonian(8, 25.0, lt.deuteron_potential_3d, stencil="27",
                                      dtype=np.float64)
    hp = _regular()
    kw = dict(k=4, block_size=4, tol=1e-10)
    rj = jb.eigsh_block_restarted(hj, dtype=np.float64, **kw)
    rp = pt.eigsh_block_restarted(hp, **kw)
    assert graphs.stats["replays"] == rp.cycles - 1 and graphs.stats["captures"] == 1
    np.testing.assert_allclose(rp.eigenvalues.numpy(), np.asarray(rj.eigenvalues), atol=1e-8,
                               rtol=0)
    A = hp.to_scipy().toarray()
    exact = np.linalg.eigvalsh((A + A.T) / 2)[:4]
    np.testing.assert_allclose(rp.eigenvalues.numpy(), exact, atol=1e-8, rtol=0)


def test_captured_rank_deficient_solve_matches_jax(stub_cuda):
    """The rank-6 operator through the stub graph (its cycle redone): the
    six nonzero eigenvalues within 1e-8 of the JAX package's block
    solve of the same operator."""
    import jax.numpy as jnp

    A, kw = _rank_deficient(6)
    rj = jb.eigsh_block_restarted(JaxDense(jnp.asarray(A)), dtype=np.float64, **kw)
    rp = pt.eigsh_block_restarted(DenseOperator(torch.as_tensor(A)), **kw)
    assert graphs.stats["redo"] >= 1
    np.testing.assert_allclose(rp.eigenvalues.numpy(), np.asarray(rj.eigenvalues), rtol=1e-8,
                               atol=1e-8)
