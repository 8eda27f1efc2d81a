"""Multi-process launches of the port (``parallel/mesh.py``,
``parallel/launch.py``, ``parallel/dryrun.py``): the environment checks of
``initialize_distributed``, real gloo process groups of 2, 3 and 4 ranks
on this host, and the dry run of every sharded path.

Every launch goes through ``run_ranks``, which kills its ranks and raises
when they outlast their timeout, so a hang fails the test instead of the
tier.  The ranks import no JAX (``tests/test_torch_rank_work.py``).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lanczos_tpu_torch.ops.compensated import dot2_rounded  # noqa: E402
from lanczos_tpu_torch.parallel import initialize_distributed, make_row_mesh  # noqa: E402
from lanczos_tpu_torch.parallel.dryrun import dryrun_multichip, graph_laplacian_v2  # noqa: E402
from lanczos_tpu_torch.parallel.launch import run_ranks  # noqa: E402

import test_torch_rank_work  # noqa: E402

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture()
def clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_unset_environment_is_single_process(clean_env):
    assert initialize_distributed(device="cpu") == 1
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_row_mesh()


@pytest.mark.parametrize("env,match", [
    ({"WORLD_SIZE": "2"}, "no MASTER_ADDR"),
    ({"MASTER_ADDR": "127.0.0.1"}, "WORLD_SIZE"),
    ({"MASTER_ADDR": "127.0.0.1", "WORLD_SIZE": "2"}, "RANK and MASTER_PORT"),
])
def test_half_set_launch_raises(clean_env, env, match):
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        initialize_distributed(device="cpu")


def test_two_process_row_sum():
    """Two ranks reduce a row-sharded vector: each sees the global sum."""
    out = run_ranks(test_torch_rank_work.row_sum, 2, device="cpu", timeout=120.0)
    assert out == [(float(sum(range(16))), 0, 2), (float(sum(range(16))), 1, 2)]


def test_two_process_lanczos_matches_one():
    """Lanczos across the process boundary (2 ranks: each one's previous
    and next rank are the same peer) == the single-process factorization
    (1e-9 relative), the same on both ranks."""
    v0 = np.random.default_rng(42).standard_normal(16**3)
    out = run_ranks(test_torch_rank_work.two_rank_lanczos, 2, v0, 25, device="cpu",
                    timeout=120.0)
    for alpha, beta, a_ref, b_ref in out:
        np.testing.assert_allclose(alpha, a_ref, rtol=1e-9, atol=1e-9 * np.abs(a_ref).max())
        np.testing.assert_allclose(beta, b_ref, rtol=1e-9, atol=1e-9 * np.abs(b_ref).max())
    np.testing.assert_array_equal(out[0][0], out[1][0])


def test_collectives_on_three_ranks():
    """At D = 3 (previous and next rank differ): the halo exchange hands
    each rank its neighbours' planes, the all-gather is rank-ordered, and
    the sharded dot2_rounded equals the single-device one: within 1 ulp in
    float32 (the float64 partial sums are all-reduced), to 2 eps64 relative
    in float64 (the ranks' double-word pairs are summed exactly)."""
    rng = np.random.default_rng(9)
    a, b = rng.standard_normal((12, 5)), rng.standard_normal((12, 5))
    out = run_ranks(test_torch_rank_work.collectives, 3, a, b, device="cpu", timeout=120.0)
    for r, res in enumerate(out):
        np.testing.assert_array_equal(res["from_prev"], a[(4 * r - 1) % 12])
        np.testing.assert_array_equal(res["from_next"], a[(4 * r + 4) % 12])
        np.testing.assert_array_equal(res["gathered"], a)
        f32 = float(dot2_rounded(torch.as_tensor(a.ravel(), dtype=torch.float32),
                                 torch.as_tensor(b.ravel(), dtype=torch.float32)))
        assert abs(res["dots"][torch.float32] - f32) <= abs(np.spacing(np.float32(f32)))
        f64 = float(dot2_rounded(torch.as_tensor(a.ravel()), torch.as_tensor(b.ravel())))
        assert abs(res["dots"][torch.float64] - f64) <= 2 * np.finfo(float).eps * abs(f64)


def test_failing_rank_stops_the_launch():
    with pytest.raises(RuntimeError, match="rank one fails"):
        run_ranks(test_torch_rank_work.fail_on_rank_one, 2, device="cpu", timeout=120.0)


def test_hung_ranks_are_killed_at_the_timeout():
    with pytest.raises(TimeoutError):
        run_ranks(test_torch_rank_work.hang, 2, device="cpu", timeout=10.0)


def test_dryrun_multichip_4():
    """The counterpart of __graft_entry__.py:dryrun_multichip on 4 gloo ranks."""
    rep = dryrun_multichip(4, device="cpu", timeout=240.0)
    assert np.isfinite([rep["lowest_ritz"], rep["composite_lowest"], rep["restarted_lowest"],
                        rep["composite_v2_lowest"]]).all()
    ex = rep["exchange"]
    assert ex["stencil"]["per_device_recv_elements"] == 2 * 8 * 8
    assert ex["ell-allgather"]["per_device_recv_elements"] == 8**3 - 8**3 // 4
    assert ex["composite-v2"]["kind"] == "composite-v2-surface-runs"


@pytest.mark.parametrize("fn", [graph_laplacian_v2, run_ranks])
def test_builders_default_to_cuda(fn):
    """As every builder of the port (test_default_device_is_cuda): left
    without ``device``, these run on the card, never quietly on the CPU."""
    import inspect

    from lanczos_tpu_torch._util import DEFAULT_DEVICE

    assert inspect.signature(fn).parameters["device"].default == DEFAULT_DEVICE == "cuda"


@pytest.mark.parametrize("cards", [0, 3])
def test_dryrun_without_enough_cards_raises(monkeypatch, cards):
    """dryrun_multichip(4) on a host with fewer than 4 cards names the
    count and the CPU switch instead of running gloo ranks unasked; it
    starts no rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    import lanczos_tpu_torch.parallel.dryrun as dryrun

    monkeypatch.setattr(dryrun, "run_ranks", lambda *a, **k: pytest.fail("ranks started"))
    with pytest.raises(ValueError, match=f"has {cards}; pass device=\"cpu\""):
        dryrun_multichip(4)
