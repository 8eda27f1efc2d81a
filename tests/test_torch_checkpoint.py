"""The port's checkpoints against lanczos_tpu's, in the same file format.

An interrupted run resumed from its file matches the uninterrupted run; a
file the JAX package wrote resumes in the port, and the reverse; a resumed
locked block that does not fit the basis raises.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from conftest import random_sparse_symmetric  # noqa: E402

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.solver.restart import eigsh_restarted as jax_restarted  # noqa: E402
from lanczos_tpu.utils import checkpoint as jck  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.solver.restart import eigsh_restarted  # noqa: E402
from lanczos_tpu_torch.utils import checkpoint as tck  # noqa: E402

M, N = 200, 60


@pytest.fixture(scope="module")
def ops():
    a = random_sparse_symmetric(np.random.default_rng(1234), M)
    v0 = np.random.default_rng(5).uniform(-1, 1, M)
    return a, lt.ell_from_scipy(a, dtype=np.float64), pt.ell_from_scipy(
        a, dtype=torch.float64, device="cpu"), v0


def _straight(ops, tmp_path):
    _, _, op, v0 = ops
    return tck.lanczos_checkpointed(op, N, str(tmp_path / "straight.npz"), every=N, v0=v0)


@pytest.mark.parametrize("layout", ["file", "dir"])
def test_lanczos_resume_matches_uninterrupted(ops, tmp_path, layout):
    _, _, op, v0 = ops
    ref = _straight(ops, tmp_path)
    path = str(tmp_path / ("state.npz" if layout == "file" else "ckpt"))
    seen = []
    fac = tck.lanczos_checkpointed(op, N, path, every=17, v0=v0, progress=seen.append)
    assert seen == [18, 35, 52, 60]
    np.testing.assert_allclose(fac.alpha.numpy(), ref.alpha.numpy(), rtol=1e-12)
    if layout == "dir":
        assert sorted(f for f in os.listdir(path) if f.startswith("V_")) == [
            "V_000000_000001.npy", "V_000001_000018.npy", "V_000018_000035.npy",
            "V_000035_000052.npy", "V_000052_000060.npy"]
    # Interrupted at j=35: a 35-step run's state grafted into an n=60 file.
    pre = tck.lanczos_checkpointed(op, 35, str(tmp_path / "pre.npz"), every=35, v0=v0)
    V = np.zeros((N, M))
    V[:35] = pre.V.numpy()
    al, be = np.zeros(N), np.zeros(N - 1)
    al[:35], be[:34] = pre.alpha.numpy(), pre.beta.numpy()
    path2 = str(tmp_path / ("resume.npz" if layout == "file" else "resume"))
    if layout == "file":
        tck.save_state(path2, V, pre.resid, al, be, 35)
    else:
        tck._save_incremental(path2, V, pre.resid.numpy(), al, be, 0, 35)
    res = tck.lanczos_checkpointed(op, N, path2, every=17)
    np.testing.assert_allclose(res.alpha.numpy(), ref.alpha.numpy(), rtol=1e-10)
    np.testing.assert_allclose(res.beta.numpy(), ref.beta.numpy(), rtol=1e-10)


def test_lanczos_resumes_across_packages(ops, tmp_path):
    """A JAX-written 35-step state resumes in the port; a port-written one
    resumes in the JAX package; both end at the uninterrupted alphas."""
    _, jop, op, v0 = ops
    ref = _straight(ops, tmp_path)
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        d = str(tmp_path / f"{writer}_dir")
        if writer == "jax":
            jck.lanczos_checkpointed(jop, 35, d, every=17, v0=jnp.asarray(v0), dtype="float64")
        else:
            tck.lanczos_checkpointed(op, 35, d, every=17, v0=v0)
        # Widen the written 35-step state to n=60 (histories padded).
        V, r, al, be, j = (jck if writer == "jax" else tck)._load_incremental(d, 35, M)
        d60 = str(tmp_path / f"{writer}_to_{reader}")
        Vn, aln, ben = np.zeros((N, M)), np.zeros(N), np.zeros(N - 1)
        Vn[:35], aln[:35], ben[:34] = V, al, be
        tck._save_incremental(d60, Vn, r, aln, ben, 0, 35)
        if reader == "torch":
            alpha = tck.lanczos_checkpointed(op, N, d60, every=17).alpha.numpy()
        else:
            alpha = np.asarray(jck.lanczos_checkpointed(jop, N, d60, every=17,
                                                        dtype="float64").alpha)
        np.testing.assert_allclose(alpha, ref.alpha.numpy(), rtol=1e-10)


KW = dict(k=4, tol=1e-10, max_basis=20)


@pytest.fixture(scope="module")
def restart_runs(ops, tmp_path_factory):
    """The uninterrupted port run, and a JAX run stopped after 2 cycles."""
    a, jop, op, v0 = ops
    straight = eigsh_restarted(op, v0=v0, max_cycles=200, **KW)
    jpath = str(tmp_path_factory.mktemp("jax") / "restart.npz")
    jax_restarted(jop, v0=jnp.asarray(v0), dtype="float64", max_cycles=2,
                  checkpoint_path=jpath, **KW)
    return straight, jpath


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_restart_resume_matches_uninterrupted(ops, restart_runs, tmp_path, writer):
    _, _, op, v0 = ops
    straight, jpath = restart_runs
    path = str(tmp_path / "restart.npz")
    if writer == "torch":
        eigsh_restarted(op, v0=v0, max_cycles=2, checkpoint_path=path, **KW)
    else:
        path = jpath
    *_, cycle = tck.load_restart_state(path)
    assert cycle == 2
    resumed = eigsh_restarted(op, v0=None, max_cycles=200, checkpoint_path=path, **KW)
    np.testing.assert_allclose(resumed.eigenvalues.numpy(), straight.eigenvalues.numpy(),
                               rtol=1e-10, atol=1e-12)
    assert float(resumed.residuals.max()) < 1e-7


def test_restart_resume_checks_the_locked_block(ops, tmp_path):
    _, _, op, _ = ops
    m = KW["max_basis"]
    u = np.random.default_rng(0).normal(size=M)
    u /= np.linalg.norm(u)  # a saved restart vector is a unit vector
    too_many = str(tmp_path / "too_many.npz")
    tck.save_restart_state(too_many, np.zeros((m - 1, M)), u, np.zeros(m - 1), np.zeros(m - 1), 3)
    with pytest.raises(ValueError, match="m - 2"):
        eigsh_restarted(op, checkpoint_path=too_many, **KW)
    # An empty locked block (l = 0) resumes as a fresh start from u.
    empty = str(tmp_path / "empty.npz")
    tck.save_restart_state(empty, np.zeros((0, M)), u, np.zeros(0), np.zeros(0), 1)
    res = eigsh_restarted(op, checkpoint_path=empty, max_cycles=200, **KW)
    want = np.sort(np.linalg.eigvalsh(op.to_scipy().toarray()))[:4]
    np.testing.assert_allclose(res.eigenvalues.numpy(), want, atol=1e-8)
