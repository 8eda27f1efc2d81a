"""The port's ``solve-regular`` CLI, in process, against lanczos_tpu.eigsh."""

import jax  # noqa: F401  (kept on the CPU by conftest)
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402

from lanczos_tpu_torch.cli import main  # noqa: E402

ARGS = ["solve-regular", "-N", "8", "-n", "512", "-k", "3", "--dtype", "float64", "--device", "cpu"]


def test_solve_regular_matches_jax(capsys, tmp_path):
    out_prefix = str(tmp_path / "pairs")
    res = main(ARGS + ["--out", out_prefix])
    text = capsys.readouterr().out
    assert "# regular 8^3 grid, 27-pt stencil" in text and "on cpu" in text
    assert "EIGENVALUE AND EIGENVECTOR SUMMARY" in text
    assert text.count(" ok") == 3
    # n = M = 512 is full Krylov depth, so the eigenvalues do not depend on
    # the start vector: fp64 agreement to 1e-8.
    H = lt.build_regular_hamiltonian(8, 25.0, lt.deuteron_potential_3d, stencil="27", dtype="float64")
    ref = lt.eigsh(H, k=3, n=512, dtype=np.float64)
    np.testing.assert_allclose(res.eigenvalues.numpy(), np.asarray(ref.eigenvalues), atol=1e-8, rtol=0)
    vals = np.load(out_prefix + "_eigvals.npy")
    vecs = np.load(out_prefix + "_eigvecs.npy")
    assert vals.shape == (3,) and vecs.shape == (512, 3)


def test_solve_regular_block_matches_jax(capsys):
    """--block-size 2 runs eigsh_block_restarted, as lanczos_tpu's CLI
    routes it: the converged float64 eigenvalues match the JAX package's
    (each from its own seeded start block) within 1e-8."""
    res = main(["solve-regular", "-N", "12", "-k", "3", "--block-size", "2", "--tol", "1e-8",
                "--dtype", "float64", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "# regular 12^3 grid" in text and "on cpu" in text and text.count(" ok") == 3
    H = lt.build_regular_hamiltonian(12, 25.0, lt.deuteron_potential_3d, stencil="27",
                                     dtype="float64")
    ref = lt.eigsh_block_restarted(H, k=3, block_size=2, tol=1e-8, dtype=np.float64)
    np.testing.assert_allclose(res.eigenvalues.numpy(), np.asarray(ref.eigenvalues), atol=1e-8,
                               rtol=0)
    assert res.cycles >= 1


def test_restart_takes_precedence_over_block_size(monkeypatch, capsys):
    """``--restart --block-size 2`` runs eigsh_restarted in both CLIs."""
    import lanczos_tpu_torch as pt
    from lanczos_tpu.cli import main as jax_main

    called = []
    for pkg in (lt, pt):
        for name in ("eigsh_restarted", "eigsh_block_restarted"):
            fn = getattr(pkg, name)
            monkeypatch.setattr(pkg, name, lambda *a, _fn=fn, _tag=(pkg.__name__, name), **kw:
                                called.append(_tag) or _fn(*a, **kw))
    argv = ["solve-regular", "-N", "6", "-k", "2", "--restart", "--block-size", "2", "--tol",
            "1e-8", "--dtype", "float64"]
    main(argv + ["--device", "cpu"])
    jax_main(argv + ["--platform", "cpu"])
    capsys.readouterr()
    assert called == [("lanczos_tpu_torch", "eigsh_restarted"), ("lanczos_tpu", "eigsh_restarted")]


def test_solve_regular_restart_matches_jax(capsys):
    """--restart runs eigsh_restarted, as lanczos_tpu's CLI routes it: the
    converged float64 eigenvalues match the JAX package's (each from its
    own seeded start vector)."""
    res = main(["solve-regular", "-N", "12", "-k", "3", "--restart", "--tol", "1e-8",
                "--dtype", "float64", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "# regular 12^3 grid" in text and "on cpu" in text
    H = lt.build_regular_hamiltonian(12, 25.0, lt.deuteron_potential_3d, stencil="27",
                                     dtype="float64")
    ref = lt.eigsh_restarted(H, k=3, tol=1e-8, dtype=np.float64)
    np.testing.assert_allclose(res.eigenvalues.numpy(), np.asarray(ref.eigenvalues), rtol=1e-8)


def test_cuda_device_without_card_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("a card is visible; this checks hosts without one")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["solve-regular", "-N", "4", "-n", "8", "-k", "2", "--device", "cuda"])


IRR = ["solve-irregular", "-N", "24", "-k", "3", "--dtype", "float64", "--device", "cpu"]


@pytest.fixture(scope="module")
def irregular_reference():
    """lanczos_tpu's Krylov–Schur on its ELL assembly of the CLI's lattice,
    from the CLI's lattice-order start vector (torch.Generator, seed 99)."""
    lat = lt.build_lattice(24, 25.0, 3, potential=lt.deuteron_potential_3d)
    H = lt.assemble_irregular_hamiltonian(lat, lt.deuteron_potential_3d, dtype=np.float64)
    gen = torch.Generator().manual_seed(99)
    v0 = (torch.rand(lat.num_points, generator=gen, dtype=torch.float64) * 2 - 1).numpy()
    res = lt.eigs_nonsym(H, k=3, max_basis=40, tol=1e-4, v0=v0, dtype=np.float64)
    return lat.num_points, np.asarray(res.eigenvalues)


@pytest.mark.parametrize("solver,n", [("krylov-schur", 40), ("two-sided", 120)])
def test_solve_irregular_matches_jax(solver, n, capsys, tmp_path, irregular_reference):
    p, ref = irregular_reference
    out_prefix = str(tmp_path / "irr")
    res = main(IRR + ["--solver", solver, "-n", str(n), "--out", out_prefix])
    text = capsys.readouterr().out
    assert f"# lattice: {p} points" in text and "on cpu" in text
    assert ("Krylov-Schur" if solver == "krylov-schur" else "two-sided Lanczos") in text
    assert (res.residuals.numpy() < 1e-4).all()
    # Converged to a true relative residual of 1e-4 on both sides: the
    # eigenvalues agree to well inside that (KS on the same start vector).
    np.testing.assert_allclose(res.eigenvalues.numpy()[0], ref[0], rtol=1e-6)
    if solver == "krylov-schur":
        np.testing.assert_allclose(res.eigenvalues.numpy(), ref, rtol=1e-6)
    vecs = np.load(out_prefix + "_eigvecs.npy")
    assert vecs.shape == (p, res.k)


def test_solve_irregular_compensated_matches_jax(capsys, irregular_reference):
    """--compensated reaches eigs_nonsym's error-free-transform reductions;
    the eigenvalues match the JAX package's Krylov–Schur."""
    _, ref = irregular_reference
    res = main(IRR + ["-n", "40", "--compensated"])
    assert "Krylov-Schur" in capsys.readouterr().out
    assert (res.residuals.numpy() < 1e-4).all()
    np.testing.assert_allclose(res.eigenvalues.numpy(), ref, rtol=1e-6)


def test_solve_irregular_unported_options_exit_cleanly():
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(["solve-irregular", "-N", "24", "--device", "cuda"])
