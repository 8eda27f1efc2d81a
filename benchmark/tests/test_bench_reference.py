"""The plain references against the program and against dense algebra at
small sizes on the CPU: the same H x, and the plain Lanczos run's Ritz
pairs against a dense projection onto the same Krylov space."""

import numpy as np
import torch

import lanczos_tpu_torch as lt
from benchmark.reference import lanczos, regular_stencil

N = 12
CONFIG = {"n": N, "length": 25.0, "stencil": "27"}


def test_regular_hx_matches_the_program():
    op = lt.build_regular_hamiltonian(N, 25.0, lt.deuteron_potential_3d, stencil="27",
                                      dtype=torch.float64, device="cpu")
    ref = regular_stencil.build(CONFIG, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (N**3, 3)))
    y_ref = ref.apply(x)
    assert torch.allclose(op.matmat(x.contiguous()), y_ref, rtol=0, atol=1e-11 * y_ref.abs().max())
    assert torch.allclose(op.matvec(x[:, 0].contiguous()), ref.apply(x[:, 0]), rtol=0,
                          atol=1e-11 * y_ref.abs().max())


def test_plain_lanczos_against_a_dense_projection():
    """Ritz values of 10 steps equal the eigenvalues of H projected onto the
    Krylov space (a modified Gram-Schmidt basis, the projection taken whole,
    not assumed tridiagonal); the vectors are orthonormal Ritz vectors whose
    residual estimates are their true residuals."""
    ref = regular_stencil.build(CONFIG, "cpu")
    dense = ref.apply(torch.eye(N**3, dtype=torch.float64)).numpy()
    v0 = np.random.default_rng(3).uniform(-1, 1, N**3)
    steps, k = 10, 3
    Q = np.zeros((N**3, steps))
    q = v0 / np.linalg.norm(v0)
    for j in range(steps):
        Q[:, j] = q
        w = dense @ q
        for _ in range(2):
            for i in range(j + 1):
                w -= (Q[:, i] @ w) * Q[:, i]
        q = w / np.linalg.norm(w)
    expect = np.linalg.eigvalsh(Q.T @ dense @ Q)
    theta, Y, est = lanczos.solve(ref.apply, torch.from_numpy(v0), {"k": k, "n": steps})
    assert np.allclose(theta, expect[:k], rtol=0, atol=1e-11 * ref.norm_inf)
    Y = Y.numpy()
    assert np.allclose(Y.T @ Y, np.eye(k), atol=1e-12)
    true = np.linalg.norm(dense @ Y - Y * theta, axis=0)
    assert np.allclose(true, est, rtol=1e-6, atol=1e-10 * ref.norm_inf)


def test_plain_lanczos_ground_state_against_a_dense_eigensolve():
    ref = regular_stencil.build(CONFIG, "cpu")
    dense = ref.apply(torch.eye(N**3, dtype=torch.float64)).numpy()
    assert np.allclose(dense, dense.T, atol=1e-9)
    v0 = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, N**3))
    theta, _, _ = lanczos.solve(ref.apply, v0, {"k": 1, "n": 300, "which": "SA"})
    assert abs(theta[0] - np.linalg.eigvalsh(dense)[0]) < 1e-9 * ref.norm_inf
