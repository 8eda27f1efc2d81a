"""Plain float64 Lanczos with full reorthogonalization (classical
Gram-Schmidt, two passes against every earlier vector) from a given start
vector, over a reference operator's ``apply``: the plain counterpart of
the program's ``eigsh`` with its default full reorthogonalization.

It imports nothing of the program and takes nothing the program made: the
start vector is the benchmark's own draw, handed to both sides."""

import numpy as np
import torch

from .precision import tf32


def solve(apply, v0, kwargs, control=False):
    """The traffic's ``k`` smallest Ritz pairs ("SA"), ascending, of ``n``
    Lanczos steps from ``v0``: (theta, a (k,) numpy array; Y, an (M, k)
    float64 tensor of unit columns; the residual estimates beta_n |s_n,i|).

    ``control``: every product's operands rounded to TF32, the operator's
    (``apply(x, control=True)``), the reorthogonalization's and the Ritz
    rotation's, with the basis stored rounded."""
    k, steps = int(kwargs["k"]), int(kwargs["n"])
    if kwargs.get("which", "SA") != "SA":
        raise ValueError("the plain Lanczos selects the smallest pairs ('SA') only")
    rnd = tf32 if control else (lambda t: t)
    m = v0.shape[0]
    V = torch.empty((steps, m), dtype=torch.float64, device=v0.device)
    alpha = torch.empty(steps, dtype=torch.float64, device=v0.device)
    beta = torch.empty(steps, dtype=torch.float64, device=v0.device)
    V[0] = rnd(v0 / torch.linalg.vector_norm(v0))
    for j in range(steps):
        w = apply(V[j], control)
        alpha[j] = torch.dot(V[j], rnd(w))
        for _ in range(2):
            w -= rnd(V[:j + 1] @ rnd(w)) @ V[:j + 1]
        beta[j] = torch.linalg.vector_norm(w)
        if j + 1 < steps:
            V[j + 1] = rnd(w / beta[j])
    a, b = alpha.cpu().numpy(), beta.cpu().numpy()
    theta, S = np.linalg.eigh(np.diag(a) + np.diag(b[:-1], 1) + np.diag(b[:-1], -1))
    Y = V.T @ rnd(torch.from_numpy(S[:, :k]).to(V.device))
    del V
    return theta[:k], Y / torch.linalg.vector_norm(Y, dim=0), b[-1] * np.abs(S[-1, :k])
