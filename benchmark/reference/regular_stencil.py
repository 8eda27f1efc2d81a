"""The plain reference of the regular grid: ``H = -T + V`` in float64 with
plain PyTorch operations (27 rolls of the periodic grid).

It imports nothing of the program and takes nothing the program made."""

import itertools

import numpy as np
import torch

from .potential import deuteron_3d, kinetic_prefactor
from .precision import tf32

def _stencil27():
    """[(offset (dz, dy, dx), Laplacian weight)]: centre -44/3, face 1, edge
    1/2, corner 1/3, all times 3/13 (Hamiltonian.py:48-69)."""
    out = []
    for off in itertools.product((-1, 0, 1), repeat=3):
        nz = sum(o != 0 for o in off)
        w = {0: -44.0 / 3.0, 1: 1.0, 2: 0.5, 3: 1.0 / 3.0}[nz]
        out.append((off, w * 3.0 / 13.0))
    return out


class Reference:
    def __init__(self, config, device):
        if config["stencil"] != "27":
            raise ValueError("the reference has the 27-point stencil only")
        n, length = config["n"], config["length"]
        self.n, self.m, self.device = n, n ** 3, torch.device(device)
        t = kinetic_prefactor(length / n)
        self.taps = [(off, -t * w) for off, w in _stencil27()]
        c = np.linspace(-length / 2, length / 2, n)
        z, y, x = np.meshgrid(c, c, c, indexing="ij")
        diag = deuteron_3d(x, y, z)
        self.diag = torch.from_numpy(diag).to(self.device)
        self.norm_inf = float(sum(abs(w) for _, w in self.taps) + np.abs(diag).max())

    def apply(self, X, control=False):
        """H X for X of shape (N^3,) or (N^3, c), float64, on the device;
        ``control``: every operand of a product rounded to TF32."""
        n = self.n
        rnd = tf32 if control else (lambda t: t)
        x = rnd(X).reshape((n, n, n) + tuple(X.shape[1:]))
        d = rnd(self.diag).reshape((n, n, n) + (1,) * (X.dim() - 1))
        y = d * x
        for (dz, dy, dx), w in self.taps:
            w = float(rnd(torch.tensor(w, dtype=torch.float64))) if control else w
            y += w * torch.roll(x, shifts=(-dz, -dy, -dx), dims=(0, 1, 2))
        return y.reshape(X.shape)


def build(config, device):
    return Reference(config, device)
