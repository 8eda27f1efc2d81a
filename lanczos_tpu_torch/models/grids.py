"""Regular-grid geometry, Laplacian stencils, and Hamiltonian assembly.

Counterpart of ``lanczos_tpu/models/grids.py``.  ``H = -T + V`` is a
matrix-free StencilOperator: the Laplacian stencil plus a diagonal
potential, evaluated once on the target device.

Stencil weights are the reference's golden values:
  7-point:  center -6, faces 1
  27-point: center -44/3, face 1, edge 1/2, corner 1/3, all scaled by 3/13
Index convention: flat = x + y*N + z*N^2 (x fastest), periodic boundaries.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .._util import DEFAULT_DEVICE, as_torch_dtype, to_numpy
from ..ops.assemble import ell_from_coo
from ..ops.operators import EllOperator, StencilOperator, make_stencil_operator
from .potentials import DEUTERON_REDUCED_REST_ENERGY_MEV, kinetic_prefactor

__all__ = [
    "laplacian_stencil",
    "RegularGrid",
    "build_regular_hamiltonian",
    "build_chain_hamiltonian_1d",
]


def laplacian_stencil(ndim: int, points: str = "auto"):
    """Return (offsets, weights) for the discrete Laplacian (unit spacing).

    points:
      "3"  (1D), "5" (2D), "7" (3D): the (2*ndim+1)-point second-order star.
      "27" (3D only): the reference's 27-point isotropic stencil.
      "auto": star stencil for the given ndim.
    """
    if points == "auto":
        points = str(2 * ndim + 1)

    if points in ("3", "5", "7"):
        if int(points) != 2 * ndim + 1:
            raise ValueError(
                f"{points}-point stencil is for {(int(points) - 1) // 2}D, got ndim={ndim}"
            )
        offsets = [tuple([0] * ndim)]
        weights = [-2.0 * ndim]
        for ax in range(ndim):
            for s in (-1, 1):
                off = [0] * ndim
                off[ax] = s
                offsets.append(tuple(off))
                weights.append(1.0)
        return tuple(offsets), np.asarray(weights)

    if points == "27":
        if ndim != 3:
            raise ValueError("27-point stencil is 3D")
        offsets = []
        weights = []
        for off in itertools.product((-1, 0, 1), repeat=3):
            nz = sum(o != 0 for o in off)
            if nz == 0:
                w = -44.0 / 3.0  # center
            elif nz == 3:
                w = 1.0 / 3.0  # corner
            elif nz > 1:
                w = 1.0 / 2.0  # edge
            else:
                w = 1.0  # face
            offsets.append(off)
            weights.append(w * 3.0 / 13.0)  # overall scale
        return tuple(offsets), np.asarray(weights)

    raise ValueError(f"unknown stencil: {points!r}")


@dataclasses.dataclass(frozen=True)
class RegularGrid:
    """Uniform periodic grid on [-L/2, L/2]^d with N points per axis.

    Coordinates are ``linspace(-L/2, L/2, N)`` (so their spacing is
    L/(N-1)) while the kinetic prefactor uses dx = L/N, both as the
    reference does, to reproduce its spectra.
    """

    n: int
    length: float
    ndim: int = 3

    @property
    def num_points(self) -> int:
        return self.n**self.ndim

    @property
    def dx(self) -> float:
        return float(self.length) / self.n

    @property
    def shape(self) -> Tuple[int, ...]:
        # slow -> fast: (Nz, Ny, Nx); flat index = x + y*N + z*N^2.
        return (self.n,) * self.ndim

    def axis_coords(self) -> np.ndarray:
        return np.linspace(-self.length / 2, self.length / 2, self.n)

    def coordinate_grids(self):
        """Meshgrid of physical coordinates, shaped like ``self.shape``;
        returns (x_grid, y_grid, z_grid, ...) with x varying along the last
        (fastest) axis."""
        c = self.axis_coords()
        grids = np.meshgrid(*([c] * self.ndim), indexing="ij")
        return tuple(grids[::-1])


def build_regular_hamiltonian(
    n: int,
    length: float,
    potential: Optional[Callable] = None,
    *,
    ndim: int = 3,
    stencil: str = "auto",
    rest_energy: float = DEUTERON_REDUCED_REST_ENERGY_MEV,
    t_factor: Optional[float] = None,
    dtype=torch.float32,
    device=DEFAULT_DEVICE,
) -> StencilOperator:
    """H = -T + V as a matrix-free StencilOperator on ``device``.

    T = t_factor * Laplacian-stencil (t_factor defaults to the physical
    kinetic prefactor); V is ``potential`` (a function of coordinate
    tensors, e.g. :func:`deuteron_potential_3d`) evaluated once on
    ``device`` in ``dtype``.  ``potential=None`` gives the pure (negated,
    scaled) Laplacian.
    """
    dtype = as_torch_dtype(dtype)
    grid = RegularGrid(n=n, length=length, ndim=ndim)
    offsets, lap_weights = laplacian_stencil(ndim, stencil)
    if t_factor is None:
        t_factor = kinetic_prefactor(grid.dx, rest_energy)
    weights = -t_factor * lap_weights  # H = -T + V

    diag = None
    if potential is not None:
        coords = tuple(
            torch.as_tensor(g, dtype=dtype, device=device)
            for g in grid.coordinate_grids()
        )
        diag = potential(*coords).reshape(-1).to(dtype)

    return make_stencil_operator(
        grid.shape, offsets, weights, diag=diag, dtype=dtype, device=device
    )


def build_chain_hamiltonian_1d(
    n: int,
    length: float,
    potential_values: Sequence[float],
    *,
    rest_energy: float = DEUTERON_REDUCED_REST_ENERGY_MEV,
    t_factor: Optional[float] = None,
    dtype=torch.float64,
    device=DEFAULT_DEVICE,
) -> EllOperator:
    """The reference's exact non-periodic 1D radial Hamiltonian as ELL.

    Reproduces the reference's quirks, taken as golden behaviour: the end
    rows of T are [-1, 1] (Neumann-like), and the potential diagonal omits
    the last grid point.
    """
    if t_factor is None:
        t_factor = kinetic_prefactor(float(length) / n, rest_energy)
    v = np.asarray(to_numpy(potential_values), dtype=np.float64)
    if v.shape != (n,):
        raise ValueError(f"potential_values has shape {v.shape}, expected ({n},)")

    # -T part (H = -T + V): interior rows [-1, 2, -1], end rows [1, -1].
    i = np.arange(1, n - 1)
    rows = np.concatenate([[0, 0, n - 1, n - 1], i, i, i, np.arange(n - 1)])
    cols = np.concatenate([[0, 1, n - 2, n - 1], i - 1, i, i + 1, np.arange(n - 1)])
    vals = np.concatenate([
        t_factor * np.array([1.0, -1.0, -1.0, 1.0]),
        np.full(n - 2, -t_factor), np.full(n - 2, 2 * t_factor),
        np.full(n - 2, -t_factor),
        v[: n - 1],  # +V part, diagonal over the first n-1 points
    ])
    return ell_from_coo(rows, cols, vals, n, dtype=dtype, device=device)
