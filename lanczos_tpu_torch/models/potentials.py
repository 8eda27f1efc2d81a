"""Physical constants and potential library on tensors.

Counterpart of ``lanczos_tpu/models/potentials.py``: the same constants and
the same deuteron potential (the reference's golden values), computed with
PyTorch ops on whatever device and dtype the coordinates carry.
"""

from __future__ import annotations

import dataclasses

import torch

from .._util import DEFAULT_DEVICE

__all__ = [
    "HBAR_C_MEV_FM",
    "DEUTERON_REDUCED_REST_ENERGY_MEV",
    "kinetic_prefactor",
    "deuteron_potential_3d",
    "deuteron_potential_radial",
    "square_well_1d",
    "DeuteronParams",
]

#: hbar * c in MeV * fm.
HBAR_C_MEV_FM = 197.327

#: Reduced rest energy of the two-nucleon system in MeV/c^2.
DEUTERON_REDUCED_REST_ENERGY_MEV = 469.4592


def kinetic_prefactor(dx: float, rest_energy: float = DEUTERON_REDUCED_REST_ENERGY_MEV):
    """T_factor = (hbar c)^2 / (2 m c^2) / dx^2  [MeV]."""
    return HBAR_C_MEV_FM**2 / (2.0 * rest_energy) / dx**2


@dataclasses.dataclass(frozen=True)
class DeuteronParams:
    """Core/well parameters of the model deuteron potential."""

    e_wells: float = 65.4823128982115
    e_well: float = 54.531
    core_scale: float = 40.0
    r_core: float = 1.0 / 4
    r_well: float = 17.0 / 10
    f_pow: float = 4.0

    @property
    def e_cores(self) -> float:
        return self.core_scale * self.e_well


_DEFAULT = DeuteronParams()


def deuteron_potential_radial(r, params: DeuteronParams = _DEFAULT) -> torch.Tensor:
    """V(r) = eCores exp(-(r/rCore)^4) - eWells exp(-(r/rWell)^4)  [MeV].

    ``r`` is a tensor (kept on its device and dtype) or an array-like.
    """
    r = torch.as_tensor(r)
    return params.e_cores * torch.exp(-((r / params.r_core) ** params.f_pow)) - (
        params.e_wells * torch.exp(-((r / params.r_well) ** params.f_pow))
    )


def deuteron_potential_3d(x, y, z, params: DeuteronParams = _DEFAULT) -> torch.Tensor:
    """3D deuteron potential centered at the origin."""
    r = torch.sqrt(torch.as_tensor(x) ** 2 + torch.as_tensor(y) ** 2 + torch.as_tensor(z) ** 2)
    return deuteron_potential_radial(r, params)


def square_well_1d(
    n: int, depth: float = -10.0, *, dtype=torch.float32, device=DEFAULT_DEVICE
) -> torch.Tensor:
    """The 1D particle-in-a-box well: V = depth on the middle half, 0 outside."""
    v = torch.zeros(n, dtype=dtype, device=device)
    v[n // 4 : (3 * n) // 4] = depth
    return v
