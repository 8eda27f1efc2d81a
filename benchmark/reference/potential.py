"""The deuteron model potential and the kinetic prefactor in float64 numpy,
as the reference code's 3Ddeuteron.py and Irr3Ddeuteron.py define them."""

import numpy as np

HBAR_C_MEV_FM = 197.327
REDUCED_REST_ENERGY_MEV = 469.4592
E_WELLS = 65.4823128982115
E_CORES = 40.0 * 54.531
R_CORE = 0.25
R_WELL = 1.7


def kinetic_prefactor(dx):
    """(hbar c)^2 / (2 m c^2) / dx^2 in MeV."""
    return HBAR_C_MEV_FM ** 2 / (2.0 * REDUCED_REST_ENERGY_MEV) / dx ** 2


def deuteron_3d(x, y, z):
    """V(r) = eCores exp(-(r/rCore)^4) - eWells exp(-(r/rWell)^4), r = |(x, y, z)|."""
    r = np.sqrt(np.asarray(x, dtype=np.float64) ** 2 + np.asarray(y) ** 2 + np.asarray(z) ** 2)
    return E_CORES * np.exp(-((r / R_CORE) ** 4)) - E_WELLS * np.exp(-((r / R_WELL) ** 4))
