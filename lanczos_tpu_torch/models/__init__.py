from .grids import (
    RegularGrid,
    build_chain_hamiltonian_1d,
    build_regular_hamiltonian,
    laplacian_stencil,
)
from .potentials import (
    DeuteronParams,
    deuteron_potential_3d,
    deuteron_potential_radial,
    kinetic_prefactor,
    square_well_1d,
)
