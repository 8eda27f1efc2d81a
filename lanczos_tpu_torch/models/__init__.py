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
from .lattice import (
    IrregularLattice,
    build_lattice,
    find_neighbors,
    mirror_symmetric_filter,
    potential_spacings,
)
from .irrlap import WeightCache, laplacian_weights, laplacian_weights_batch
from .irr_hamiltonian import (
    assemble_irregular_hamiltonian,
    assemble_irregular_hamiltonian_composite,
    assemble_irregular_hamiltonian_composite2,
    irregular_laplacian_rows,
)
