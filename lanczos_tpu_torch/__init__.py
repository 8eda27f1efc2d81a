"""lanczos_tpu_torch — the Lanczos eigensolver on PyTorch, with hand-written
CUDA kernels for the NVIDIA H100 (sm_90a).

The port of ``lanczos_tpu`` (JAX/Pallas on a TPU), which stays beside it as
the reference that every module here is tested against.  This package holds
the regular-grid ``eigsh`` path: potentials -> regular-grid Hamiltonian ->
matrix-free stencil operator (CUDA stencil SpMV/SpMM kernels) -> Lanczos
with full reorthogonalization -> tridiagonal eigh, Ritz vectors and
acceptance.  It imports ``torch`` and never ``jax``.

Importing it turns TF32 off for matmuls and cuDNN: a TF32 product keeps
about three decimal digits and quietly degrades Krylov orthogonality (the
counterpart of the JAX package's ``Precision.HIGHEST``).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .ops.operators import (  # noqa: E402
    DenseOperator,
    EllOperator,
    LinearOperator,
    StencilOperator,
    as_operator,
)
from .ops.assemble import ell_from_coo, ell_from_scipy  # noqa: E402
from .solver.api import eigsh  # noqa: E402
from .solver.lanczos import LanczosFactorization, lanczos  # noqa: E402
from .solver.results import EigResult, match_eigs  # noqa: E402
from .solver.tridiag import (  # noqa: E402
    cullum_willoughby_mask,
    ritz_from_factorization,
    tridiag_eigh,
)
from .models.grids import (  # noqa: E402
    RegularGrid,
    build_chain_hamiltonian_1d,
    build_regular_hamiltonian,
    laplacian_stencil,
)
from .models.potentials import (  # noqa: E402
    DEUTERON_REDUCED_REST_ENERGY_MEV,
    HBAR_C_MEV_FM,
    deuteron_potential_3d,
    deuteron_potential_radial,
    kinetic_prefactor,
    square_well_1d,
)

__version__ = "0.1.0"
