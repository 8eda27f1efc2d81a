"""lanczos_tpu_torch — the Lanczos eigensolver on PyTorch, with hand-written
CUDA kernels for the NVIDIA H100 (sm_90a).

The port of ``lanczos_tpu`` (JAX/Pallas on a TPU), which stays beside it as
the reference that every module here is tested against.  This package holds
these paths:

* the regular grid: potentials -> regular-grid Hamiltonian -> matrix-free
  stencil operator (CUDA stencil SpMV/SpMM kernels) -> ``eigsh`` (Lanczos
  with full reorthogonalization -> tridiagonal eigh, Ritz vectors and
  acceptance);
* ``eigsh_restarted``: thick-restart Lanczos in a bounded basis, with
  cycle checkpoints (``utils/checkpoint.py``) and the ``compensated``
  reductions (``ops/compensated.py``);
* block Lanczos (``eigsh(block_size > 1)``, ``eigsh_block_restarted``):
  (M, b) blocks through the stencil SpMM kernel, resolving degenerate
  multiplets up to b;
* the double-word refinement (``solver/refine.py`` on ``ops/dd.py``), which
  takes float32 pairs to 1e-8 residuals (the north-star path,
  ``scripts/northstar_torch.py``);
* the irregular multi-resolution lattice: ``build_lattice`` -> least-squares
  Laplacian rows -> ``assemble_irregular_hamiltonian_composite2`` (the
  CompositeV2 operator: per-level stencil kernels plus the CUDA fused
  interface kernel) or the padded-ELL assembly -> ``eigs_nonsym``
  (Krylov–Schur) or, in float64, ``two_sided_lanczos``/``two_sided_eigs``
  and the look-ahead form that cures serious breakdowns
  (``two_sided_lanczos_lookahead``/``lookahead_eigs``);
* operator I/O and the Mathematica export (``utils/io.py``), and the
  flagship SpMV benchmark (``utils/bench_impl.py``), both also CLI
  subcommands (``export-matrix``, ``bench``);
* the v1 ``CompositeOperator`` (``assemble_irregular_hamiltonian_composite``:
  per-level box stacks with halo faces, plain PyTorch);
* row-sharded execution on ``torch.distributed`` (``parallel/``: NCCL on
  cards, gloo on the CPU): the z-slab stencil, sharded ELL and halo ELL,
  ``lanczos_sharded``, the sharded CompositeV2 and v1 composite, with
  ``eigsh_restarted`` and ``eigs_nonsym`` running on them, and the
  exchange and matvec metrics (``utils/metrics.py``).

Constructors and builders allocate on ``"cuda"`` unless given ``device=``.
It imports ``torch`` and never ``jax``.

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
from .solver.restart import eigsh_restarted  # noqa: E402
from .solver.block import eigsh_block_restarted  # noqa: E402
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
from .models.lattice import IrregularLattice, build_lattice, potential_spacings  # noqa: E402
from .models.irrlap import laplacian_weights  # noqa: E402
from .models.irr_hamiltonian import (  # noqa: E402
    assemble_irregular_hamiltonian,
    assemble_irregular_hamiltonian_composite,
    assemble_irregular_hamiltonian_composite2,
)
from .ops.composite import CompositeOperator  # noqa: E402
from .ops.composite2 import CompositeV2  # noqa: E402
from .solver.arnoldi import arnoldi, eigs_nonsym  # noqa: E402
from .solver.two_sided import two_sided_eigs, two_sided_lanczos  # noqa: E402
from .solver.look_ahead import lookahead_eigs, two_sided_lanczos_lookahead  # noqa: E402
from .models.potentials import (  # noqa: E402
    DEUTERON_REDUCED_REST_ENERGY_MEV,
    HBAR_C_MEV_FM,
    deuteron_potential_3d,
    deuteron_potential_radial,
    kinetic_prefactor,
    square_well_1d,
)

__version__ = "0.1.0"
