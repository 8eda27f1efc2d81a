from .api import eigsh
from .lanczos import LanczosFactorization, lanczos, lanczos_kernel
from .results import EigResult, match_eigs
from .tridiag import (
    cullum_willoughby_mask,
    ritz_from_factorization,
    tridiag_eigh,
    tridiag_to_dense,
)
from .arnoldi import ArnoldiFactorization, arnoldi, eigs_nonsym
from .two_sided import (
    TwoSidedFactorization,
    nonsymmetric_tridiag_eig,
    two_sided_eigs,
    two_sided_lanczos,
)
