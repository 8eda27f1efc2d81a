from .api import eigsh
from .lanczos import LanczosFactorization, lanczos, lanczos_kernel
from .results import EigResult, match_eigs
from .tridiag import (
    cullum_willoughby_mask,
    ritz_from_factorization,
    tridiag_eigh,
    tridiag_to_dense,
)
