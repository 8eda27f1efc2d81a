from .api import eigsh
from .restart import eigsh_restarted
from .block import (
    BlockLanczosFactorization,
    block_lanczos,
    block_ritz,
    eigsh_block_restarted,
)
from .refine import (
    refine_eigenpairs_dd,
    refine_eigenpairs_dd_hosted,
    refine_eigenpairs_dd_nonsym,
    refine_eigenpairs_fp64_host,
)
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
from .look_ahead import (
    LookAheadFactorization,
    lookahead_eigs,
    two_sided_lanczos_lookahead,
)
