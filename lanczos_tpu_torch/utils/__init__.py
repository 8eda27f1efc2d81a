from .checkpoint import (
    lanczos_checkpointed,
    load_restart_state,
    load_state,
    save_restart_state,
    save_state,
)
from .io import (
    cached_ell,
    export_mathematica,
    load_ell,
    save_eigpairs,
    save_ell,
)
from .metrics import (
    MatvecStats,
    benchmark_matvec,
    exchange_stats,
    operator_nnz,
    profile_trace,
)
