from .checkpoint import (
    lanczos_checkpointed,
    load_restart_state,
    load_state,
    save_restart_state,
    save_state,
)
from .io import save_eigpairs
