"""Row-sharded execution on ``torch.distributed`` (counterpart of
``lanczos_tpu/parallel``): the row mesh and its collectives, the sharded
stencil, ELL and halo-ELL operators, sharded Lanczos and the sharded
CompositeV2.  ``python -m lanczos_tpu_torch.parallel.dryrun N`` runs the
whole set on N ranks."""

from .mesh import ROWS, RowMesh, initialize_distributed, make_row_mesh
from .distributed import (
    EllHaloOperator,
    ShardedEllOperator,
    ShardedStencilOperator,
    lanczos_sharded,
    shard_ell_halo,
    shard_operator,
)
from .composite2 import ShardedCompositeV2, plan_composite_v2, shard_composite_v2
