from .operators import (
    DenseOperator,
    EllOperator,
    LinearOperator,
    RowShardedOperator,
    StencilOperator,
    as_operator,
    make_stencil_operator,
)
from .assemble import ell_from_coo, ell_from_scipy, stencil_to_ell
from .composite import (
    CompositeOperator,
    ShardedComposite,
    ShardedCompositeOperator,
    build_composite,
    shard_composite,
)
from .composite2 import CompositeV2, build_composite_v2, ell_tail
from .interface_kernel import (
    FusedInterface,
    InterfacePlan,
    apply_fused_interface,
    apply_fused_interface_reference,
    plan_interface_kernel,
)
from .compensated import dd_sum_tree, dot2, dot2_rounded, norm2, two_prod, two_sum
from .dd import dd_split_scalar, matmat_dd, matvec_dd, to_float64
