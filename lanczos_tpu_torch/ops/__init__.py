from .operators import (
    DenseOperator,
    EllOperator,
    LinearOperator,
    StencilOperator,
    as_operator,
    make_stencil_operator,
)
from .assemble import ell_from_coo, ell_from_scipy, stencil_to_ell
from .composite2 import CompositeV2, build_composite_v2, ell_tail
from .interface_kernel import (
    FusedInterface,
    InterfacePlan,
    apply_fused_interface,
    apply_fused_interface_reference,
    plan_interface_kernel,
)
