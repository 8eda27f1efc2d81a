from .operators import (
    DenseOperator,
    EllOperator,
    LinearOperator,
    StencilOperator,
    as_operator,
    make_stencil_operator,
)
from .assemble import ell_from_coo, ell_from_scipy, stencil_to_ell
