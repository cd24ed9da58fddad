from repro_torch.kernels.qmatmul.ops import (
    ROUTES,
    qmatmul,
    qmatmul_int8,
    qmatmul_prequantized,
    route,
)
from repro_torch.kernels.qmatmul.ref import qmatmul_ref

__all__ = ["ROUTES", "qmatmul", "qmatmul_int8", "qmatmul_prequantized", "qmatmul_ref", "route"]
