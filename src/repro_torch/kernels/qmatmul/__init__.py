from repro_torch.kernels.qmatmul.ops import qmatmul, qmatmul_int8, qmatmul_prequantized
from repro_torch.kernels.qmatmul.ref import qmatmul_ref

__all__ = ["qmatmul", "qmatmul_int8", "qmatmul_prequantized", "qmatmul_ref"]
