from repro_torch.kernels.layernorm.ops import layernorm
from repro_torch.kernels.layernorm.ref import layernorm_ref

__all__ = ["layernorm", "layernorm_ref"]
