from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_attention.ref import attention_ref, mha_ref

__all__ = ["mha", "attention_ref", "mha_ref"]
