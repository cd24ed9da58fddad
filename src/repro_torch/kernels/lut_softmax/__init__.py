from repro_torch.kernels.lut_softmax.ops import lut_softmax
from repro_torch.kernels.lut_softmax.ref import lut_softmax_ref, softmax_exact_ref

__all__ = ["lut_softmax", "lut_softmax_ref", "softmax_exact_ref"]
