"""The paper's numerics in PyTorch: ap_fixed (``fixed_point``), int8
(``quant``), lookup tables (``lut``), per-layer precision policies
(``precision``), the reuse-factor block plan (``reuse``), the 3-stage
softmax (``softmax``), the staged LayerNorm (``layernorm``) and the FPGA
cycle model and H100 roofline (``latency_model``).  The 4-stage
streaming MHA (``streaming_mha``) imports the kernels; import it by name."""

from repro_torch.core import (  # noqa: F401
    fixed_point,
    latency_model,
    layernorm,
    lut,
    precision,
    quant,
    reuse,
    softmax,
)
