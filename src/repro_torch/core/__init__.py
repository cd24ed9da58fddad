"""The paper's numerics in PyTorch: ap_fixed (``fixed_point``), int8
(``quant``), lookup tables (``lut``), per-layer precision policies
(``precision``), the reuse-factor block plan (``reuse``), the 3-stage
softmax (``softmax``) and the staged LayerNorm (``layernorm``).  The 4-stage
streaming MHA (``streaming_mha``) imports the kernels; import it by name."""

from repro_torch.core import (  # noqa: F401
    fixed_point,
    layernorm,
    lut,
    precision,
    quant,
    reuse,
    softmax,
)
