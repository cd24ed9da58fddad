"""The paper's numerics in PyTorch: ap_fixed (``fixed_point``), int8
(``quant``), lookup tables (``lut``), per-layer precision policies
(``precision``), the 3-stage softmax (``softmax``) and the staged LayerNorm
(``layernorm``)."""

from repro_torch.core import (  # noqa: F401
    fixed_point,
    layernorm,
    lut,
    precision,
    quant,
    softmax,
)
