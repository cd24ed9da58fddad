"""Plain PyTorch version of the staged LayerNorm kernel."""

from __future__ import annotations

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core import layernorm as ln_core


def snap_output(out: torch.Tensor, precision) -> torch.Tensor:
    """Emit on an ap_fixed grid when a fixed output precision is given (the
    staged norm feeds a fixed-point datapath); a torch op after the kernel,
    as in the JAX package."""
    if precision is None or getattr(precision, "kind", None) != "fixed":
        return out
    return fxp.quantize(out, precision.fixed_cfg())


def layernorm_ref(
    x: torch.Tensor,  # (..., K), float32, bfloat16 or float16
    gamma: torch.Tensor,  # (K,)
    beta: torch.Tensor | None = None,  # (K,); None = zeros; unused for RMSNorm
    *,
    use_lut: bool = False,
    rms: bool = False,
    eps: float = 1e-5,
    precision=None,  # core.precision.Precision (fixed): output grid
) -> torch.Tensor:
    """Computes in float32 and returns ``x.dtype``, as the kernel does."""
    xf = x.float()
    if rms:
        out = ln_core.rmsnorm(xf, gamma.reshape(-1).float(), eps=eps, use_lut=use_lut)
    else:
        beta = torch.zeros_like(gamma) if beta is None else beta
        out = ln_core.layernorm_paper(
            xf, gamma.reshape(-1).float(), beta.reshape(-1).float(), eps=eps, use_lut=use_lut
        )
    return snap_output(out.to(x.dtype), precision)
