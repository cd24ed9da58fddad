"""Plain PyTorch version of the staged LayerNorm kernel."""

from __future__ import annotations

import torch

from repro_torch.core import layernorm as ln_core


def layernorm_ref(
    x: torch.Tensor,  # (..., K)
    gamma: torch.Tensor,  # (K,)
    beta: torch.Tensor | None = None,  # (K,); unused for RMSNorm
    *,
    use_lut: bool = False,
    rms: bool = False,
    eps: float = 1e-5,
) -> torch.Tensor:
    xf = x.float()
    if rms:
        out = ln_core.rmsnorm(xf, gamma.reshape(-1), eps=eps, use_lut=use_lut)
    else:
        if beta is None:
            beta = torch.zeros_like(gamma)
        out = ln_core.layernorm_paper(
            xf, gamma.reshape(-1), beta.reshape(-1), eps=eps, use_lut=use_lut
        )
    return out.to(x.dtype)
