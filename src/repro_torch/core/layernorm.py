"""The paper's 5-stage LayerNorm (Sec. IV-C), plain PyTorch.

Stages: (1) mean, (2) deviation from the mean, (3) variance, (4) 1/sqrt via
``rsqrt(var + eps)`` or the 1/sqrt LUT (no eps), (5) gamma * x_hat + beta.
RMSNorm shares stages 3-5 with the mean fixed at zero.  The CUDA kernel in
``kernels/layernorm`` computes the same; these are its plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.core import lut


def layernorm_paper(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-5,
    use_lut: bool = False,
) -> torch.Tensor:
    k = x.shape[-1]
    mean = torch.sum(x, dim=-1, keepdim=True) / k  # stage 1
    dm = x - mean  # stage 2
    var = torch.sum(dm * dm, dim=-1, keepdim=True) / k  # stage 3
    inv_std = lut.lut_rsqrt(var) if use_lut else torch.rsqrt(var + eps)  # stage 4
    return dm * inv_std * gamma + beta  # stage 5


def rmsnorm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    *,
    eps: float = 1e-6,
    use_lut: bool = False,
) -> torch.Tensor:
    k = x.shape[-1]
    ms = torch.sum(x * x, dim=-1, keepdim=True) / k
    inv_rms = lut.lut_rsqrt(ms) if use_lut else torch.rsqrt(ms + eps)
    return x * inv_rms * gamma


def norm(
    x: torch.Tensor,
    params: dict,
    *,
    kind: str = "layernorm",
    eps: float = 1e-5,
    use_lut: bool = False,
) -> torch.Tensor:
    """Framework entry point; ``params`` holds 'scale' (+ 'bias' for LN)."""
    if kind == "layernorm":
        return layernorm_paper(x, params["scale"], params["bias"], eps=eps, use_lut=use_lut)
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"], eps=eps, use_lut=use_lut)
    if kind == "none":
        return x
    raise ValueError(f"unknown norm kind: {kind}")
