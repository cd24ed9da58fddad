"""The paper's restructured 3-stage softmax (Sec. IV-B), plain PyTorch.

Original hls4ml form (k^2 exponent evaluations):
    S_i = ( sum_j exp(z_j - z_i) )^-1
Paper's restructured form (k evaluations):
    S_i = exp(z_i) * ( sum_j exp(z_j) )^-1
in three stages: exp, sum + inversion, multiply.  The LUT form has no max
subtraction: the fixed-point score domain is bounded and inputs saturate at
the table's edges.  The kernel version is ``kernels/lut_softmax``.
"""

from __future__ import annotations

import torch

from repro_torch.core import lut


def softmax_paper_exact(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    e = torch.exp(x)
    return e * (1.0 / torch.sum(e, dim=dim, keepdim=True))


def softmax_lut(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    e = lut.lut_exp(x)  # stage 1: exp LUT
    s = torch.sum(e, dim=dim, keepdim=True)
    return e * lut.lut_inv(s)  # stages 2-3: inversion LUT, multiply


def softmax_legacy_hls4ml(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The original hls4ml softmax the paper replaced: k^2 exponent terms,
    ``S_i = (sum_j exp(z_j - z_i))^-1``.  The baseline of the k-versus-k^2
    operation count."""
    if dim != -1:
        raise NotImplementedError("legacy softmax only supports dim=-1")
    diff = x.unsqueeze(-2) - x.unsqueeze(-1)  # [..., i, j]
    return 1.0 / torch.sum(torch.exp(diff), dim=-1)


def softmax_safe(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Float-path softmax with max subtraction."""
    return torch.softmax(x, dim=dim)


def softmax(x: torch.Tensor, dim: int = -1, mode: str = "safe") -> torch.Tensor:
    """``mode``: safe (max-subtracted) | paper | lut | legacy."""
    if mode == "safe":
        return softmax_safe(x, dim)
    if mode == "paper":
        return softmax_paper_exact(x, dim)
    if mode == "lut":
        return softmax_lut(x, dim)
    if mode == "legacy":
        return softmax_legacy_hls4ml(x, dim)
    raise ValueError(f"unknown softmax mode: {mode}")


def op_count(k: int, mode: str) -> int:
    """Exponent evaluations per row: the paper's k versus k^2 argument."""
    return k * k if mode == "legacy" else k
