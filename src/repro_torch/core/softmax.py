"""The paper's restructured 3-stage softmax (Sec. IV-B), plain PyTorch.

``S_i = exp(z_i) * (sum_j exp(z_j))^-1`` in three stages: exp, sum +
inversion, multiply.  The LUT form has no max subtraction: the fixed-point
score domain is bounded and inputs saturate at the table's edges.
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


def softmax(x: torch.Tensor, dim: int = -1, mode: str = "safe") -> torch.Tensor:
    """``mode``: safe (max-subtracted) | paper | lut."""
    if mode == "safe":
        return torch.softmax(x, dim=dim)
    if mode == "paper":
        return softmax_paper_exact(x, dim)
    if mode == "lut":
        return softmax_lut(x, dim)
    raise ValueError(f"unknown softmax mode: {mode}")
