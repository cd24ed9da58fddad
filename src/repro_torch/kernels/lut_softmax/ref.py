"""Plain PyTorch versions of the LUT softmax kernel: the table gather and
the float oracle it approximates."""

from __future__ import annotations

import torch

from repro_torch.core import lut


def lut_softmax_ref(x: torch.Tensor) -> torch.Tensor:
    """The same tables and indices as the kernel, read by a gather."""
    e = lut.lut_exp(x.to(torch.float32))
    s = torch.sum(e, dim=-1, keepdim=True)
    return (e * lut.lut_inv(s)).to(x.dtype)


def softmax_exact_ref(x: torch.Tensor) -> torch.Tensor:
    """Float oracle (what the LUT approximates)."""
    return torch.softmax(x.to(torch.float32), dim=-1).to(x.dtype)
