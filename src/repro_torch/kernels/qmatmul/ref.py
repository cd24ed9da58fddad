"""Plain PyTorch version of the int8 GEMM kernel."""

from __future__ import annotations

import torch

# A product of two int8 codes is at most 2^14 in magnitude, so an int32 sum
# of K of them is exact while K < 2^17; float64 holds such sums exactly too.
MAX_K = 2 ** 31 // 2 ** 14


def int_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of two integer code matrices.

    ``torch.mm`` on two int8 tensors returns int8 and wraps, so the CPU
    upcasts to int32 first.  The card has no integer ``torch.matmul``; there
    the product is taken in float64, which is exact for these sums, and
    converted back."""
    if x.device.type == "cpu":
        return torch.mm(x.to(torch.int32), w.to(torch.int32))
    return torch.mm(x.to(torch.float64), w.to(torch.float64)).to(torch.int32)


def qmatmul_ref(
    x: torch.Tensor,  # (M, K) int8
    w: torch.Tensor,  # (K, N) int8
    x_scale: torch.Tensor,  # (M, 1) float32
    w_scale: torch.Tensor,  # (1, N) float32
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    if x.shape[1] >= MAX_K:
        raise ValueError(f"K = {x.shape[1]} overflows the int32 accumulator (K must be < {MAX_K})")
    acc = int_matmul(x, w)
    # the reference's order: the scale product first, then one multiply
    return (acc.to(torch.float32) * (x_scale * w_scale)).to(out_dtype)
