"""Public entry point of the staged LayerNorm kernel.

On a CPU tensor it runs the plain version (``ref.layernorm_ref``); on a
CUDA tensor it launches ``csrc/layernorm.cu`` or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import lut
from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.layernorm.ref import layernorm_ref


@functools.lru_cache(maxsize=None)
def _lib():
    fn = build.library("layernorm").repro_layernorm
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
        + [ctypes.c_void_p]
    )
    return fn


def layernorm(
    x: torch.Tensor,  # (..., K)
    gamma: torch.Tensor,  # (K,)
    beta: torch.Tensor | None = None,  # (K,); None or ignored for RMSNorm
    *,
    use_lut: bool = False,
    rms: bool = False,
    eps: float = 1e-5,
) -> torch.Tensor:
    k = x.shape[-1]
    if gamma.shape != (k,) or (beta is not None and beta.shape != (k,)):
        raise ValueError(f"gamma/beta must be ({k},), got {tuple(gamma.shape)}, "
                         f"{None if beta is None else tuple(beta.shape)}")
    if x.device.type == "cpu":
        return layernorm_ref(x, gamma, beta, use_lut=use_lut, rms=rms, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm runs on cpu or cuda, got {x.device}")

    if beta is None:
        if not rms:
            raise ValueError("LayerNorm needs beta")
        beta = gamma  # not read by the RMS kernel
    for name, t in (("x", x), ("gamma", gamma), ("beta", beta)):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"layernorm kernel needs contiguous float32 {name} on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    rows = x.numel() // k
    out = torch.empty_like(x)
    tab = lut.rsqrt_table(x.device)
    tab_off, tab_step = lut.index_constants(lut.RSQRT_SPEC)
    err = _lib()(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), tab.data_ptr(), out.data_ptr(),
        rows, k, int(rms), int(use_lut), eps, tab_off, tab_step,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "layernorm")
    LAUNCHES["layernorm"] += 1
    return out
