"""Public attention entry point: ``mha`` over (B, H, L, D) tensors.

On a CPU tensor it runs the plain version (``ref.mha_ref``); on a CUDA
tensor it launches the hand-written kernel (``csrc/flash_attention.cu``) or
raises.  GQA is mapped by head index inside the kernel.  Every head_dim runs
on the tensor cores, float32 as 3xTF32 on mma.sync:
- 8, 16 and 32: one warp per 16 query rows, heads packed into blocks, K/V
  staged once per head and block by cp.async (bf16 on mma.sync too); any
  contiguous q, k, v (4- or 2-byte copies when one is not 16-byte aligned);
- 64 and 128: 64 query rows per block, bf16 on wgmma, K/V tiles copied by
  TMA, which needs 16-byte aligned q, k, v.
Any other head_dim up to 128 is zero-padded to the next of those (zeros add
nothing to q.k and give zero output columns, which are sliced off), with the
scale kept at 1/sqrt(true head_dim).  Under grad mode, with any of q, k, v
requiring grad, the launch goes through ``autograd.Attention`` (the kernel
forward, a backward in torch ops).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core import lut
from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.flash_attention import autograd
from repro_torch.kernels.flash_attention.ref import mha_ref

HEAD_DIMS = (8, 16, 32, 64, 128)  # all on the tensor cores
TMA_DIMS = (64, 128)  # K/V by TMA: q, k, v must be 16-byte aligned
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"safe": 0, "lut": 1}


@functools.lru_cache(maxsize=None)
def _lib():
    fn = build.library("flash_attention").repro_flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_float] * 5
        + [ctypes.c_void_p]
    )
    return fn


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple:
    """Device pointers of the exp and 1/x tables (kept alive by ``lut``'s own
    cache) and their index constants: looked up once per device, not per call."""
    exp_tab, inv_tab = lut.exp_table(device), lut.inv_table(device)
    return (exp_tab.data_ptr(), inv_tab.data_ptr(), *lut.index_constants(lut.EXP_SPEC),
            *lut.index_constants(lut.INV_SPEC))


def padded_head_dim(d: int) -> int:
    """The head_dim the kernel runs for a true head_dim ``d``: the smallest
    of ``HEAD_DIMS`` that holds it."""
    for hd in HEAD_DIMS:
        if hd >= d:
            return hd
    raise ValueError(f"head_dim {d} is above the kernel's largest, {HEAD_DIMS[-1]}")


def mha(
    q: torch.Tensor,  # (B, Hq, Lq, D)
    k: torch.Tensor,  # (B, Hkv, Lkv, D)
    v: torch.Tensor,  # (B, Hkv, Lkv, D)
    *,
    causal: bool = False,
    window: int | None = None,
    mode: str = "safe",
    kv_len: int | None = None,  # true (unpadded) kv length; keys past it are masked
) -> torch.Tensor:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"mha wants q (B,Hq,Lq,D), k = v (B,Hkv,Lkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, lq, d = q.shape
    _, hkv, lkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hq % hkv != 0:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k/v {tuple(k.shape)}")
    if mode not in _MODES:
        raise ValueError(f"unknown softmax mode {mode!r}")
    kv_len = lkv if kv_len is None else kv_len
    if not 1 <= kv_len <= lkv or (window is not None and window < 1):
        raise ValueError(f"need 1 <= kv_len <= {lkv} and window >= 1")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v on different devices: {devices}")
    if q.device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window, mode=mode, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"mha runs on cpu or cuda, got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return autograd.attention(q, k, v, causal=causal, window=window, mode=mode,
                                  kv_len=kv_len, forward=_kernel)
    return _kernel(q, k, v, causal=causal, window=window, mode=mode, kv_len=kv_len)


def _kernel(q, k, v, *, causal, window, mode, kv_len):
    """One launch of the kernel on CUDA tensors (validated by ``mha``)."""
    b, hq, lq, d = q.shape
    _, hkv, lkv, _ = k.shape
    dk = padded_head_dim(d)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share float32 or bfloat16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("mha kernel needs contiguous q, k, v")
    if dk != d:  # fresh, contiguous and aligned
        q, k, v = (F.pad(t, (0, dk - d)) for t in (q, k, v))
    if dk in TMA_DIMS and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("mha kernel at head_dim 64/128 needs 16-byte aligned q, k, v (TMA)")
    out = torch.empty_like(q)
    exp_ptr, inv_ptr, exp_off, exp_step, inv_off, inv_step = _tables(q.device)
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), exp_ptr, inv_ptr,
        b, hq, hkv, lq, lkv, dk, kv_len, int(causal),
        0 if window is None else window, _MODES[mode], _DTYPES[q.dtype],
        1.0 / (d ** 0.5), exp_off, exp_step, inv_off, inv_step,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out if dk == d else out[..., :d].contiguous()
