"""Plain PyTorch version of the fused attention kernel (and of the JAX
reference's ``kernels/flash_attention/ref.py`` + the ``mha`` GQA repeat)."""

from __future__ import annotations

import torch

from repro_torch.core import lut
from repro_torch.roofline.op_counter import attnvol

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (..., Lq, D)
    k: torch.Tensor,  # (..., Lkv, D)
    v: torch.Tensor,  # (..., Lkv, D)
    *,
    scale: float,
    causal: bool = False,
    window: int | None = None,
    mode: str = "safe",
    kv_len: int | None = None,
) -> torch.Tensor:
    qf, kf, vf = (t.float() for t in (q, k, v))
    # ``attnvol``: the O(L^2) attention volume, which a roofline count
    # re-prices as the fused kernel (the reference's named_scope)
    with attnvol:
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        lq, lkv = s.shape[-2], s.shape[-1]
        kv_len = lkv if kv_len is None else kv_len
        q_pos = torch.arange(lq, device=s.device)[:, None]
        k_pos = torch.arange(lkv, device=s.device)[None, :]
        mask = k_pos < kv_len
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & (q_pos - k_pos < window)
        if mode == "safe":
            p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
        elif mode == "lut":  # the paper's LUT softmax; masked keys weigh zero
            e = torch.where(mask, lut.lut_exp(s), 0.0)
            p = e * lut.lut_inv(torch.sum(e, dim=-1, keepdim=True))
        else:
            raise ValueError(f"unknown softmax mode {mode!r}")
        out = torch.matmul(p, vf)
    return out.to(q.dtype)


def mha_ref(
    q: torch.Tensor,  # (B, Hq, Lq, D)
    k: torch.Tensor,  # (B, Hkv, Lkv, D)
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    mode: str = "safe",
    kv_len: int | None = None,
) -> torch.Tensor:
    """Plain GQA attention: K/V heads repeated across query-head groups."""
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=1)
        v = torch.repeat_interleave(v, group, dim=1)
    return attention_ref(
        q, k, v, scale=1.0 / (q.shape[-1] ** 0.5), causal=causal, window=window,
        mode=mode, kv_len=kv_len,
    )
