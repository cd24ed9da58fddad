"""Gradients through the attention kernel.

The kernel (``csrc/flash_attention.cu``) writes its output through a raw
pointer, so autograd cannot see through it.  ``Attention`` is a
``torch.autograd.Function`` whose forward is that kernel, unchanged (or any
function of the same signature: the tests inject the plain version), and
whose backward is the attention gradient written as torch ops from its
formula.  The JAX package has no backward kernel either: it trains through
the plain jnp ``attention_ref``, and its gradient is XLA's autodiff of that,
which :func:`attention_backward` reproduces:

- ``safe``: P = softmax(S) over the unmasked keys, S = Q Kᵀ / √D;
  dV = Pᵀ dO, dS = P ⊙ (dO Vᵀ − δ) with δ = rowsum(dO ⊙ O), zero where
  masked; dQ = dS K / √D, dK = dSᵀ Q / √D;
- ``lut``: the exp and 1/x table lookups pick an entry by rounding, so they
  carry no gradient: dQ = dK = 0, and dV = Pᵀ dO with P the LUT
  probabilities, as ``jax.grad`` of the reference gives.

GQA: the query heads of one kv head are stacked along the rows, (B, Hkv,
G·Lq, D), so the products with Q and dS sum dK and dV over the group without
repeating K and V.  V, the output and its cotangent may have their own
head_dim Dv (MLA); the scale is Q's, 1/√D.  The masks (causal, window,
``kv_len`` padding) are the plain version's.  Inputs of any head_dim come
in unpadded: the kernel's zero-padding happens inside the forward and the
gradients come out at the true head_dim.  The backward builds the full (G·Lq, Lkv) score matrix per
(batch, kv head) in float32; it does not call the plain forward ``mha_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.core import lut
from repro_torch.kernels.flash_attention.ref import NEG_INF


def _mask(lq: int, lkv: int, *, causal: bool, window: int | None, kv_len: int,
          device) -> torch.Tensor:
    """(Lq, Lkv) bool: the keys each query attends to, as ``attention_ref``."""
    q_pos = torch.arange(lq, device=device)[:, None]
    k_pos = torch.arange(lkv, device=device)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    return mask.expand(lq, lkv)


def attention_backward(
    q: torch.Tensor,  # (B, Hq, Lq, D)
    k: torch.Tensor,  # (B, Hkv, Lkv, D)
    v: torch.Tensor,  # (B, Hkv, Lkv, Dv)
    out: torch.Tensor,  # (B, Hq, Lq, Dv): the forward's output
    dout: torch.Tensor,  # (B, Hq, Lq, Dv)
    *,
    causal: bool = False,
    window: int | None = None,
    mode: str = "safe",
    kv_len: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) of ``mha`` at (q, k, v) for the output cotangent
    ``dout``, each in its input's dtype, computed in float32."""
    b, hq, lq, d = q.shape
    hkv, lkv, d_v = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    kv_len = lkv if kv_len is None else kv_len
    mask = _mask(lq, lkv, causal=causal, window=window, kv_len=kv_len,
                 device=q.device).repeat(g, 1)  # (G·Lq, Lkv)
    qg = q.float().reshape(b, hkv, g * lq, d)
    kf, vf = k.float(), v.float()
    dog = dout.float().reshape(b, hkv, g * lq, d_v)
    s = torch.matmul(qg, kf.transpose(-1, -2)) * scale
    if mode == "safe":
        p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    elif mode == "lut":
        e = torch.where(mask, lut.lut_exp(s), 0.0)
        p = e * lut.lut_inv(torch.sum(e, dim=-1, keepdim=True))
    else:
        raise ValueError(f"unknown softmax mode {mode!r}")
    del s
    dv = torch.matmul(p.transpose(-1, -2), dog)
    if mode == "lut":  # the table lookups carry no gradient
        return torch.zeros_like(q), torch.zeros_like(k), dv.to(v.dtype)
    delta = torch.sum(dog * out.float().reshape(b, hkv, g * lq, d_v), dim=-1, keepdim=True)
    ds = torch.matmul(dog, vf.transpose(-1, -2))
    ds = torch.where(mask, p * (ds - delta), 0.0)
    del p
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qg) * scale
    return dq.reshape(b, hq, lq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class Attention(torch.autograd.Function):
    """``forward(q, k, v, causal=, window=, mode=, kv_len=)`` computes the
    output (the CUDA kernel in ``ops.mha``); the backward is
    :func:`attention_backward` on the saved q, k, v and output."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, mode, kv_len, forward):
        out = forward(q, k, v, causal=causal, window=window, mode=mode, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out)
        ctx.opts = dict(causal=causal, window=window, mode=mode, kv_len=kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, dout, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def attention(q, k, v, *, causal=False, window=None, mode="safe", kv_len=None, forward):
    """``forward``'s attention with the gradient of :class:`Attention`."""
    return Attention.apply(q, k, v, causal, window, mode, kv_len, forward)
