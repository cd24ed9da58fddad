"""GQA/MHA attention in ``train`` mode (a whole sequence, no KV cache),
through the fused attention kernel.

Prefill, extend and decode over a KV cache, and MLA, come with the LM slice
(ROADMAP queue 1, item 4, and item 9 for MLA).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import mha
from repro_torch.models import layers


def gqa_spec(cfg: ModelConfig, dtype=torch.float32):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": layers.dense_spec(d, h * hd, axes=("embed", "heads"), bias=cfg.attn_bias, dtype=dtype),
        "wk": layers.dense_spec(d, hkv * hd, axes=("embed", "kv_heads"), bias=cfg.attn_bias, dtype=dtype),
        "wv": layers.dense_spec(d, hkv * hd, axes=("embed", "kv_heads"), bias=cfg.attn_bias, dtype=dtype),
        "wo": layers.dense_spec(h * hd, d, axes=("heads", "embed"), bias=cfg.attn_bias, dtype=dtype),
    }


def attention_spec(cfg: ModelConfig, dtype=torch.float32):
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"attn_kind {cfg.attn_kind!r} is not ported yet (ROADMAP queue 1, item 9)"
        )
    return gqa_spec(cfg, dtype)


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim).transpose(1, 2).contiguous()


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def gqa_apply(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor | None = None,  # (S,); used by RoPE, not ported yet
    *,
    mode: str = "train",
    cache=None,
    kernel: dict | None = None,
    quant=None,  # per-layer runtime hook from the precision plan
):
    """Returns (out, cache) like the reference; only ``mode="train"``."""
    if mode != "train" or cache is not None:
        raise NotImplementedError(
            f"gqa_apply mode={mode!r} with a KV cache is not ported yet "
            "(ROADMAP queue 1, item 4: LM forward, prefill and decode)"
        )
    if cfg.use_rope:
        raise NotImplementedError("RoPE is not ported yet (ROADMAP queue 1, item 4)")
    kernel = kernel or {}
    qc = cfg.quant if quant is None else quant
    hd = cfg.resolved_head_dim
    q = _split_heads(layers.dense(params["wq"], x, qc), cfg.n_heads, hd)
    k = _split_heads(layers.dense(params["wk"], x, qc), cfg.n_kv_heads, hd)
    v = _split_heads(layers.dense(params["wv"], x, qc), cfg.n_kv_heads, hd)
    out = mha(
        q, k, v,
        causal=not cfg.is_encoder,
        window=cfg.sliding_window,
        mode=kernel.get("softmax_mode", "safe"),
    )
    return layers.dense(params["wo"], _merge_heads(out), qc), cache


def attention_apply(params, cfg, x, positions=None, **kw):
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"attn_kind {cfg.attn_kind!r} is not ported yet (ROADMAP queue 1, item 9)"
        )
    return gqa_apply(params, cfg, x, positions, **kw)
