"""Pre-norm residual transformer blocks (the dense kind).

MoE and Mamba blocks come with ROADMAP queue 1, items 9 and 10.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, mlp


def block_kind(cfg: ModelConfig) -> str:
    if cfg.family in ("ssm", "hybrid"):
        return "mamba"
    if cfg.moe is not None:
        return "moe"
    return "dense"


def _require_dense(cfg: ModelConfig) -> None:
    kind = block_kind(cfg)
    if kind != "dense":
        raise NotImplementedError(
            f"{kind} blocks are not ported yet (ROADMAP queue 1, "
            f"item {9 if kind == 'moe' else 10})"
        )


def block_spec(cfg: ModelConfig, dtype=torch.float32):
    _require_dense(cfg)
    return {
        "ln1": layers.norm_spec(cfg.d_model, cfg.norm_kind, dtype),
        "attn": attention.attention_spec(cfg, dtype),
        "ln2": layers.norm_spec(cfg.d_model, cfg.norm_kind, dtype),
        "ffn": mlp.mlp_spec(cfg, dtype),
    }


def block_apply(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor | None = None,
    *,
    mode: str = "train",
    cache=None,
    kernel: dict | None = None,
    quant=None,  # per-layer runtime hook from the precision plan
):
    """Returns (x, new_cache, aux) like the reference."""
    _require_dense(cfg)
    rs = cfg.residual_scale
    norm_lut = (kernel or {}).get("norm_lut", False)
    h = layers.norm(params["ln1"], x, cfg.norm_kind, cfg.norm_eps, use_lut=norm_lut)
    attn_out, new_cache = attention.attention_apply(
        params["attn"], cfg, h, positions, mode=mode, cache=cache,
        kernel=kernel, quant=quant,
    )
    x = x + rs * attn_out
    h = layers.norm(params["ln2"], x, cfg.norm_kind, cfg.norm_eps, use_lut=norm_lut)
    x = x + rs * mlp.mlp_apply(params["ffn"], cfg, h, quant=quant)
    return x, new_cache, {}
