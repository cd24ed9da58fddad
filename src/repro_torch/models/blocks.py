"""Pre-norm residual blocks: the dense transformer kind, the MoE kind (the
dense kind with ``moe.moe_apply`` as its feed-forward, whose router aux
comes back with the block) and the Mamba2 kind (``ssm`` family).

The hybrid family (Mamba2 with the shared attention block) comes with
ROADMAP queue 1, item 10.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, mlp, moe, ssm


def block_kind(cfg: ModelConfig) -> str:
    if cfg.family in ("ssm", "hybrid"):
        return "mamba"
    if cfg.moe is not None:
        return "moe"
    return "dense"


def _require_ported(cfg: ModelConfig) -> str:
    kind = block_kind(cfg)
    if cfg.family == "hybrid":
        raise NotImplementedError(
            "hybrid blocks (Mamba2 + shared attention) are not ported yet "
            "(ROADMAP queue 1, item 10)"
        )
    return kind


def block_spec(cfg: ModelConfig, dtype=torch.float32):
    kind = _require_ported(cfg)
    if kind == "mamba":
        return {
            "ln1": layers.norm_spec(cfg.d_model, cfg.norm_kind, dtype),
            "mamba": ssm.mamba_spec(cfg, dtype),
        }
    return {
        "ln1": layers.norm_spec(cfg.d_model, cfg.norm_kind, dtype),
        "attn": attention.attention_spec(cfg, dtype),
        "ln2": layers.norm_spec(cfg.d_model, cfg.norm_kind, dtype),
        "ffn": moe.moe_spec(cfg, dtype) if kind == "moe" else mlp.mlp_spec(cfg, dtype),
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
    kind = _require_ported(cfg)
    rs = cfg.residual_scale
    norm_lut = (kernel or {}).get("norm_lut", False)
    h = layers.norm(params["ln1"], x, cfg.norm_kind, cfg.norm_eps, use_lut=norm_lut)
    if kind == "mamba":
        out, new_cache = ssm.mamba_apply(
            params["mamba"], cfg, h, mode=mode, cache=cache, quant=quant
        )
        return x + rs * out, new_cache, {}
    attn_out, new_cache = attention.attention_apply(
        params["attn"], cfg, h, positions, mode=mode, cache=cache,
        kernel=kernel, quant=quant,
    )
    x = x + rs * attn_out
    h = layers.norm(params["ln2"], x, cfg.norm_kind, cfg.norm_eps, use_lut=norm_lut)
    aux = {}
    if kind == "moe":
        ffn_out, aux = moe.moe_apply(params["ffn"], cfg, h)
    else:
        ffn_out = mlp.mlp_apply(params["ffn"], cfg, h, quant=quant)
    return x + rs * ffn_out, new_cache, aux
