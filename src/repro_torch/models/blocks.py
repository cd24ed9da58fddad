"""Pre-norm residual blocks: the dense transformer kind, the MoE kind (the
dense kind with ``moe.moe_apply`` as its feed-forward, whose router aux
comes back with the block) and the Mamba2 kind (the ``ssm`` and ``hybrid``
families), and the hybrid family's Zamba2-style shared attention block
(``shared_attn_*``), which ``models.lm`` applies before the Mamba2 block of
every ``attn_every``-th layer.  Under a model group every kind splits as
``distributed.tensor_parallel`` describes; the shared block's attention
and MLP split as the dense kind's, its ``out_proj`` row-parallel.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.models import attention, layers, mlp, moe, ssm
from repro_torch.serve import kv_cache


def block_kind(cfg: ModelConfig) -> str:
    if cfg.family in ("ssm", "hybrid"):
        return "mamba"
    if cfg.moe is not None:
        return "moe"
    return "dense"


def block_spec(cfg: ModelConfig, dtype=torch.float32):
    kind = block_kind(cfg)
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
    group=None,  # tensor_parallel.ModelGroup: every kind splits over it
    data=None,  # tensor_parallel.DataGroup: the MoE kind runs the whole batch's layer
):
    """Returns (x, new_cache, aux) like the reference."""
    kind = block_kind(cfg)
    rs = cfg.residual_scale
    norm_lut = (kernel or {}).get("norm_lut", False)
    h = layers.norm(params["ln1"], x, cfg.norm_kind, cfg.norm_eps, use_lut=norm_lut)
    if kind == "mamba":
        out, new_cache = ssm.mamba_apply(
            params["mamba"], cfg, h, mode=mode, cache=cache, quant=quant, group=group
        )
        return x + rs * out, new_cache, {}
    attn_out, new_cache = attention.attention_apply(
        params["attn"], cfg, h, positions, mode=mode, cache=cache,
        kernel=kernel, quant=quant, group=group,
    )
    x = x + rs * attn_out
    h = layers.norm(params["ln2"], x, cfg.norm_kind, cfg.norm_eps, use_lut=norm_lut)
    aux = {}
    if kind == "moe":
        ffn_out, aux = moe.moe_apply(params["ffn"], cfg, h, group=group, data=data)
    else:
        ffn_out = mlp.mlp_apply(params["ffn"], cfg, h, quant=quant, group=group)
    return x + rs * ffn_out, new_cache, aux


# ---------------------------------------------------------------------------
# Zamba2-style shared attention block (hybrid family)
# ---------------------------------------------------------------------------


def _shared_width(cfg: ModelConfig) -> int:
    return 2 * cfg.d_model if cfg.hybrid.concat_residual else cfg.d_model


def shared_attn_cfg(cfg: ModelConfig) -> ModelConfig:
    """The shared block's attention config: it attends in the
    concat(x, x_embed) space (width 2 d_model) and projects back to d."""
    return dataclasses.replace(cfg, attn_kind="gqa", head_dim=_shared_width(cfg) // cfg.n_heads,
                               sliding_window=None, ssm=None)


def shared_attn_spec(cfg: ModelConfig, dtype=torch.float32):
    """One transformer block (attention and MLP) at width W = 2 d_model
    over concat(x, x_embed), then a W -> d projection.  Its weights are
    shared by every application; each application has its own KV cache."""
    acfg = shared_attn_cfg(cfg)
    w, hd = _shared_width(cfg), acfg.resolved_head_dim
    return {
        "ln1": layers.norm_spec(w, cfg.norm_kind, dtype),
        "attn": {
            "wq": layers.dense_spec(w, cfg.n_heads * hd, axes=("embed", "heads"), dtype=dtype),
            "wk": layers.dense_spec(w, cfg.n_kv_heads * hd, axes=("embed", "kv_heads"),
                                    dtype=dtype),
            "wv": layers.dense_spec(w, cfg.n_kv_heads * hd, axes=("embed", "kv_heads"),
                                    dtype=dtype),
            "wo": layers.dense_spec(cfg.n_heads * hd, w, axes=("heads", "embed"), dtype=dtype),
        },
        "ln2": layers.norm_spec(w, cfg.norm_kind, dtype),
        "mlp": mlp.mlp_spec(dataclasses.replace(acfg, d_model=w), dtype),
        "out_proj": layers.dense_spec(w, cfg.d_model, axes=("mlp", "embed"), dtype=dtype),
    }


def shared_attn_cache_spec(cfg: ModelConfig, batch: int, max_len: int,
                           dtype: torch.dtype = torch.bfloat16) -> dict:
    """One application's KV cache, always dense and never int8: the hybrid
    family is not position-addressed end to end, so no paged layout."""
    return kv_cache.attention_cache_spec(shared_attn_cfg(cfg), batch, max_len, dtype)


def shared_attn_apply(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    x_embed: torch.Tensor,
    positions: torch.Tensor | None = None,
    *,
    mode: str = "train",
    cache=None,
    kernel: dict | None = None,
    quant=None,  # the precision plan's shared-block hook
    group=None,  # tensor_parallel.ModelGroup
):
    """Returns (x + residual_scale * out_proj(block(concat(x, x_embed))),
    cache); a prefill or decode writes its k/v rows into ``cache`` in place,
    as ``attention.gqa_apply``.  Under ``group`` the attention and the MLP
    split as the dense block's, and ``out_proj``, whose rows the layout
    splits, takes this rank's columns of its input and reduces."""
    acfg = shared_attn_cfg(cfg)
    qc = cfg.quant if quant is None else quant
    norm_lut = (kernel or {}).get("norm_lut", False)
    h = torch.cat([x, x_embed], dim=-1) if cfg.hybrid.concat_residual else x
    a = layers.norm(params["ln1"], h, cfg.norm_kind, cfg.norm_eps, use_lut=norm_lut)
    a, new_cache = attention.gqa_apply(params["attn"], acfg, a, positions, mode=mode,
                                       cache=cache, kernel=kernel, quant=quant, group=group)
    h = h + a
    m = layers.norm(params["ln2"], h, cfg.norm_kind, cfg.norm_eps, use_lut=norm_lut)
    h = h + mlp.mlp_apply(params["mlp"], dataclasses.replace(acfg, d_model=2 * cfg.d_model), m,
                          quant=quant, group=group)
    tp = tp_lib.active(group)
    if tp is not None and tp.layout.shared_out:
        lo, hi = tp_lib.shard_range(h.shape[-1], tp)
        out = layers.row_parallel_dense(params["out_proj"],
                                        tp_lib.enter(h, tp).narrow(-1, lo, hi - lo), tp, qc)
    else:
        out = layers.dense(params["out_proj"], h, qc)
    return x + cfg.residual_scale * out, new_cache
