"""Cache specs and stacked model-level caches (port of the spec and
model-level part of ``repro.serve.kv_cache``), dense layout.

Per layer:
- dense GQA: ``k`` and ``v`` slabs (B, Hkv, L, D) in the cache dtype;
- a sliding window shorter than ``max_len``: a rolling buffer of length
  ``window`` plus ``slot_pos`` (B, window) int32, the global position held
  in each slot (-1 = empty);
- the ``ssm`` family's Mamba2 cache (``ssm_state`` (b, h, p, n) and
  ``conv_state`` (b, width - 1, conv_dim)), float32 of a fixed size whatever
  the model's type.
Stacked on a leading layer axis: ``{"layers": {name: (n_layers, ...)}}``.

Not ported yet: the paged layout and ``CacheManager`` (ROADMAP queue 1,
item 6), int8 KV and MLA latent caches (item 9), hybrid caches (item 10).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import ssm

LAYOUTS = ("dense", "paged")


def attention_cache_spec(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype = torch.bfloat16,
    quantized: bool = False,
    layout: str = "dense",
    page_size: int | None = None,
    num_pages: int | None = None,
) -> dict:
    """Per-layer attention cache ``{name: (shape, dtype)}``; stacked by the
    caller."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown kv layout {layout!r}; use one of {LAYOUTS}")
    if layout == "paged":
        raise NotImplementedError("the paged KV layout is not ported yet (ROADMAP queue 1, item 6)")
    if cfg.attn_kind == "none":
        return {}
    if cfg.attn_kind == "mla":
        raise NotImplementedError("MLA latent caches are not ported yet (ROADMAP queue 1, item 9)")
    if quantized:
        raise NotImplementedError("the int8 KV cache is not ported yet (ROADMAP queue 1, item 9)")
    length, extra = max_len, {}
    if cfg.sliding_window is not None and cfg.sliding_window < max_len:
        length = cfg.sliding_window
        extra["slot_pos"] = ((batch, length), torch.int32)
    kv = ((batch, cfg.n_kv_heads, length, cfg.resolved_head_dim), dtype)
    return {"k": kv, "v": kv, **extra}


def _zero_leaf(shape: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if dtype == torch.int32:  # slot positions: -1 marks an empty slot
        return torch.full(shape, -1, dtype=dtype, device=device)
    return torch.zeros(shape, dtype=dtype, device=device)


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int,
                         dtype: torch.dtype = torch.bfloat16, *,
                         device: str | torch.device = "cuda", **kw) -> dict:
    dev = resolve_device(device)
    spec = attention_cache_spec(cfg, batch, max_len, dtype, **kw)
    return {k: _zero_leaf(shape, dt, dev) for k, (shape, dt) in spec.items()}


def _per_layer_cache_spec(cfg: ModelConfig, batch: int, max_len: int, dtype, quantized,
                          **layout_kw):
    if cfg.family == "hybrid":
        raise NotImplementedError(
            "hybrid caches (Mamba2 + shared-attention KV) are not ported yet "
            "(ROADMAP queue 1, item 10)"
        )
    if cfg.family == "ssm":
        return ssm.mamba_cache_spec(cfg, batch, torch.float32)
    return attention_cache_spec(cfg, batch, max_len, dtype, quantized=quantized, **layout_kw)


def abstract_caches(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype = torch.bfloat16,
    quantized: bool = False,
    layout: str = "dense",
    page_size: int | None = None,
    num_pages: int | None = None,
) -> dict:
    """{"layers": {name: (shape, dtype)}}, shapes with the leading layer
    axis.  ``max_len`` and ``dtype`` size and type the attention caches; the
    SSM caches are float32 of a fixed size."""
    per_layer = _per_layer_cache_spec(cfg, batch, max_len, dtype, quantized, layout=layout,
                                      page_size=page_size, num_pages=num_pages)
    return {"layers": {k: ((cfg.n_layers,) + shape, dt) for k, (shape, dt) in per_layer.items()}}


def init_caches(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype = torch.bfloat16,
    quantized: bool = False,
    *,
    device: str | torch.device = "cuda",
    **layout_kw,
) -> dict:
    """Empty caches for ``abstract_caches`` on ``device``: zeros, and -1 in
    the int32 slot positions."""
    dev = resolve_device(device)
    spec = abstract_caches(cfg, batch, max_len, dtype, quantized, **layout_kw)
    return {"layers": {k: _zero_leaf(shape, dt, dev)
                       for k, (shape, dt) in spec["layers"].items()}}
