"""Stacked model-level caches (port of the model-level part of
``repro.serve.kv_cache``), for the ``ssm`` family only.

Each layer's Mamba2 cache (``ssm_state`` (b, h, p, n) and ``conv_state``
(b, width - 1, conv_dim)) is float32 whatever the model's type, stacked on a
leading layer axis: ``{"layers": {name: (n_layers, ...)}}``.  Attention KV
caches (dense and paged) wait for ROADMAP queue 1, items 4 and 6.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import ssm


def _per_layer_cache_spec(cfg: ModelConfig, batch: int):
    if cfg.family == "ssm":
        return ssm.mamba_cache_spec(cfg, batch, torch.float32)
    if cfg.family == "hybrid":
        raise NotImplementedError(
            "hybrid caches (Mamba2 + shared-attention KV) are not ported yet "
            "(ROADMAP queue 1, item 4)"
        )
    raise NotImplementedError(
        f"{cfg.family} KV caches are not ported yet (ROADMAP queue 1, items 4 and 6)"
    )


def abstract_caches(cfg: ModelConfig, batch: int) -> dict:
    """{"layers": {name: (shape, dtype)}}, shapes with the leading layer axis.
    The reference's ``max_len`` and ``dtype`` size and type attention caches
    only, which are not ported; the SSM caches are float32 of a fixed size."""
    per_layer = _per_layer_cache_spec(cfg, batch)
    return {"layers": {k: ((cfg.n_layers,) + shape, dt) for k, (shape, dt) in per_layer.items()}}


def init_caches(cfg: ModelConfig, batch: int, *, device: str | torch.device = "cuda") -> dict:
    """Zero caches for ``abstract_caches`` on ``device``."""
    dev = resolve_device(device)
    spec = abstract_caches(cfg, batch)
    return {"layers": {k: torch.zeros(shape, dtype=dt, device=dev)
                       for k, (shape, dt) in spec["layers"].items()}}
