"""Feed-forward layers: standard and gated (GLU) MLPs; under a model group
``w_up`` / ``w_gate`` column-parallel and ``w_down`` row-parallel."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.models import layers


def mlp_spec(cfg: ModelConfig, dtype=torch.float32, d_ff: int | None = None):
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff
    spec = {
        "w_up": layers.dense_spec(d, ff, axes=("embed", "mlp"), bias=cfg.mlp_bias, dtype=dtype),
        "w_down": layers.dense_spec(ff, d, axes=("mlp", "embed"), bias=cfg.mlp_bias, dtype=dtype),
    }
    if cfg.gated_mlp:
        spec["w_gate"] = layers.dense_spec(
            d, ff, axes=("embed", "mlp"), bias=cfg.mlp_bias, dtype=dtype
        )
    return spec


def mlp_apply(params, cfg: ModelConfig, x: torch.Tensor, quant=None, group=None) -> torch.Tensor:
    """With ``group`` (``tensor_parallel``) whose layout splits the ``mlp``
    columns (the leaves this rank's shards), the two projections run on
    this rank's columns and the down projection's partial sums are
    reduced."""
    qc = cfg.quant if quant is None else quant
    tp = tp_lib.active(group)
    if tp is not None and tp.layout.mlp:
        x = tp_lib.enter(x, tp)
    else:
        tp = None
    up = layers.dense(params["w_up"], x, qc)
    if cfg.gated_mlp:
        h = layers.activation(layers.dense(params["w_gate"], x, qc), cfg.act) * up
    else:
        h = layers.activation(up, cfg.act)
    if tp is not None:
        return layers.row_parallel_dense(params["w_down"], h, tp, qc)
    return layers.dense(params["w_down"], h, qc)
