"""The paper's three benchmark models (Sec. V / Table I), served on a batch
of events.

  engine_anomaly : seq 50 x 1,  3 blocks, d=16,  2-class softmax, no norm
  btagging       : seq 15 x 6,  3 blocks, d=64,  3-class softmax
  gw             : seq 100 x 2, 2 blocks, d=32,  1-logit sigmoid

Input projection -> learned positional embedding -> N blocks (kernel
attention + MLP, pre-norm residual, kernel LayerNorm) -> final norm -> mean
pool -> two dense head layers.  Precision comes from ``cfg.precision`` as in
the JAX package; parameters are transformed offline with
``core.precision.apply_plan_to_params``.  ``loss_fn`` is the training
loss: a stable binary cross entropy on one logit, else the log-softmax
cross entropy, with the accuracy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.core import precision as precision_lib
from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.models import params as params_lib
from repro_torch.models.params import ArraySpec


def param_spec(cfg: ModelConfig, dtype=torch.float32):
    d = cfg.d_model
    spec = {
        "input_proj": layers.dense_spec(
            cfg.input_vec_size, d, axes=(None, "embed"), bias=True, dtype=dtype
        ),
        "pos_embed": ArraySpec((cfg.seq_len, d), dtype, (None, "embed"), "normal", init_scale=0.02),
        "blocks": params_lib.stack_spec(blocks.block_spec(cfg, dtype), cfg.n_layers),
        "head1": layers.dense_spec(d, d, axes=("embed", "mlp"), bias=True, dtype=dtype),
        "head2": layers.dense_spec(d, cfg.n_classes, axes=("mlp", None), bias=True, dtype=dtype),
    }
    if cfg.norm_kind != "none":
        spec["final_norm"] = layers.norm_spec(d, cfg.norm_kind, dtype)
    return spec


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    *,
    dtype=torch.float32,
    device: str | torch.device = "cuda",
):
    return params_lib.init_params(param_spec(cfg, dtype), generator, device)


def forward(
    params,
    cfg: ModelConfig,
    x,
    *,
    kernel: dict | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """x: (batch, seq_len, input_vec_size) tensor or array -> logits
    (batch, n_classes) on ``device``."""
    dev = resolve_device(device)
    params_lib.check_on(params, dev)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    x = x.to(dev)
    with trace.span("physics.forward", batch=x.shape[0]):
        plan = precision_lib.resolve_model_plan(cfg)
        kernel = plan.kernel_defaults(kernel)
        h = layers.dense(params["input_proj"], x, plan.embed_quant())
        h = h + params["pos_embed"]

        uniform_quant = plan.uniform_layer_quant()
        layer_quants = None if uniform_quant is not None else plan.layer_quant_arrays()
        for i in range(cfg.n_layers):  # the reference's scan over the stacked blocks
            bparams = params_lib.map_leaves(lambda _, t: t[i], params["blocks"])
            quant = uniform_quant if layer_quants is None else layer_quants.layer(i)
            h, _, _ = blocks.block_apply(bparams, cfg, h, mode="train", kernel=kernel, quant=quant)
        if cfg.norm_kind != "none":
            h = layers.norm(
                params["final_norm"], h, cfg.norm_kind, cfg.norm_eps,
                use_lut=(kernel or {}).get("norm_lut", False),
            )
        h = torch.mean(h, dim=1)  # pool over time
        qc_head = plan.logits_quant()
        h = torch.relu(layers.dense(params["head1"], h, qc_head))
        return layers.dense(params["head2"], h, qc_head)


def predict_proba(params, cfg: ModelConfig, x, **kw) -> torch.Tensor:
    """Probability of the positive class / per-class probabilities."""
    logits = forward(params, cfg, x, **kw)
    if cfg.n_classes == 1:
        return torch.sigmoid(logits[..., 0])
    return torch.softmax(logits, dim=-1)


def loss_fn(params, cfg: ModelConfig, batch: dict, **kw):
    """(loss, {"loss", "accuracy"}) of ``batch`` {"x", "y"} (tensors or
    arrays; y holds int labels), as the reference's."""
    logits = forward(params, cfg, batch["x"], **kw)
    y = batch["y"]
    y = (torch.from_numpy(np.array(y, copy=True)) if isinstance(y, np.ndarray) else y).to(
        logits.device)
    if cfg.n_classes == 1:
        logit = logits[..., 0]
        # jnp.maximum(logit, 0): torch.maximum splits the gradient at a tie as it does
        loss = torch.mean(torch.maximum(logit, torch.zeros_like(logit)) - logit * y
                          + torch.log1p(torch.exp(-torch.abs(logit))))
        acc = torch.mean(((logit > 0) == (y > 0.5)).float())
    else:
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.mean(torch.take_along_dim(logp, y[:, None].long(), dim=-1))
        acc = torch.mean((torch.argmax(logits, -1) == y).float())
    return loss, {"loss": loss, "accuracy": acc}
