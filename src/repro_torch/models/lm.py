"""Causal LM orchestrator (port of ``repro.models.lm``) for the families
ported so far: ``dense`` (granite-8b, minicpm-2b, starcoder2-7b; minicpm3-4b
with MLA, whose ``kernel["mla_absorb"]`` picks the absorbed decode), ``moe``
(granite-moe-3b-a800m, dbrx-132b) and ``ssm`` (mamba2-130m).

Entry points
------------
``param_spec / init_params / count_params``  -- parameter trees
``forward(params, cfg, batch, mode=...)``    -- logits (+caches, aux)
``prefill`` / ``decode_step``                -- serving steps on stacked caches
``init_caches / abstract_caches``            -- from ``serve.kv_cache``

The reference's scan over the stacked blocks is a Python loop.  ``prefill``
and ``decode_step`` return new cache tensors and never write into the
caller's: the new stack is one copy of the caller's, into which each layer
writes its new rows.  ``in_place=True`` skips that copy and writes into the
caller's stack (the serving executor, which owns its caches).  ``loss_fn``
is the next-token cross entropy of training; ``remat`` recomputes each
block in the backward (``torch.utils.checkpoint``, non-reentrant).
``forward``'s aux sums the MoE blocks' router aux over the layers, as the
reference's scan carries it.  The hybrid, VLM and audio families and the MoE
aux losses in ``loss_fn`` wait for ROADMAP queue 1, items 9 and 10.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils import checkpoint as checkpoint_lib

from repro_torch.configs.base import ModelConfig
from repro_torch.core import precision as precision_lib
from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.models import params as params_lib
from repro_torch.serve import kv_cache as kv_cache_lib

# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------


def resolve_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def param_spec(cfg: ModelConfig, dtype=None):
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.frontend} frontends are not ported yet (ROADMAP queue 1, item 9)"
        )
    dtype = resolve_dtype(cfg) if dtype is None else dtype
    d = cfg.d_model
    spec = {
        "embed": layers.embedding_spec(cfg.padded_vocab_size, d, dtype),
        "blocks": params_lib.stack_spec(blocks.block_spec(cfg, dtype), cfg.n_layers),
        "final_norm": layers.norm_spec(d, cfg.norm_kind, dtype),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = layers.dense_spec(
            d, cfg.padded_vocab_size, axes=("embed", "vocab"), dtype=dtype
        )
    return spec


def init_params(cfg: ModelConfig, generator: torch.Generator, *, dtype=None,
                device: str | torch.device = "cuda"):
    return params_lib.init_params(param_spec(cfg, dtype), generator, device)


def count_params(cfg: ModelConfig) -> int:
    leaves = []
    params_lib.map_leaves(lambda _, s: leaves.append(s), param_spec(cfg))
    return sum(int(np.prod(s.shape)) for s in leaves)


abstract_caches = kv_cache_lib.abstract_caches
init_caches = kv_cache_lib.init_caches


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed_inputs(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Token embeddings (b, s, d); the patch and audio frontends wait for
    ROADMAP queue 1, item 9."""
    return layers.embed(params["embed"], batch["tokens"]) * cfg.emb_scale


def _aux_init(cfg: ModelConfig, dev: torch.device) -> dict:
    if cfg.moe is None:
        return {}
    return {k: torch.zeros((), dtype=torch.float32, device=dev)
            for k in ("moe_aux_loss", "moe_z_loss", "moe_dropped_frac")}


def _layer(tree, i: int):
    return params_lib.map_leaves(lambda _, t: t[i], tree)


REMATS = ("none", "minimal", "full")


def _dots_saveable(ctx, op, *args, **kwargs):
    """``remat="minimal"``: keep the outputs of products without batch axes
    (the dense projections' ``mm``), recompute the rest, as the reference's
    ``dots_with_no_batch_dims_saveable`` policy."""
    if op is torch.ops.aten.mm.default:
        return checkpoint_lib.CheckpointPolicy.MUST_SAVE
    return checkpoint_lib.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """``fn(h)`` recomputed in the backward per ``remat`` ("minimal" or
    "full"; the reference's ``jax.checkpoint`` of the scan body)."""
    context_fn = (checkpoint_lib.noop_context_fn if remat == "full" else
                  functools.partial(checkpoint_lib.create_selective_checkpoint_contexts,
                                    _dots_saveable))
    return lambda h: checkpoint_lib.checkpoint(fn, h, use_reentrant=False,
                                               context_fn=context_fn)


def _run_blocks(params, cfg: ModelConfig, h: torch.Tensor, positions, *, mode: str,
                caches, kernel, plan: precision_lib.PrecisionPlan, in_place: bool = False,
                remat: str = "none"):
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r}; use one of {REMATS}")
    if remat != "none" and caches is not None:
        raise ValueError("remat recomputes blocks in the backward: train mode only, no caches")
    uniform_quant = plan.uniform_layer_quant()
    layer_quants = None if uniform_quant is not None else plan.layer_quant_arrays()
    # one copy of the caller's stack (or, in place, the stack itself), whose
    # layer slices the blocks update in place (attention) or that takes
    # their new state (Mamba2)
    if caches is None:
        new_layers = None
    elif in_place:
        new_layers = caches["layers"]
    else:
        new_layers = {k: t.clone() for k, t in caches["layers"].items()}
    aux = _aux_init(cfg, h.device)
    for i in range(cfg.n_layers):  # the reference's scan over the stacked blocks
        quant = uniform_quant if layer_quants is None else layer_quants.layer(i)
        lcache = None if new_layers is None else {k: t[i] for k, t in new_layers.items()}
        if remat != "none":
            def block(x, bparams=_layer(params["blocks"], i), quant=quant):
                out, _, l_aux = blocks.block_apply(bparams, cfg, x, positions, mode=mode,
                                                   kernel=kernel, quant=quant)
                return out, l_aux

            h, l_aux = _remat(block, remat)(h)
        else:
            h, out_lcache, l_aux = blocks.block_apply(
                _layer(params["blocks"], i), cfg, h, positions, mode=mode, cache=lcache,
                kernel=kernel, quant=quant,
            )
            for k, t in (out_lcache or {}).items():
                if t is not lcache[k]:
                    lcache[k].copy_(t)
        aux = {k: v + l_aux[k] for k, v in aux.items()}
    if new_layers is None:
        return h, None, aux
    return h, caches if in_place else {"layers": new_layers}, aux


def _as_tensor(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x, copy=True))
    return x.to(dev)


def forward(
    params,
    cfg: ModelConfig,
    batch: dict,
    *,
    mode: str = "train",
    caches=None,
    positions=None,
    kernel: dict | None = None,
    device: str | torch.device = "cuda",
    in_place: bool = False,
    remat: str = "none",
):
    """Returns (logits (b, s, padded_vocab), new_caches, aux); aux holds
    ``text_offset`` and, for MoE configs, the router aux summed over layers.

    ``batch["tokens"]``: (b, s) token ids, tensor or array.  positions: (s,)
    for train/prefill (defaults to arange), (b,) global positions of the new
    token for decode (the Mamba2 blocks do not read them).  ``in_place``:
    write into ``caches`` and return it, instead of a copy."""
    dev = resolve_device(device)
    params_lib.check_on(params, dev)
    plan = precision_lib.resolve_model_plan(cfg)
    kernel = plan.kernel_defaults(kernel)
    tokens = _as_tensor(batch["tokens"], dev)
    h = _embed_inputs(params, cfg, {"tokens": tokens})
    if positions is None:
        if mode in ("decode", "extend"):
            raise ValueError(f"{mode} requires explicit per-sequence positions")
        positions = torch.arange(h.shape[1], dtype=torch.int32, device=dev)
    else:
        positions = _as_tensor(positions, dev)
    x, new_caches, aux = _run_blocks(params, cfg, h, positions, mode=mode, caches=caches,
                                     kernel=kernel, plan=plan, in_place=in_place, remat=remat)
    x = layers.norm(
        params["final_norm"], x, cfg.norm_kind, cfg.norm_eps,
        use_lut=(kernel or {}).get("norm_lut", False),
    )
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], x)
    else:
        logits = layers.dense(params["lm_head"], x, plan.logits_quant())
    logits = logits * cfg.logit_scale
    if cfg.padded_vocab_size > cfg.vocab_size:  # mask the vocab padding
        pad = torch.arange(cfg.padded_vocab_size, device=dev) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e9)
    return logits, new_caches, {**aux, "text_offset": 0}


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _cross_entropy(logits, labels, mask, tp_safe: bool = False):
    logp = torch.log_softmax(logits.float(), dim=-1)
    if tp_safe:  # the reference's one-hot contraction (its vocab-sharded form)
        onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).to(logp.dtype)
        ll = torch.einsum("...v,...v->...", logp, onehot)
    else:
        ll = torch.take_along_dim(logp, labels[..., None].long(), dim=-1)[..., 0]
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    loss = -torch.sum(ll * mask) / denom
    acc = torch.sum((torch.argmax(logits, -1) == labels) * mask) / denom
    return loss, acc


def loss_fn(params, cfg: ModelConfig, batch: dict, *, kernel: dict | None = None,
            remat: str = "none", device: str | torch.device = "cuda"):
    """(loss, metrics): the mean next-token cross entropy of ``batch``
    {"tokens" (b, s), optional "loss_mask" (b, s)} under the mask, with
    "ce_loss", "accuracy" and "loss" as the reference's.  The encoder
    labels and the frontends' text offset wait for ROADMAP queue 1, item 9;
    the MoE aux losses (training the MoE family) for item 11's follow-ups."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: lm.loss_fn's MoE aux losses are not ported yet (ROADMAP queue 1, "
            "item 11: lm.loss_fn's MoE aux losses and training granite-moe-3b)"
        )
    if cfg.is_encoder or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the encoder and frontend losses are not ported yet "
            "(ROADMAP queue 1, item 9)"
        )
    dev = resolve_device(device)
    tokens = _as_tensor(batch["tokens"], dev)
    logits, _, aux = forward(params, cfg, {"tokens": tokens}, mode="train", kernel=kernel,
                             remat=remat, device=dev)
    if aux.get("text_offset", 0):
        raise NotImplementedError("a text offset comes with the frontends (ROADMAP queue 1, item 9)")
    mask = batch.get("loss_mask")
    mask = (torch.ones(tokens.shape, dtype=torch.float32, device=dev) if mask is None
            else _as_tensor(mask, dev).float())
    tp_safe = bool((kernel or {}).get("tp_loss", False))
    loss, acc = _cross_entropy(logits[:, :-1], tokens[:, 1:], mask[:, 1:], tp_safe)
    return loss, {"ce_loss": loss, "accuracy": acc, "loss": loss}


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------


def prefill(params, cfg: ModelConfig, batch: dict, caches, *, kernel: dict | None = None,
            device: str | torch.device = "cuda"):
    """Run the prompt through the model, filling caches.

    Returns (last-position logits (B, V), new caches)."""
    logits, new_caches, _ = forward(params, cfg, batch, mode="prefill", caches=caches,
                                    kernel=kernel, device=device)
    return logits[:, -1], new_caches


def decode_step(params, cfg: ModelConfig, tokens, positions, caches, *,
                kernel: dict | None = None, device: str | torch.device = "cuda"):
    """tokens (B, 1), positions (B,) -> (logits (B, V), new caches)."""
    logits, new_caches, _ = forward(params, cfg, {"tokens": tokens}, mode="decode",
                                    caches=caches, positions=positions, kernel=kernel,
                                    device=device)
    return logits[:, -1], new_caches
