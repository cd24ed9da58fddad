"""Model orchestrator (port of ``repro.models.lm``): causal LMs, the audio
encoder and the VLM, for every family of the JAX package's zoo: ``dense``
(granite-8b, minicpm-2b, starcoder2-7b; minicpm3-4b with MLA, whose
``kernel["mla_absorb"]`` picks the absorbed decode), ``moe``
(granite-moe-3b-a800m, dbrx-132b), ``ssm`` (mamba2-130m), ``hybrid``
(zamba2-1.2b: Mamba2 blocks and one shared attention block), ``vlm``
(internvl2-1b: patch embeddings before the text) and ``audio``
(hubert-xlarge: frame embeddings, an encoder).

Entry points
------------
``param_spec / init_params / abstract_params / count_params`` -- parameter trees
``forward(params, cfg, batch, mode=...)``    -- logits (+caches, aux)
``loss_fn``                                  -- scalar loss + metrics
``prefill`` / ``decode_step``                -- serving steps on stacked caches
``init_caches / abstract_caches / cache_logical_axes`` -- from ``serve.kv_cache``
``input_specs(cfg, shape)``                  -- a dry-run cell's inputs on ``meta``

``batch`` keys by family: ``tokens`` (b, s); the VLM ``patches`` (b, n_img,
frontend_dim) and ``tokens`` (b, s_text), tokens alone in decode; the audio
encoder ``frames`` (b, s, frontend_dim) and, to train, ``labels`` (b, s).
The modality frontends are the reference's stubs: precomputed frame or
patch embeddings, mapped into d_model by ``frontend_proj``.

The reference's scan over the stacked blocks is a Python loop.  ``prefill``
and ``decode_step`` return new cache tensors and never write into the
caller's: the new stack is one copy of the caller's, into which each layer
(and, hybrid, each application of the shared block) writes its new rows.
``in_place=True`` skips that copy and writes into the caller's stack (the
serving executor, which owns its caches).  ``loss_fn`` is the next-token
cross entropy (from the text offset on, for the VLM), the encoder's
masked-unit cross entropy over ``labels``, plus the MoE aux and z losses;
``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, non-reentrant).  ``forward``'s aux sums the
MoE blocks' router aux over the layers, as the reference's scan carries it.

Under a model group (``group=``, a ``distributed.tensor_parallel``
``ModelGroup``) every family splits over the ``model`` axis, as GSPMD
splits the reference's step: the
parameters are each rank's model-local shards where the rules split them
(``train.step`` hands them so), the blocks split heads, SSM heads, MLP
columns and experts, the embedding looks up this rank's vocabulary rows,
``forward``'s logits are this rank's vocab columns, the cross entropy
reduces over the group, and ``prefill`` / ``decode_step`` gather their
last position's logits whole.  Their caches hold this rank's kv heads and
SSM heads (``tensor_parallel.local_caches``).  The audio encoder's frame
embeddings and the VLM's patch embeddings are computed whole on every rank
(``frontend_proj`` is never cut), the VLM's text tokens look up this rank's
vocabulary rows, and the encoder's untied ``lm_head`` gives this rank's
vocab columns to the vocab-parallel cross entropy.  A precision plan runs
split on the whole leaves its transform gave (``core.precision``); a group
of one changes nothing.

Under a data group (``data=``, a ``tensor_parallel.DataGroup``: the batch
is this rank's shard of a data-sharded step) the MoE layers and the masked
loss's denominator are the whole batch's (``models.moe``,
:func:`loss_fn`), as in the reference's step over the global batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import checkpoint as checkpoint_lib

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import precision as precision_lib
from repro_torch.device import resolve_device, scalar
from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.models import blocks, layers
from repro_torch.models import params as params_lib
from repro_torch.serve import kv_cache as kv_cache_lib

# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------


def n_shared_apps(cfg: ModelConfig) -> int:
    """Applications of the hybrid family's shared block: one before each
    layer ``i`` with ``i % attn_every == 0``."""
    if cfg.family != "hybrid":
        return 0
    return -(-cfg.n_layers // cfg.hybrid.attn_every)


def resolve_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def param_spec(cfg: ModelConfig, dtype=None):
    dtype = resolve_dtype(cfg) if dtype is None else dtype
    d = cfg.d_model
    spec = {}
    if cfg.frontend != "audio":
        spec["embed"] = layers.embedding_spec(cfg.padded_vocab_size, d, dtype)
    if cfg.frontend is not None:
        spec["frontend_proj"] = layers.dense_spec(cfg.frontend_dim or d, d,
                                                  axes=("frontend", "embed"), dtype=dtype)
    spec["blocks"] = params_lib.stack_spec(blocks.block_spec(cfg, dtype), cfg.n_layers)
    if cfg.family == "hybrid":
        spec["shared_attn"] = blocks.shared_attn_spec(cfg, dtype)
    spec["final_norm"] = layers.norm_spec(d, cfg.norm_kind, dtype)
    if not cfg.tie_embeddings:
        spec["lm_head"] = layers.dense_spec(
            d, cfg.padded_vocab_size, axes=("embed", "vocab"), dtype=dtype
        )
    return spec


def init_params(cfg: ModelConfig, generator: torch.Generator, *, dtype=None,
                device: str | torch.device = "cuda"):
    return params_lib.init_params(param_spec(cfg, dtype), generator, device)


def abstract_params(cfg: ModelConfig, dtype=None):
    """The parameter tree on the ``meta`` device (shapes and dtypes)."""
    return params_lib.abstract_params(param_spec(cfg, dtype))


def count_params(cfg: ModelConfig) -> int:
    leaves = []
    params_lib.map_leaves(lambda _, s: leaves.append(s), param_spec(cfg))
    return sum(int(np.prod(s.shape)) for s in leaves)


abstract_caches = kv_cache_lib.abstract_caches
init_caches = kv_cache_lib.init_caches
cache_logical_axes = kv_cache_lib.cache_logical_axes


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _vocab_group(group):
    """The active model group when its layout splits the vocabulary."""
    tp = tp_lib.active(group)
    return tp if tp is not None and tp.layout.vocab else None


def _embed_inputs(params, cfg: ModelConfig, batch: dict, mode: str, quant=None, tp=None):
    """(h (b, s, d), text_offset).  Audio: ``frames`` through
    ``frontend_proj``.  VLM: ``patches`` through ``frontend_proj``, put
    before the token embeddings (the offset is their count), except in
    decode.  Mixed types promote, as the reference's concatenation does."""
    qc = cfg.quant if quant is None else quant
    if cfg.frontend == "audio":  # whole on every rank of a model group
        return layers.dense(params["frontend_proj"], batch["frames"], qc), 0
    patch_emb = None
    if cfg.frontend == "patch" and "patches" in batch and mode != "decode":
        patch_emb = layers.dense(params["frontend_proj"], batch["patches"], qc)  # whole
    if "tokens" not in batch:
        return patch_emb, 0 if patch_emb is None else patch_emb.shape[1]
    # under a vocab split: this rank's rows, the lookups reduced over the group
    tok_emb = layers.embed(params["embed"], batch["tokens"], _vocab_group(tp)) * cfg.emb_scale
    if patch_emb is None:
        return tok_emb, 0
    dt = torch.promote_types(patch_emb.dtype, tok_emb.dtype)
    return torch.cat([patch_emb.to(dt), tok_emb.to(dt)], dim=1), patch_emb.shape[1]


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
                remat: str = "none", group=None, data=None):
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r}; use one of {REMATS}")
    if remat != "none" and caches is not None:
        raise ValueError("remat recomputes blocks in the backward: train mode only, no caches")
    uniform_quant = plan.uniform_layer_quant()
    layer_quants = None if uniform_quant is not None else plan.layer_quant_arrays()
    hybrid = cfg.family == "hybrid"
    shared_quant = plan.shared_quant() if hybrid else None
    x_embed = h  # every application of the shared block sees the embedding output
    # one copy of the caller's stacks (or, in place, the stacks themselves),
    # whose slices the blocks update in place (attention) or that take their
    # new state (Mamba2)
    if caches is None:
        new = None
    elif in_place:
        new = caches
    else:
        new = {group: {k: t.clone() for k, t in leaves.items()} for group, leaves in caches.items()}

    def run(fn, x, cache):
        """fn(x, cache) -> (x, cache, aux), rematerialized when asked; a
        block's new cache tensors are copied into the stack's slices."""
        if remat != "none":
            return _remat(lambda y: fn(y, None)[::2], remat)(x)
        x, out, aux = fn(x, cache)
        for k, t in (out or {}).items():
            if t is not cache[k]:
                cache[k].copy_(t)
        return x, aux

    aux = _aux_init(cfg, h.device)
    for i in range(cfg.n_layers):  # the reference's scan over the stacked blocks
        if hybrid and i % cfg.hybrid.attn_every == 0:
            app = i // cfg.hybrid.attn_every  # this application reads and writes its own cache
            scache = None if new is None else {k: t[app] for k, t in new["shared"].items()}

            def shared(x, cache):
                x, c = blocks.shared_attn_apply(params["shared_attn"], cfg, x, x_embed, positions,
                                                mode=mode, cache=cache, kernel=kernel,
                                                quant=shared_quant, group=group)
                return x, c, {}

            h, _ = run(shared, h, scache)
        quant = uniform_quant if layer_quants is None else layer_quants.layer(i)
        lcache = None if new is None else {k: t[i] for k, t in new["layers"].items()}

        def block(x, cache, bparams=_layer(params["blocks"], i), quant=quant):
            return blocks.block_apply(bparams, cfg, x, positions, mode=mode, cache=cache,
                                      kernel=kernel, quant=quant, group=group, data=data)

        h, l_aux = run(block, h, lcache)
        aux = {k: v + l_aux[k] for k, v in aux.items()}
    return h, new, aux


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
    group=None,
    data=None,
):
    """Returns (logits (b, s, padded_vocab), new_caches, aux); aux holds
    ``text_offset`` (the VLM's image prefix length; 0 otherwise) and, for
    MoE configs, the router aux summed over layers.  Under ``group``
    (module docstring) the logits are this rank's vocab columns where the
    vocabulary is split; under ``data`` the MoE layers are the whole
    batch's.

    ``batch``: ``tokens`` (b, s) token ids, the VLM's ``patches`` or the
    audio encoder's ``frames`` (module docstring), tensors or arrays.
    positions: (s,) for train/prefill (defaults to arange over the image
    prefix and the text), (b,) global positions of the new token for decode
    (the Mamba2 blocks do not read them).  ``in_place``: write into
    ``caches`` and return it, instead of a copy."""
    dev = resolve_device(device)
    params_lib.check_on(params, dev)
    plan = precision_lib.resolve_model_plan(cfg)
    tp = tp_lib.active(group)
    if tp is not None:
        tp_lib.require_split(cfg, plan)
    kernel = plan.kernel_defaults(kernel)
    inputs = {k: _as_tensor(batch[k], dev) for k in ("tokens", "patches", "frames") if k in batch}
    h, text_offset = _embed_inputs(params, cfg, inputs, mode, quant=plan.embed_quant(), tp=tp)
    if positions is None:
        if mode in ("decode", "extend"):
            raise ValueError(f"{mode} requires explicit per-sequence positions")
        positions = torch.arange(h.shape[1], dtype=torch.int32, device=dev)
    else:
        positions = _as_tensor(positions, dev)
    x, new_caches, aux = _run_blocks(params, cfg, h, positions, mode=mode, caches=caches,
                                     kernel=kernel, plan=plan, in_place=in_place, remat=remat,
                                     group=tp, data=data)
    x = layers.norm(
        params["final_norm"], x, cfg.norm_kind, cfg.norm_eps,
        use_lut=(kernel or {}).get("norm_lut", False),
    )
    vocab_tp = _vocab_group(tp)
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], x, vocab_tp)
    else:
        if vocab_tp is not None:
            x = tp_lib.enter(x, vocab_tp)
        logits = layers.dense(params["lm_head"], x, plan.logits_quant())
    logits = mask_vocab_padding(logits * cfg.logit_scale, cfg, vocab_tp)
    return logits, new_caches, {**aux, "text_offset": text_offset}


def mask_vocab_padding(logits: torch.Tensor, cfg: ModelConfig, vocab_tp=None) -> torch.Tensor:
    """``logits`` with the vocabulary's padding columns (global index >=
    ``vocab_size``) at -1e9; under ``vocab_tp`` the logits are this rank's
    even shard of the padded vocabulary's columns."""
    if cfg.padded_vocab_size == cfg.vocab_size:
        return logits
    lo = 0 if vocab_tp is None else vocab_tp.rank * logits.shape[-1]
    pad = torch.arange(lo, lo + logits.shape[-1], device=logits.device) >= cfg.vocab_size
    return logits.masked_fill(pad, -1e9)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _denominator(mask: torch.Tensor, data=None) -> torch.Tensor:
    """The masked mean's divisor, max(sum(mask), 1).  Under ``data`` the
    whole batch's, divided by the shard count: the step's mean of the
    shards' losses is then the whole batch's masked mean, whatever each
    shard's share of the mask."""
    if data is None:
        return torch.clamp_min(torch.sum(mask), 1.0)
    total = tp_lib.data_sum(torch.sum(mask.detach()), data)
    return torch.clamp_min(total, 1.0) / scalar(float(data.size), total.dtype, str(total.device))


def _vocab_parallel_cross_entropy(logits, labels, mask, group, denom):
    """``_cross_entropy`` of this rank's vocab columns of the logits: the
    max, the sum of exponentials, the target's logit and the accuracy's
    argmax (the first of the global maxima, as ``torch.argmax``) each
    reduced over the group."""
    lf = logits.float()
    n = lf.shape[-1]
    lo = group.rank * n
    m = tp_lib.all_reduce(lf.detach().amax(dim=-1), group, op=dist.ReduceOp.MAX)
    shifted = lf - m[..., None]
    sum_exp = tp_lib.reduce(torch.sum(torch.exp(shifted), dim=-1), group)
    local = labels.long() - lo
    inside = (local >= 0) & (local < n)
    picked = torch.take_along_dim(shifted, torch.where(inside, local, 0)[..., None], dim=-1)
    ll = tp_lib.reduce(picked[..., 0] * inside, group) - torch.log(sum_exp)
    loss = -torch.sum(ll * mask) / denom
    vmax, imax = lf.detach().max(dim=-1)
    best = tp_lib.all_gather(vmax[None], group, 0).argmax(dim=0, keepdim=True)
    pred = torch.take_along_dim(tp_lib.all_gather((imax + lo)[None], group, 0), best, dim=0)[0]
    acc = torch.sum((pred == labels) * mask) / denom
    return loss, acc


def _cross_entropy(logits, labels, mask, tp_safe: bool = False, group=None, data=None):
    denom = _denominator(mask, data)
    if group is not None:
        return _vocab_parallel_cross_entropy(logits, labels, mask, group, denom)
    logp = torch.log_softmax(logits.float(), dim=-1)
    if tp_safe:  # the reference's one-hot contraction (its vocab-sharded form)
        onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).to(logp.dtype)
        ll = torch.einsum("...v,...v->...", logp, onehot)
    else:
        ll = torch.take_along_dim(logp, labels[..., None].long(), dim=-1)[..., 0]
    loss = -torch.sum(ll * mask) / denom
    acc = torch.sum((torch.argmax(logits, -1) == labels) * mask) / denom
    return loss, acc


def loss_fn(params, cfg: ModelConfig, batch: dict, *, kernel: dict | None = None,
            remat: str = "none", device: str | torch.device = "cuda", group=None, data=None):
    """(loss, metrics) as the reference's: the encoder's cross entropy of
    ``labels`` (b, s) at every frame; otherwise the next-token cross entropy
    of ``tokens`` from the text offset on (the VLM's image prefix predicts
    nothing); under the optional ``loss_mask``.  MoE configs add the router's
    aux and z losses to the total.  Metrics: "ce_loss", "accuracy", "loss",
    and for MoE "moe_aux_loss", "moe_z_loss" and "moe_dropped_frac" (the
    mean over layers).  Under ``group`` every rank of it gives the same
    loss, its cross entropy reduced over the vocab shards.  Under ``data``
    (``batch`` this rank's shard) the masked mean divides by the whole
    batch's mask, so the mean over the shards is the whole batch's loss,
    and the MoE terms are the whole batch's (``models.moe``)."""
    dev = resolve_device(device)
    inputs = {k: batch[k] for k in ("tokens", "patches", "frames") if k in batch}
    logits, _, aux = forward(params, cfg, inputs, mode="train", kernel=kernel, remat=remat,
                             device=dev, group=group, data=data)
    vocab_tp = _vocab_group(group)
    tp_safe = bool((kernel or {}).get("tp_loss", False))
    mask = batch.get("loss_mask")
    if cfg.is_encoder:
        labels = _as_tensor(batch["labels"], dev)
        mask = (torch.ones(labels.shape, dtype=torch.float32, device=dev) if mask is None
                else _as_tensor(mask, dev).float())
        loss, acc = _cross_entropy(logits, labels, mask, tp_safe, vocab_tp, data)
    else:
        off = aux.pop("text_offset", 0)
        tokens = _as_tensor(batch["tokens"], dev)
        mask = (torch.ones(tokens.shape, dtype=torch.float32, device=dev) if mask is None
                else _as_tensor(mask, dev).float())
        loss, acc = _cross_entropy(logits[:, off:][:, :-1], tokens[:, 1:], mask[:, 1:], tp_safe,
                                   vocab_tp, data)
    total = loss
    metrics = {"ce_loss": loss, "accuracy": acc}
    for k in ("moe_aux_loss", "moe_z_loss"):
        if k in aux:
            total = total + aux[k]
            metrics[k] = aux[k]
    if "moe_dropped_frac" in aux:
        metrics["moe_dropped_frac"] = aux["moe_dropped_frac"] / cfg.n_layers
    metrics["loss"] = total
    return total, metrics


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------


def _last_whole(logits: torch.Tensor, group) -> torch.Tensor:
    """The last position's logits (B, V), gathered over the group's vocab
    shards when they are split."""
    last = logits[:, -1]
    tp = _vocab_group(group)
    return last if tp is None else tp_lib.all_gather(last, tp, -1)


def prefill(params, cfg: ModelConfig, batch: dict, caches, *, kernel: dict | None = None,
            device: str | torch.device = "cuda", group=None):
    """Run the prompt through the model, filling caches.

    Returns (last-position logits (B, V), new caches)."""
    logits, new_caches, _ = forward(params, cfg, batch, mode="prefill", caches=caches,
                                    kernel=kernel, device=device, group=group)
    return _last_whole(logits, group), new_caches


def decode_step(params, cfg: ModelConfig, tokens, positions, caches, *,
                kernel: dict | None = None, device: str | torch.device = "cuda", group=None):
    """tokens (B, 1), positions (B,) -> (logits (B, V), new caches)."""
    logits, new_caches, _ = forward(params, cfg, {"tokens": tokens}, mode="decode",
                                    caches=caches, positions=positions, kernel=kernel,
                                    device=device, group=group)
    return _last_whole(logits, group), new_caches


# ---------------------------------------------------------------------------
# Dry-run input specs (tensors on the meta device: shapes and dtypes, no storage)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Model inputs for one (arch x shape) dry-run cell, the reference's
    shapes and dtypes, as ``meta`` tensors."""
    b, s = shape.global_batch, shape.seq_len

    def spec(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": spec((b, 1)), "positions": spec((b,))}
    if cfg.frontend == "audio":
        fd = cfg.frontend_dim or cfg.d_model
        specs = {"frames": spec((b, s, fd), torch.float32)}
        if shape.kind == "train":
            specs["labels"] = spec((b, s))
        return specs
    if cfg.frontend == "patch":
        fd = cfg.frontend_dim or cfg.d_model
        n_img = cfg.n_frontend_tokens
        return {"patches": spec((b, n_img, fd), torch.float32), "tokens": spec((b, s - n_img))}
    return {"tokens": spec((b, s))}
