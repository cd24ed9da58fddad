"""Train step: loss -> grads -> optimizer (port of ``repro.train.step``).

``train_step`` takes one synchronous update of ``{"params", "opt"}``:
``value_and_grad`` of the loss (autograd over every parameter leaf), then
``AdamW.update``, which writes the new parameters and moments into the
state's tensors in place (the counterpart of the reference's donated
buffers).  ``grad_accum > 1`` is a loop over microbatches that sums the
gradients in float32, as the reference's scan.  The sharded step
(``mesh=`` / ``rules=``) waits for ROADMAP queue 1, item 12.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.params import map_leaves
from repro_torch.optim.adamw import AdamW, tree_get, tree_leaves

PyTree = Any

ACCUM_METRICS = ("loss", "ce_loss", "accuracy")


def value_and_grad(loss_fn: Callable, params: PyTree, *args, **kwargs):
    """((loss, aux), grads) of ``loss_fn(params, *args, **kwargs)``, the
    counterpart of ``jax.value_and_grad(..., has_aux=True)``: grads mirror
    ``params``, zeros for a leaf the loss does not reach.  ``params`` are
    left as they are (each leaf is differentiated through a detached alias
    of its storage)."""
    leaves = tree_leaves(params)
    alias = {path: p.detach().requires_grad_() for path, p in leaves}
    with torch.enable_grad():
        loss, aux = loss_fn(_tree_from_paths(params, alias), *args, **kwargs)
        grads = torch.autograd.grad(loss, list(alias.values()), allow_unused=True)
    by_path = {path: torch.zeros_like(p) if g is None else g
               for (path, p), g in zip(leaves, grads)}
    return ((loss.detach(), {k: v.detach() for k, v in aux.items()}),
            _tree_from_paths(params, by_path))


def _tree_from_paths(template: PyTree, by_path: dict, path=()) -> PyTree:
    if not isinstance(template, dict):
        return by_path[path]
    return {k: _tree_from_paths(v, by_path, path + (k,)) for k, v in template.items()}


def _device(params: PyTree) -> torch.device:
    return tree_leaves(params)[0][1].device


def make_train_state(cfg: ModelConfig, optimizer: AdamW, generator: torch.Generator, *,
                     device: str | torch.device = "cuda") -> dict:
    """``{"params", "opt"}`` with parameters drawn from ``generator``
    (``lm.init_params``) on ``device``."""
    params = lm.init_params(cfg, generator, device=device)
    return {"params": params, "opt": optimizer.init(params)}


def make_loss_fn(cfg: ModelConfig, *, kernel: dict | None = None, remat: str = "none",
                 loss_impl: Callable = lm.loss_fn):
    def _loss(params, batch):
        return loss_impl(params, cfg, batch, kernel=kernel, remat=remat,
                         device=_device(params))

    return _loss


def train_step(
    state: dict,
    batch: dict,
    *,
    cfg: ModelConfig,
    optimizer: AdamW,
    kernel: dict | None = None,
    remat: str = "none",
    grad_accum: int = 1,
):
    """One synchronous update; returns (state, metrics), ``state`` updated
    in place.  ``grad_accum > 1`` splits the batch axis into that many
    microbatches and averages their gradients before the optimizer."""
    loss_fn = make_loss_fn(cfg, kernel=kernel, remat=remat)
    params = state["params"]
    if grad_accum <= 1:
        (_, metrics), grads = value_and_grad(loss_fn, params, batch)
    else:
        micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        dev = _device(params)
        grads = map_leaves(lambda _, p: torch.zeros(p.shape, dtype=torch.float32, device=dev),
                           params)
        metrics = {k: torch.zeros((), dtype=torch.float32, device=dev) for k in ACCUM_METRICS}
        for i in range(grad_accum):
            (_, m), g = value_and_grad(loss_fn, params, {k: v[i] for k, v in micro.items()})
            for path, acc in tree_leaves(grads):
                acc.copy_(acc + tree_get(g, path))
            metrics = {k: metrics[k] + m[k] for k in ACCUM_METRICS}
        grads = map_leaves(lambda _, g: g / grad_accum, grads)
        metrics = {k: v / grad_accum for k, v in metrics.items()}
    _, _, opt_metrics = optimizer.update(grads, state["opt"], params)
    metrics = dict(metrics)
    metrics.update(opt_metrics)
    return state, metrics


def make_train_step(cfg: ModelConfig, optimizer: AdamW, *, mesh=None, rules=None,
                    kernel: dict | None = None, remat: str = "none"):
    """The train step as a function of (state, batch), updating the state in
    place (the reference's ``donate``); the sharded step waits for ROADMAP
    queue 1, item 12."""
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "the sharded train step (mesh=, rules=) is not ported yet (ROADMAP queue 1, item 12)"
        )
    return functools.partial(train_step, cfg=cfg, optimizer=optimizer, kernel=kernel,
                             remat=remat)
