"""Train step: loss -> grads -> optimizer (port of ``repro.train.step``).

``train_step`` takes one synchronous update of ``{"params", "opt"}``:
``value_and_grad`` of the loss (autograd over every parameter leaf), then
``AdamW.update``, which writes the new parameters and moments into the
state's tensors in place (the counterpart of the reference's donated
buffers).  ``grad_accum > 1`` is a loop over microbatches that sums the
gradients in float32, as the reference's scan.

The sharded step (``make_train_step(mesh=, rules=)``) keeps the state as
DTensors under the rules' placements: parameters and AdamW moments sharded
alike, ``step`` replicated.  The kernel wrappers read raw pointers, so no
DTensor reaches them (they refuse one): each step gathers every parameter
to a plain tensor, runs the forward and backward on this rank's shard of
the batch (sharded over the data axes), averages the gradients over the
data axes, and applies AdamW to this rank's shard of each leaf (the FSDP
pattern).  The global gradient norm comes from the whole averaged
gradient, and the update is elementwise beyond it, so the step gives the
unsharded step's result: bitwise on one device, to float32 rounding of
the batch mean otherwise.  The compute is not split over ``model`` as
GSPMD splits it; each rank of a data shard computes its whole forward.
A MoE layer's capacity counts the tokens of this rank's shard.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.device import scalar
from repro_torch.distributed import sharding as sharding_lib
from repro_torch.launch.mesh import data_axes, mesh_axis_size
from repro_torch.models import lm
from repro_torch.models import params as params_lib
from repro_torch.models.params import map_leaves
from repro_torch.optim.adamw import AdamW, global_norm, tree_get, tree_leaves

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


def abstract_train_state(cfg: ModelConfig, optimizer: AdamW) -> dict:
    """The train state on the ``meta`` device (shapes and dtypes)."""
    ap = lm.abstract_params(cfg)
    return {"params": ap, "opt": optimizer.abstract_state(ap)}


def train_state_logical_axes(cfg: ModelConfig) -> dict:
    """Each train-state leaf's logical axes: the moments the parameters'."""
    axes = params_lib.logical_axes(lm.param_spec(cfg))
    return {"params": axes, "opt": {"step": (), "mu": axes, "nu": axes}}


def train_state_shardings(cfg: ModelConfig, optimizer: AdamW, rules) -> dict:
    """The rules' sharding of every leaf of the train state."""
    return rules.tree_shardings(abstract_train_state(cfg, optimizer),
                                train_state_logical_axes(cfg))


def shard_train_state(state: dict, shardings: dict) -> dict:
    """``state`` (whole tensors, the same on every rank) as DTensors under
    ``shardings``."""
    return sharding_lib.map_tree(sharding_lib.place, state, shardings)


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


def _mean_over(t: torch.Tensor, mesh, axes: tuple[str, ...], n: int) -> torch.Tensor:
    """The mean of ``t`` over the ranks of the mesh axes ``axes`` (n of them),
    the same bits on each."""
    if n == 1:
        return t
    t = t.clone()  # reduced in place: a tensor may stand for two metrics
    for a in axes:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group(a))
    return t / scalar(float(n), t.dtype, str(t.device))


def sharded_train_step(state: dict, batch: dict, *, cfg: ModelConfig, optimizer: AdamW,
                       mesh, rules, shardings: dict, kernel: dict | None = None,
                       remat: str = "none"):
    """One update of a state held under ``shardings`` (module docstring);
    ``batch`` holds the whole global batch (plain tensors, the same on every
    rank) or DTensors.  Returns (state, metrics), the state updated in
    place; the metrics are the data axes' means."""
    from torch.distributed.tensor import DTensor

    axes = data_axes(mesh)
    n = math.prod(mesh_axis_size(mesh, a) for a in axes)
    local = {k: v.to_local() if isinstance(v, DTensor) else sharding_lib.local_shard(
        v, rules.batch_sharding(v.ndim, shape=tuple(v.shape))) for k, v in batch.items()}
    params = sharding_lib.map_tree(sharding_lib.gather, state["params"])
    loss_fn = make_loss_fn(cfg, kernel=kernel, remat=remat)
    (_, metrics), grads = value_and_grad(loss_fn, params, local)
    del params
    grads = map_leaves(lambda _, g: _mean_over(g, mesh, axes, n), grads)
    metrics = {k: _mean_over(v.float(), mesh, axes, n) for k, v in metrics.items()}
    gnorm = global_norm(grads)
    grads = sharding_lib.map_tree(sharding_lib.local_shard, grads, shardings["params"])
    to_local = lambda t: t.to_local()  # noqa: E731
    _, _, opt_metrics = optimizer.update(
        grads, sharding_lib.map_tree(to_local, state["opt"]),
        sharding_lib.map_tree(to_local, state["params"]), grad_norm=gnorm)
    metrics.update(opt_metrics)
    return state, metrics


def make_train_step(cfg: ModelConfig, optimizer: AdamW, *, mesh=None, rules=None,
                    kernel: dict | None = None, remat: str = "none"):
    """The train step as a function of (state, batch), updating the state in
    place (the reference's ``donate``); sharded when ``mesh`` (a
    ``DeviceMesh``) and ``rules`` are both given, the state then held under
    ``train_state_shardings(cfg, optimizer, rules)``."""
    if mesh is None or rules is None:
        return functools.partial(train_step, cfg=cfg, optimizer=optimizer, kernel=kernel,
                                 remat=remat)
    if not hasattr(mesh, "get_group"):
        raise TypeError(f"mesh= takes a torch DeviceMesh (launch.mesh.make_mesh), got "
                        f"{type(mesh).__name__}")
    return functools.partial(sharded_train_step, cfg=cfg, optimizer=optimizer, mesh=mesh,
                             rules=rules, shardings=train_state_shardings(cfg, optimizer, rules),
                             kernel=kernel, remat=remat)
