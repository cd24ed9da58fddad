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
DTensor reaches them (they refuse one): each rank hands them plain local
tensors.  Two patterns, recorded as the step's ``split``:

- ``"model"`` (every family of the zoo on a model axis above one: the
  dense GQA, MLA, MoE, Mamba2 and hybrid language models, the audio
  encoder and the VLM: granite-8b, minicpm-2b, starcoder2-7b, minicpm3-4b,
  granite-moe-3b-a800m, dbrx-132b, mamba2-130m, zamba2-1.2b,
  hubert-xlarge, internvl2-1b), GSPMD's split of the reference's step:
  each parameter is gathered over the data axes only and keeps its
  ``model`` shard (``model_split``; a leaf the forward cannot take as a
  shard, such as K/V whose kv heads do not divide the axis, or the
  frontends' ``frontend_proj``, comes whole), and the forward and backward
  run at the local shapes under the mesh's model group
  (``distributed.tensor_parallel``: heads, SSM heads, MLP columns, experts
  and vocabulary split).  Every rank of the group computes the same loss;
  a leaf replicated over ``model`` gets its whole gradient on each.  The
  global norm counts each split leaf's squares over its shards and each
  replicated leaf's once.  A precision plan with int8 weights splits too:
  its transform takes whole leaves, before the state is sharded.
- ``"repeat"`` (every family on a model axis of one): every parameter
  gathered whole, the whole forward on every rank (the FSDP pattern).  The
  global norm comes from the whole averaged gradient.  On a one-device
  mesh it is bitwise the unsharded step.

Both run on this rank's shard of the batch (split over the data axes),
average the gradients over the data axes and apply AdamW to this rank's
shard of each leaf, elementwise beyond the global norm, so the step gives
the reference's step over the whole batch to float32 rounding.  The few
terms that the reference computes over the whole batch see it through the
data group (``tensor_parallel.DataGroup``) handed to the loss: a MoE
layer's capacity, drop ranks and aux-loss means, and a ``loss_mask``'s
denominator (the whole batch's mask).  So the aux loss and the dropped
share are the whole batch's on every rank, and are reported as they are.
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
from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.launch.mesh import data_axes, mesh_axis_names, mesh_axis_size
from repro_torch.models import lm
from repro_torch.models import params as params_lib
from repro_torch.models.params import map_leaves
from repro_torch.optim.adamw import AdamW, global_norm, tree_get, tree_leaves

PyTree = Any

ACCUM_METRICS = ("loss", "ce_loss", "accuracy")
#: metrics that a data-sharded loss computes for the whole batch, the same
#: on every rank (``lm.loss_fn`` under a data group): not averaged again
WHOLE_BATCH_METRICS = ("moe_aux_loss", "moe_dropped_frac")


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
                 loss_impl: Callable = lm.loss_fn, group=None, data=None):
    """``loss(params, batch)``; under ``group`` (a model group) the split
    loss of ``lm.loss_fn``, under ``data`` (a data group) its shard of the
    whole batch's."""
    extra = {} if group is None else {"group": group}
    if data is not None:
        extra["data"] = data

    def _loss(params, batch):
        return loss_impl(params, cfg, batch, kernel=kernel, remat=remat,
                         device=_device(params), **extra)

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
    group=None,
    data=None,
):
    """One synchronous update; returns (state, metrics), ``state`` updated
    in place.  ``grad_accum > 1`` splits the batch axis into that many
    microbatches and averages their gradients before the optimizer.
    ``group`` / ``data``: the loss's model and data groups (the dry run's
    count of one device's sharded step)."""
    loss_fn = make_loss_fn(cfg, kernel=kernel, remat=remat, group=group, data=data)
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


def model_split(cfg: ModelConfig, mesh, param_shardings):
    """(group, local) for the split step on ``mesh`` (a ``DeviceMesh`` or an
    ``AbstractMesh``): the mesh's model group carrying the config's
    ``tensor_parallel.Layout``, and per parameter leaf whether the forward
    takes its ``model`` shard (True) or the whole leaf
    (``tensor_parallel.split_plan``); every family of the zoo, the encoder
    and the VLM among them, takes it.  (None, None) for the ``"repeat"``
    pattern: a model axis of one."""
    group = tp_lib.active(tp_lib.model_group(mesh))
    if group is None or not tp_lib.splits(cfg):
        return None, None
    layout, local = tp_lib.split_plan(cfg, params_lib.logical_axes(lm.param_spec(cfg)),
                                      param_shardings, group.size)
    return tp_lib.model_group(mesh, layout), local


def split_params(params: PyTree, local: PyTree, mesh) -> PyTree:
    """Plain tensors of the DTensor ``params``: gathered over the data axes,
    and over ``model`` too where ``local`` is False."""
    axes = data_axes(mesh)
    every = mesh_axis_names(mesh)
    return sharding_lib.map_tree(lambda t, loc: sharding_lib.gather_over(t, axes if loc else every),
                                 params, local)


def split_global_norm(grads: PyTree, local: PyTree, shardings: PyTree, group) -> torch.Tensor:
    """The global norm of a gradient held as the split step holds it: each
    leaf split over ``model`` (a shard on this rank) contributes its squares
    summed over the group, each other leaf (whole and equal on every rank)
    its squares once."""
    dev = tree_leaves(grads)[0][1].device
    split = torch.zeros((), dtype=torch.float32, device=dev)
    once = torch.zeros((), dtype=torch.float32, device=dev)
    for (_, g), (_, loc), (_, sh) in zip(tree_leaves(grads), tree_leaves(local),
                                         tree_leaves(shardings)):
        sq = torch.sum(torch.square(g.float()))
        if loc and tp_lib.model_dim(sh.spec) is not None:
            split = split + sq
        else:
            once = once + sq
    return torch.sqrt(once + tp_lib.all_reduce(split, group))


def batch_data_group(mesh, rules, batch: dict):
    """The data group of ``batch``'s rows under ``rules.batch_sharding``
    (the mesh axes that split them, which a batch the data degree does not
    divide leaves out), or None when nothing splits them."""
    from torch.distributed.tensor import DTensor

    v = next(iter(batch.values()))
    if isinstance(v, DTensor):
        names = mesh_axis_names(v.device_mesh)
        axes = tuple(names[i] for i, p in enumerate(v.placements)
                     if p.is_shard() and p.dim == 0)
    else:
        part = rules.batch_sharding(v.ndim, shape=tuple(v.shape)).spec[0]
        axes = () if part is None else (part,) if isinstance(part, str) else tuple(part)
    return tp_lib.data_group(mesh, axes)


def sharded_train_step(state: dict, batch: dict, *, cfg: ModelConfig, optimizer: AdamW,
                       mesh, rules, shardings: dict, kernel: dict | None = None,
                       remat: str = "none", local: PyTree | None = None, group=None):
    """One update of a state held under ``shardings`` (module docstring);
    ``batch`` holds the whole global batch (plain tensors, the same on every
    rank) or DTensors.  Returns (state, metrics), the state updated in
    place; the metrics are the data axes' means (those the loss computed
    for the whole batch, ``WHOLE_BATCH_METRICS``, as they are).  Without
    ``group`` the ``"repeat"`` pattern; with the mesh's model group (whose
    ``bytes`` count the step's collectives over ``model``) and the
    ``local`` tree of ``model_split``, the ``"model"`` pattern."""
    from torch.distributed.tensor import DTensor

    axes = data_axes(mesh)
    n = math.prod(mesh_axis_size(mesh, a) for a in axes)
    rows = {k: v.to_local() if isinstance(v, DTensor) else sharding_lib.local_shard(
        v, rules.batch_sharding(v.ndim, shape=tuple(v.shape))) for k, v in batch.items()}
    if group is None:
        params = sharding_lib.map_tree(sharding_lib.gather, state["params"])
    else:
        params = split_params(state["params"], local, mesh)
    data = batch_data_group(mesh, rules, batch)
    loss_fn = make_loss_fn(cfg, kernel=kernel, remat=remat, group=group, data=data)
    (_, metrics), grads = value_and_grad(loss_fn, params, rows)
    del params
    grads = map_leaves(lambda _, g: _mean_over(g, mesh, axes, n), grads)
    metrics = {k: v.float() if data is not None and k in WHOLE_BATCH_METRICS
               else _mean_over(v.float(), mesh, axes, n) for k, v in metrics.items()}
    if group is None:
        gnorm = global_norm(grads)
        grads = sharding_lib.map_tree(sharding_lib.local_shard, grads, shardings["params"])
    else:
        gnorm = split_global_norm(grads, local, shardings["params"], group)
        grads = sharding_lib.map_tree(
            lambda g, loc, sh: sharding_lib.shard_of(g, sh.placements, mesh,
                                                     axes if loc else None),
            grads, local, shardings["params"])
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
    ``train_state_shardings(cfg, optimizer, rules)``.  A sharded step's
    ``split`` names its pattern, ``"model"`` or ``"repeat"`` (module
    docstring)."""
    if mesh is None or rules is None:
        return functools.partial(train_step, cfg=cfg, optimizer=optimizer, kernel=kernel,
                                 remat=remat)
    if not hasattr(mesh, "get_group"):
        raise TypeError(f"mesh= takes a torch DeviceMesh (launch.mesh.make_mesh), got "
                        f"{type(mesh).__name__}")
    shardings = train_state_shardings(cfg, optimizer, rules)
    # a model axis of one splits nothing: the FSDP step, bitwise as before
    group, local = model_split(cfg, mesh, shardings["params"])
    fn = functools.partial(sharded_train_step, cfg=cfg, optimizer=optimizer, mesh=mesh,
                           rules=rules, shardings=shardings, kernel=kernel, remat=remat,
                           local=local, group=group)
    fn.split = "repeat" if group is None else "model"
    return fn
