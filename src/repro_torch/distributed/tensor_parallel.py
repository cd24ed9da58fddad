"""Tensor and expert parallelism over the mesh's ``model`` axis: the split
of a step's compute that GSPMD makes of the reference's jitted step
(``repro.train.step.make_train_step`` under the rules' shardings), for the
dense GQA and MoE families.

The **model group** is ``mesh.get_group("model")`` with this rank's index
in it (:class:`ModelGroup`).  The residual stream is replicated over the
group: every rank holds the whole activation, and every rank computes the
same loss.  Work inside a block is split:

- attention by heads: q/k/v project to this rank's heads (column-parallel),
  the attention kernel runs at the local head counts, ``wo`` is
  row-parallel.  When the kv heads do not divide the group, K/V's weight is
  taken whole and each rank projects the kv heads its q heads use
  (:func:`kv_head_range`);
- the MLP by columns of ``mlp``: ``w_up`` / ``w_gate`` column-parallel,
  ``w_down`` row-parallel;
- MoE by experts: the router's local logits are gathered, routing runs
  replicated, each rank runs its experts and the combine's partial sum is
  reduced (when the experts do not divide the group and the rules split
  ``mlp`` instead, each rank runs every expert on its ``mlp`` columns);
- the vocabulary: the embedding looks up this rank's rows, the logits are
  this rank's columns, the cross entropy reduces over the group.

The collectives pair as Megatron pairs them, because every rank computes
the same loss: into rank-local work, identity forward and all-reduce
backward (:func:`enter`); out of rank-local partial sums, all-reduce
forward and identity backward (:func:`reduce`); an all-gather whose result
feeds replicated work, gather forward and this rank's slice backward
(:func:`gather`).  A leaf replicated over ``model`` then gets its whole
gradient on every rank with no further sum.

Which leaves the forward takes as this rank's ``model`` shard is decided
here once, by :func:`takes_model_shard` from the rules' specs, and
:func:`split_plan` sums it up for a config as a :class:`Layout` that the
group carries: the layers read the layout, never the leaves' shapes.  A
group of size 1, or none, leaves every model function on its old path:
:func:`active` returns None for it.  A group with no process group (an
abstract mesh, the dry run) runs no collective: each returns a tensor of
the right shape and counts its bytes, as a real group does
(``ModelGroup.bytes``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig

#: the logical axes whose ``model`` split the forward takes as it is (any
#: cut of a vocabulary, an ``mlp`` width or an expert list is a valid one)
_ANY_CUT = ("vocab", "mlp", "experts")


@dataclasses.dataclass(frozen=True)
class Layout:
    """Which of a config's leaves the split forward takes as this rank's
    ``model`` shard (every block of a config is alike); where a field is
    False (None) the layer takes its leaves whole and repeats on every
    rank.  :func:`split_plan` sets it; the default splits nothing."""

    heads: bool = False  # wq's q heads and wo's rows
    kv_heads: bool = False  # wk / wv's kv heads; under ``heads`` and False: whole, narrowed
    mlp: bool = False  # the dense MLP's columns
    router: bool = False  # the router's expert columns
    experts: str | None = None  # the expert leaves' split axis, "experts" or "mlp"
    vocab: bool = False  # the embedding's rows and lm_head's columns


@dataclasses.dataclass
class ModelGroup:
    """This rank's place in the ``model`` axis: ``size`` ranks, this one
    ``rank``; ``group`` the process group, None for an abstract mesh;
    ``layout`` what the forward splits.  ``bytes`` counts each
    collective's payload by kind."""

    size: int
    rank: int
    group: Any = None
    layout: Layout = Layout()
    bytes: dict = dataclasses.field(default_factory=lambda: {"all-reduce": 0.0,
                                                             "all-gather": 0.0})

    def count(self, kind: str, t: torch.Tensor) -> None:
        self.bytes[kind] += float(t.numel() * t.element_size())


def model_group(mesh, layout: Layout = Layout()) -> ModelGroup | None:
    """The ``model`` axis of ``mesh`` (a ``DeviceMesh``, or an
    ``AbstractMesh`` whose rank is taken as 0) under ``layout``; None
    without one."""
    names = tuple(mesh.mesh_dim_names)
    if "model" not in names:
        return None
    size = int(mesh.shape[names.index("model")])
    if not hasattr(mesh, "get_group"):
        return ModelGroup(size, 0, layout=layout)
    return ModelGroup(size, mesh.get_local_rank("model"), mesh.get_group("model"), layout)


def active(group: ModelGroup | None) -> ModelGroup | None:
    """``group`` when it splits work (two ranks or more), else None."""
    return group if group is not None and group.size > 1 else None


def splits(cfg: ModelConfig) -> bool:
    """Whether the family's step splits over ``model`` (dense GQA and MoE
    language models); the others repeat it on every rank of the axis."""
    return (cfg.family in ("dense", "moe") and cfg.attn_kind == "gqa"
            and cfg.frontend is None and not cfg.is_encoder)


def require_split(cfg: ModelConfig, plan=None) -> None:
    """Raise unless ``cfg`` (and its precision ``plan``) can run split."""
    if not splits(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family with {cfg.attn_kind} attention does not split "
            "over the model axis yet (ROADMAP queue 2, item 11); its step repeats per rank")
    if plan is not None and plan.int8_weights:
        raise NotImplementedError(
            f"{cfg.name}: per-channel int8 weights reduce over a split axis; precision plans "
            "under the model split are ROADMAP queue 2, item 11")


# ---------------------------------------------------------------------------
# how the heads split
# ---------------------------------------------------------------------------


def heads_split(cfg: ModelConfig, size: int) -> bool:
    """Whether attention splits by whole q heads over ``size`` ranks, each
    rank's q heads using a contiguous run of kv heads evenly (a group of q
    heads per kv head, or several ranks on one kv head)."""
    if cfg.n_heads % size:
        return False
    local, per_kv = cfg.n_heads // size, cfg.n_heads // cfg.n_kv_heads
    return local % per_kv == 0 or per_kv % local == 0


def kv_head_range(cfg: ModelConfig, group: ModelGroup) -> tuple[int, int]:
    """The kv heads [lo, hi) that this rank's q heads use: its shard of
    them when they divide the group, else the one or few that its q heads
    share (K/V's weight is then replicated over the group's ranks)."""
    local, per_kv = cfg.n_heads // group.size, cfg.n_heads // cfg.n_kv_heads
    first = group.rank * local
    return first // per_kv, (first + local - 1) // per_kv + 1


def model_dim(spec) -> int | None:
    """The tensor axis that ``spec`` splits over ``model``, or None."""
    for dim, part in enumerate(spec):
        if part == "model" or (isinstance(part, tuple) and "model" in part):
            return dim
    return None


def takes_model_shard(cfg: ModelConfig, logical_axes, spec, size: int) -> bool:
    """Whether the split forward takes a leaf (under ``spec``, its logical
    axes ``logical_axes``) as its ``model`` shard; False means it takes the
    leaf whole (attention that does not split by whole heads, or K/V whose
    kv heads do not divide the group).  A leaf ``spec`` does not split over
    ``model`` is its own shard."""
    dim = model_dim(spec)
    if dim is None:
        return True
    logical = logical_axes[dim]
    if logical == "heads":
        return heads_split(cfg, size)
    if logical == "kv_heads":
        return heads_split(cfg, size) and cfg.n_kv_heads % size == 0
    return logical in _ANY_CUT


def split_plan(cfg: ModelConfig, logical_axes, shardings, size: int):
    """(the config's :class:`Layout`, per parameter leaf whether the split
    step hands the forward its ``model`` shard (True) or the whole leaf)
    for a model axis of ``size``; ``logical_axes`` and ``shardings`` are
    the parameter tree's (``lm.param_spec``'s, the rules')."""

    def tree(fn, *trees):
        if isinstance(trees[0], dict):
            return {k: tree(fn, *(t[k] for t in trees)) for k in trees[0]}
        return fn(*trees)

    local = tree(lambda ax, sh: takes_model_shard(cfg, ax, sh.spec, size), logical_axes,
                 shardings)

    def taken(*path):  # the logical axis whose model shard the forward takes there, or None
        ax, sh, loc = logical_axes, shardings, local
        for k in path:
            if k not in ax:
                return None
            ax, sh, loc = ax[k], sh[k], loc[k]
        dim = model_dim(sh.spec)
        return ax[dim] if dim is not None and loc else None

    layout = Layout(heads=taken("blocks", "attn", "wq", "kernel") == "heads",
                    kv_heads=taken("blocks", "attn", "wk", "kernel") == "kv_heads",
                    mlp=taken("blocks", "ffn", "w_up", "kernel") == "mlp",
                    router=taken("blocks", "ffn", "router", "kernel") == "experts",
                    experts=taken("blocks", "ffn", "w_up") if cfg.moe is not None else None,
                    vocab=taken("embed", "table") == "vocab")
    return layout, local


def shard_range(n: int, group: ModelGroup) -> tuple[int, int]:
    """This rank's even shard [lo, hi) of an axis of ``n``."""
    c = n // group.size
    return group.rank * c, (group.rank + 1) * c


def local_caches(cfg: ModelConfig, caches: dict, group: ModelGroup | None) -> dict:
    """Whole GQA caches (dense, rolling or paged; float or int8) narrowed
    to the kv heads this rank's attention writes and reads
    (:func:`kv_head_range`): the ``kv_heads`` axis (2 of every stacked
    ``k``, ``v``, ``k_scale``, ``v_scale``).  Views of ``caches``."""
    tp = active(group)
    if tp is None or not tp.layout.heads:
        return caches
    lo, hi = kv_head_range(cfg, tp)
    return {g: {k: t.narrow(2, lo, hi - lo) if k in ("k", "v", "k_scale", "v_scale") else t
                for k, t in leaves.items()} for g, leaves in caches.items()}


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, group: ModelGroup, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``t`` reduced over the group (no autograd)."""
    group.count("all-reduce", t)
    out = t.contiguous().clone()
    if group.group is not None:
        dist.all_reduce(out, op=op, group=group.group)
    return out


def all_gather(t: torch.Tensor, group: ModelGroup, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (no
    autograd)."""
    group.count("all-gather", t)
    t = t.contiguous()
    if group.group is None:
        return torch.cat([t] * group.size, dim=dim)
    parts = [torch.empty_like(t) for _ in range(group.size)]
    dist.all_gather(parts, t, group=group.group)
    return torch.cat(parts, dim=dim)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n), None, None


def enter(x: torch.Tensor, group: ModelGroup) -> torch.Tensor:
    """``x`` (replicated) into rank-local work: identity forward,
    all-reduce of its gradient backward."""
    return _Enter.apply(x, group)


def reduce(x: torch.Tensor, group: ModelGroup) -> torch.Tensor:
    """A rank-local partial sum out to replicated work: all-reduce forward,
    identity backward."""
    return _Reduce.apply(x, group)


def gather(x: torch.Tensor, group: ModelGroup, dim: int) -> torch.Tensor:
    """Rank-local pieces gathered along ``dim`` for replicated work: gather
    forward, this rank's slice of the gradient backward."""
    return _Gather.apply(x, group, dim)
