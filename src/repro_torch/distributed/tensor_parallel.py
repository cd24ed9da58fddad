"""Tensor and expert parallelism over the mesh's ``model`` axis: the split
of a step's compute that GSPMD makes of the reference's jitted step
(``repro.train.step.make_train_step`` under the rules' shardings), for
every language model of the zoo: the dense GQA, MLA, MoE, Mamba2 and
hybrid families, the audio encoder and the VLM; and the data group
through which a data-sharded step computes the few terms that GSPMD
computes over the whole batch (:class:`DataGroup`).

The **model group** is ``mesh.get_group("model")`` with this rank's index
in it (:class:`ModelGroup`).  The residual stream is replicated over the
group: every rank holds the whole activation, and every rank computes the
same loss.  Work inside a block is split:

- attention by heads: q/k/v project to this rank's heads (column-parallel),
  the attention kernel runs at the local head counts, ``wo`` is
  row-parallel.  When the kv heads do not divide the group, K/V's weight is
  taken whole and each rank projects the kv heads its q heads use
  (:func:`kv_head_range`);
- MLA by heads too.  The rules split ``wq_a`` / ``wkv_a`` by their
  ``q_lora`` / ``kv_lora`` columns and ``wq_b`` / ``wk_b`` / ``wv_b`` by
  their lora rows (a mesh axis splits one tensor axis per spec, the first),
  and ``wkv_a``'s columns pack the latent and the RoPE key: so these five
  leaves are taken whole.  Each rank computes the latents and their norms
  whole (a few hundred columns per token), narrows ``wq_b`` / ``wk_b`` /
  ``wv_b`` to its heads' columns, attends at its heads and runs ``wo``
  row-parallel.  The latent cache is shared by the heads and stays whole;
- Mamba2 by SSM heads.  ``in_proj``'s ``inner`` axis packs ``[z | x | B |
  C | dt]`` and ``conv_w`` / ``conv_b``'s pack ``[x | B | C]``, so the
  rules' contiguous cut of them falls inside ``x``: they are taken whole,
  and each rank narrows them to its heads' ``z``, ``x`` and ``dt`` columns
  and the whole ``B`` / ``C`` (and ``A_log``, ``dt_bias``, ``D``, which the
  rules replicate, to its heads).  The scan runs over the local heads.
  ``gate_norm`` is one RMSNorm over the whole ``inner``: the local ``y`` is
  gathered and normed whole on every rank (the layernorm kernel on whole
  rows), then narrowed for ``out_proj``, which is row-parallel (the rules'
  cut of its rows falls on whole heads when the heads divide the group);
- the MLP by columns of ``mlp``: ``w_up`` / ``w_gate`` column-parallel,
  ``w_down`` row-parallel; the hybrid's shared block splits its attention
  and MLP so, and its ``out_proj`` (``mlp`` rows) is row-parallel;
- MoE by experts: the router's local logits are gathered, routing runs
  replicated, each rank runs its experts and the combine's partial sum is
  reduced (when the experts do not divide the group and the rules split
  ``mlp`` instead, each rank runs every expert on its ``mlp`` columns);
- the vocabulary: the embedding looks up this rank's rows, the logits are
  this rank's columns (``lm_head``'s, or the tied table's), the cross
  entropy reduces over the group (the encoder's masked-unit loss too);
- the modality frontends: ``frontend_proj`` (logical axes ``("frontend",
  "embed")``, neither of which maps to ``model``) is taken whole, so the
  audio encoder's frame embeddings and the VLM's patch embeddings are
  computed whole on every rank; the VLM's text tokens then look up this
  rank's vocabulary rows.  The encoder's bidirectional attention splits by
  heads as the causal one does.

Where the heads do not divide the group (minicpm3-4b's 40, internvl2-1b's
14 or mamba2-130m's 24 on 16), that layer repeats on every rank, as GSPMD's fallback
replicates an axis that does not divide.

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
precision plan splits as a float model does: its weight transform runs on
whole leaves before any cut (the serving executor applies it before it
places the parameters), and no forward quantizes a weight, so a
row-parallel leaf never needs a MAX over the group for a per-channel
scale.  A group of size 1, or none, leaves every model function on its old path:
:func:`active` returns None for it.  A group with no process group (an
abstract mesh, the dry run) runs no collective: each returns a tensor of
the right shape and counts its bytes, as a real group does
(``ModelGroup.bytes``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.device import scalar
from repro_torch.launch.mesh import mesh_axis_size

#: the logical axes whose ``model`` split the forward takes as it is (any
#: cut of a vocabulary, an ``mlp`` width or an expert list is a valid one)
_ANY_CUT = ("vocab", "mlp", "experts")
#: the logical axes of Mamba2's ``out_proj`` (after the stack's ``layers``),
#: the one ``inner`` leaf whose rules' cut (of its rows) the forward can
#: take: the others pack several kinds of column along ``inner``
_SSM_ROWS = ("inner", "embed")


@dataclasses.dataclass(frozen=True)
class Layout:
    """Which of a config's leaves the split forward takes as this rank's
    ``model`` shard (every block of a config is alike); where a field is
    False (None) the layer takes its leaves whole and repeats on every
    rank.  :func:`split_plan` sets it; the default splits nothing."""

    heads: bool = False  # the q heads (GQA's wq, MLA's narrowed wq_b / wk_b / wv_b), wo's rows
    kv_heads: bool = False  # wk / wv's kv heads; under ``heads`` and False: whole, narrowed
    mlp: bool = False  # the dense (or the hybrid's shared) MLP's columns
    router: bool = False  # the router's expert columns
    experts: str | None = None  # the expert leaves' split axis, "experts" or "mlp"
    vocab: bool = False  # the embedding's rows and lm_head's columns
    ssm: bool = False  # Mamba2's SSM heads: in_proj / conv narrowed, out_proj's rows
    shared_out: bool = False  # the hybrid's shared out_proj's rows


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


#: the language-model families, every one of which splits over ``model``
LM_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def splits(cfg: ModelConfig) -> bool:
    """Whether the family's step splits over ``model``: every family of the
    zoo does, as GSPMD splits every one of them by the same rules."""
    return cfg.family in LM_FAMILIES


def require_split(cfg: ModelConfig, plan=None) -> None:
    """Raise unless ``cfg`` can run split (a language model of the zoo).
    Any precision ``plan`` runs split as it runs whole: its weight
    transform (``core.precision.apply_plan_to_params``) takes whole leaves,
    before any cut, so a cut of its output is exact, and the int8 KV
    cache's scales are per (token, kv head), narrowed with their heads."""
    if not splits(cfg):
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family has no model split")


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


def ssm_heads_split(cfg: ModelConfig, size: int) -> bool:
    """Whether Mamba2 splits by whole SSM heads over ``size`` ranks (with
    one B / C group, which every head reads, as every published config
    has)."""
    return (cfg.ssm is not None and cfg.ssm.n_groups == 1
            and cfg.ssm.n_heads(cfg.d_model) % size == 0)


def ssm_head_range(cfg: ModelConfig, group: ModelGroup) -> tuple[int, int]:
    """This rank's SSM heads [lo, hi)."""
    return shard_range(cfg.ssm.n_heads(cfg.d_model), group)


def model_dim(spec) -> int | None:
    """The tensor axis that ``spec`` splits over ``model``, or None."""
    for dim, part in enumerate(spec):
        if part == "model" or (isinstance(part, tuple) and "model" in part):
            return dim
    return None


def takes_model_shard(cfg: ModelConfig, logical_axes, spec, size: int) -> bool:
    """Whether the split forward takes a leaf (under ``spec``, its logical
    axes ``logical_axes``) as its ``model`` shard; False means it takes the
    leaf whole (attention that does not split by whole heads, K/V whose kv
    heads do not divide the group, MLA's lora leaves, Mamba2's packed
    ``inner`` leaves: module docstring).  A leaf ``spec`` does not split
    over ``model`` is its own shard."""
    dim = model_dim(spec)
    if dim is None:
        return True
    logical = logical_axes[dim]
    if logical == "heads":
        return heads_split(cfg, size)
    if logical == "kv_heads":
        return heads_split(cfg, size) and cfg.n_kv_heads % size == 0
    if logical == "inner":
        return tuple(logical_axes[dim:]) == _SSM_ROWS and ssm_heads_split(cfg, size)
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

    # the hybrid's attention and MLP are its shared block's
    attn, ffn = (("shared_attn", "attn"), ("shared_attn", "mlp")) if cfg.family == "hybrid" \
        else (("blocks", "attn"), ("blocks", "ffn"))
    # the vocabulary's rows in the embedding, or (the audio encoder has no
    # table) its columns in lm_head
    vocab = taken("embed", "table") if "embed" in logical_axes else taken("lm_head", "kernel")
    layout = Layout(heads=taken(*attn, "wo", "kernel") == "heads",
                    kv_heads=taken(*attn, "wk", "kernel") == "kv_heads",
                    mlp=taken(*ffn, "w_up", "kernel") == "mlp",
                    router=taken(*ffn, "router", "kernel") == "experts",
                    experts=taken(*ffn, "w_up") if cfg.moe is not None else None,
                    vocab=vocab == "vocab",
                    ssm=taken("blocks", "mamba", "out_proj", "kernel") == "inner",
                    shared_out=taken("shared_attn", "out_proj", "kernel") == "mlp")
    return layout, local


def shard_range(n: int, group: ModelGroup) -> tuple[int, int]:
    """This rank's even shard [lo, hi) of an axis of ``n``."""
    c = n // group.size
    return group.rank * c, (group.rank + 1) * c


def ssm_columns(cfg: ModelConfig, group: ModelGroup, packed: str) -> torch.Tensor:
    """The indices of this rank's columns in a Mamba2 leaf whose axis packs
    ``packed`` ("zxbcdt": ``in_proj``'s outputs; "xbc": ``conv_w`` /
    ``conv_b`` and the ``conv_state`` cache): its heads' ``z``, ``x`` and
    ``dt`` columns, and the ``B`` / ``C`` columns."""
    s = cfg.ssm
    p, di = s.head_dim, s.d_inner(cfg.d_model)
    gn2 = 2 * s.state_dim  # one group
    lo, hi = ssm_head_range(cfg, group)
    heads = torch.arange(lo * p, hi * p)
    if packed == "xbc":
        return torch.cat([heads, torch.arange(di, di + gn2)])
    return torch.cat([heads, di + heads, torch.arange(2 * di, 2 * di + gn2),
                      torch.arange(2 * di + gn2 + lo, 2 * di + gn2 + hi)])


def local_caches(cfg: ModelConfig, caches: dict, group: ModelGroup | None) -> dict:
    """Whole caches as this rank's split forward reads and writes them.
    GQA (dense, rolling or paged; float or int8), and the hybrid's shared
    K/V: narrowed to the kv heads this rank's attention uses
    (:func:`kv_head_range`), the ``kv_heads`` axis (2 of every stacked
    ``k``, ``v``, ``k_scale``, ``v_scale``), views.  Mamba2: ``ssm_state``
    narrowed to this rank's SSM heads (a view), ``conv_state`` to its ``x``
    columns and the whole ``B`` / ``C`` (:func:`ssm_columns`; a copy, the
    columns are not one slice).  MLA's latent is shared by the heads and
    stays whole."""
    tp = active(group)
    if tp is None:
        return caches
    out = {g: dict(leaves) for g, leaves in caches.items()}
    if tp.layout.heads and cfg.attn_kind == "gqa":
        lo, hi = kv_head_range(cfg, tp)
        for leaves in out.values():
            for k in ("k", "v", "k_scale", "v_scale"):
                if k in leaves:
                    leaves[k] = leaves[k].narrow(2, lo, hi - lo)
    if tp.layout.ssm:
        lo, hi = ssm_head_range(cfg, tp)
        leaves = out["layers"]
        leaves["ssm_state"] = leaves["ssm_state"].narrow(2, lo, hi - lo)
        conv = leaves["conv_state"]
        leaves["conv_state"] = conv.index_select(
            conv.ndim - 1, ssm_columns(cfg, tp, "xbc").to(conv.device))
    return out


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


# ---------------------------------------------------------------------------
# the data group
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DataGroup:
    """The mesh axes that split a step's batch: ``size`` shards, this
    rank's shard ``rank`` in the global order of the rows (the major axis
    first, as ``rules.batch_sharding`` cuts them, so a shard's flat tokens
    are a contiguous run of the global flat order); ``groups`` each axis's
    (process group, size), major first, empty for an abstract mesh (the dry
    run: collectives run nothing).

    A data-sharded step hands it to the forward for the terms that the
    reference's jitted step computes over the whole batch: MoE capacity,
    the ranks that decide drops and the aux loss's means (``models.moe``),
    and the masked loss's denominator (``models.lm``)."""

    size: int
    rank: int
    groups: tuple = ()


def data_group(mesh, axes) -> DataGroup | None:
    """The :class:`DataGroup` of ``mesh``'s axes ``axes`` (those that split
    the batch, major first); None when they split it into one shard."""
    sizes = [mesh_axis_size(mesh, a) for a in axes]
    size = math.prod(sizes)
    if size <= 1:
        return None
    if not hasattr(mesh, "get_group"):
        return DataGroup(size, 0)
    rank = 0
    for a, n in zip(axes, sizes):
        rank = rank * n + mesh.get_local_rank(a)
    return DataGroup(size, rank, tuple((mesh.get_group(a), n) for a, n in zip(axes, sizes)))


def data_sum(t: torch.Tensor, data: DataGroup) -> torch.Tensor:
    """A new tensor: ``t`` summed over the data shards (no autograd)."""
    out = t.contiguous().clone()
    for g, _ in data.groups:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g)
    return out


def data_gather(t: torch.Tensor, data: DataGroup, dim: int) -> torch.Tensor:
    """Every shard's ``t`` concatenated along ``dim`` in the global order
    (no autograd)."""
    t = t.contiguous()
    if not data.groups:
        return torch.cat([t] * data.size, dim=dim)
    for g, n in reversed(data.groups):  # the minor axis first: the major one ends outermost
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=g)
        t = torch.cat(parts, dim=dim)
    return t


class _DataMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, data):
        return data_sum(x, data) / scalar(float(data.size), x.dtype, str(x.device))

    @staticmethod
    def backward(ctx, g):
        return g, None


def data_mean(x: torch.Tensor, data: DataGroup) -> torch.Tensor:
    """The mean of ``x`` over the data shards, for a term that the
    whole-batch step computes from whole-batch means (the same value on
    every shard).  Its gradient passes through unscaled: the step averages
    the shards' gradients, so shard r's share of the whole-batch gradient,
    (1/n) dL/dmean · dx_r, comes out of that average when each shard
    back-propagates dL/dmean · dx_r."""
    return _DataMean.apply(x, data)
