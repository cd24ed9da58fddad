"""Logical-axis sharding rules for DP / FSDP / TP / EP / SP (port of
``repro.distributed.sharding``).

Every parameter leaf carries ``logical_axes`` (``models/params.py``).  The
rules map each logical axis to mesh axes; an axis whose size does not
divide the mesh-axis product falls back to replication, recorded in
``fallbacks``.  The mapping, the divisibility fallback and the batch specs
are the reference's, and are a function of the mesh's shape and axis names
alone, so they can be checked on a ``launch.mesh.AbstractMesh`` of any
size.

Default mapping (one pod (data=16, model=16); 'pod' joins the data axes on
the multi-pod mesh):

  batch       -> (pod, data)        activations / cache batch
  embed       -> data   [FSDP]      weights' non-TP axis (ZeRO-3)
  heads/kv_heads/mlp/q_lora/kv_lora/inner -> model  [TP]
  vocab       -> model  [TP]
  experts     -> model  [EP]
  cache_len   -> None (or model under SP)
  layers      -> None

A spec is a :class:`PartitionSpec` (a tuple: per tensor axis ``None``, a
mesh axis name or a tuple of them), and a :class:`NamedSharding` pairs it
with its mesh; on a ``DeviceMesh`` its ``placements`` are the DTensor
placement list (``Shard(d)`` on each mesh axis that splits tensor axis d,
``Replicate()`` on the others).  :func:`place` puts a plain tensor under a
sharding, :func:`gather` brings a DTensor back to a plain tensor, and
:func:`gather_over` gathers one over some mesh axes only (the data axes,
keeping its ``model`` shard, for the split step); :func:`shard_of` cuts a
rank's piece out of a plain tensor as the placements would.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.configs.base import ParallelismConfig
from repro_torch.launch.mesh import mesh_axis_names, mesh_axis_size


class PartitionSpec(tuple):
    """Per tensor axis: ``None``, a mesh axis name, or a tuple of them (the
    reference's ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P(" + ", ".join(repr(p) for p in self) + ")"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_for(self.mesh, self.spec)


def placements_for(mesh, spec: PartitionSpec) -> tuple:
    """The DTensor placement of each mesh axis for ``spec``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, part in enumerate(spec):
        axes = () if part is None else (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):  # DTensor splits in mesh-axis order (major first)
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass
class ShardingRules:
    mesh: Any  # a DeviceMesh or a launch.mesh.AbstractMesh
    plan: ParallelismConfig = dataclasses.field(default_factory=ParallelismConfig)
    overrides: dict[str, tuple[str, ...] | None] = dataclasses.field(default_factory=dict)
    # populated as specs are built: leaves that fell back to replication
    fallbacks: list[tuple[str, int]] = dataclasses.field(default_factory=list)

    def _size(self, axes) -> int:
        return math.prod(mesh_axis_size(self.mesh, a) for a in axes)

    def _mesh_axes_for(self, logical: str | None):
        if logical is None:
            return None
        if logical in self.overrides:
            return self.overrides[logical]
        names = mesh_axis_names(self.mesh)
        batch_axes = ("pod", "data") if "pod" in names else ("data",)
        tp = ("model",) if self.plan.tp else None
        m = {
            "batch": batch_axes if self.plan.dp else None,
            "embed": ("data",) if self.plan.fsdp else None,
            "frontend": None,
            "heads": tp,
            "kv_heads": tp,
            "mlp": tp,
            "inner": tp,
            "q_lora": tp,
            "kv_lora": tp,
            "vocab": tp,
            "experts": ("model",) if self.plan.ep else None,
            "ssm_heads": None,
            "cache_len": ("model",) if self.plan.sp else None,
            "seq": ("model",) if self.plan.sp else None,
            "layers": None,
        }
        return m.get(logical)

    def spec_for(self, logical_axes: tuple[str | None, ...],
                 shape: tuple[int, ...]) -> PartitionSpec:
        """PartitionSpec with divisibility fallback per axis."""
        if not logical_axes:
            return P()
        names = mesh_axis_names(self.mesh)
        parts = []
        used: set[str] = set()
        for logical, size in zip(logical_axes, shape):
            axes = self._mesh_axes_for(logical)
            if not axes:
                parts.append(None)
                continue
            # a mesh axis may be used at most once per spec
            axes = tuple(a for a in axes if a in names and a not in used)
            if not axes:
                parts.append(None)
                continue
            if size % self._size(axes) != 0:
                # try a prefix of the axes tuple before giving up
                ok = None
                for cut in range(len(axes) - 1, 0, -1):
                    if size % self._size(axes[:cut]) == 0:
                        ok = axes[:cut]
                        break
                if ok is None:
                    self.fallbacks.append((str(logical), size))
                    parts.append(None)
                    continue
                axes = ok
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
        return P(*parts)

    def sharding_for(self, logical_axes, shape) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for(tuple(logical_axes), tuple(shape)))

    def tree_shardings(self, abstract_tree: Any, axes_tree: Any) -> Any:
        """NamedSharding tree for (abstract tree, logical-axes tree): the
        abstract leaves are anything with a ``shape`` (``meta`` tensors)."""
        if isinstance(abstract_tree, dict):
            return {k: self.tree_shardings(v, axes_tree[k]) for k, v in abstract_tree.items()}
        return self.sharding_for(tuple(axes_tree), tuple(abstract_tree.shape))

    def batch_spec(self, ndim: int, sharded_dims: dict[int, str] | None = None,
                   shape: tuple[int, ...] | None = None) -> PartitionSpec:
        """Spec for an activation / batch tensor: dim 0 = batch; extra dims
        via {dim: logical} (e.g. {1: 'seq'} for sequence parallelism).  When
        ``shape`` is given, axes that do not divide fall back (global batch 1
        replicates the batch dim)."""
        names = mesh_axis_names(self.mesh)
        batch_axes = ("pod", "data") if "pod" in names else ("data",)
        parts: list = [batch_axes if len(batch_axes) > 1 else batch_axes[0]]
        parts += [None] * (ndim - 1)
        for dim, logical in (sharded_dims or {}).items():
            axes = self._mesh_axes_for(logical)
            if axes:
                parts[dim] = axes if len(axes) > 1 else axes[0]
        if shape is not None:
            for dim in range(ndim):
                part = parts[dim]
                if part is None:
                    continue
                axes = part if isinstance(part, tuple) else (part,)
                while axes and shape[dim] % self._size(axes) != 0:
                    axes = axes[:-1]
                parts[dim] = None if not axes else (axes if len(axes) > 1 else axes[0])
        return P(*parts)

    def batch_sharding(self, ndim: int, sharded_dims=None, shape=None) -> NamedSharding:
        return NamedSharding(self.mesh, self.batch_spec(ndim, sharded_dims, shape))


def param_shardings(rules: ShardingRules, cfg, model_module) -> Any:
    """Sharding tree for a model's parameters."""
    from repro_torch.models import params as params_lib

    spec = model_module.param_spec(cfg)
    return rules.tree_shardings(params_lib.abstract_params(spec),
                                params_lib.logical_axes(spec))


def cache_shardings(rules: ShardingRules, cfg, batch: int, max_len: int,
                    quantized: bool = False, layout: str = "dense", **layout_kw) -> Any:
    """Sharding tree for decode caches (``serve.kv_cache.cache_logical_axes``):
    dense slabs shard batch and cache_len; paged pools shard over kv_heads
    with the page axis replicated and the page table over batch."""
    from repro_torch.serve import kv_cache

    abstract = kv_cache.abstract_caches(cfg, batch, max_len, quantized=quantized,
                                        layout=layout, **layout_kw)
    axes = kv_cache.cache_logical_axes(cfg, quantized=quantized, layout=layout)
    return {group: {k: rules.sharding_for(axes[group][k], shape)
                    for k, (shape, _) in leaves.items()}
            for group, leaves in abstract.items()}


# ---------------------------------------------------------------------------
# DTensors: placing plain tensors under a sharding, and gathering them back
# ---------------------------------------------------------------------------


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on: its current card for a CUDA
    mesh, the CPU for a gloo one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place(t: torch.Tensor, sharding: NamedSharding):
    """``t`` (the whole tensor, the same on every rank) as a DTensor under
    ``sharding``: each rank keeps its own shard, cut locally (a replicated
    tensor redistributed to shards moves no data)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = sharding.mesh
    full = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return full.redistribute(mesh, sharding.placements)


def local_shard(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` under ``sharding``."""
    return place(t, sharding).to_local()


def gather(t):
    """A plain tensor holding the whole of ``t`` (a DTensor: gathered over
    every axis of its mesh by :func:`gather_over`'s plain all-gathers, not
    ``full_tensor()``, whose functional collectives crash a gloo group
    over CUDA tensors; a plain tensor is returned as it is)."""
    from torch.distributed.tensor import DTensor

    return gather_over(t, mesh_axis_names(t.device_mesh)) if isinstance(t, DTensor) else t


def gather_over(t, axes) -> torch.Tensor:
    """A plain tensor holding ``t`` (a DTensor) gathered over the mesh axes
    ``axes`` and still split over the others: this rank's shard of ``t``
    under the placements of the other axes."""
    mesh = t.device_mesh
    names = mesh_axis_names(mesh)
    local = t.to_local()
    for i in reversed(range(len(names))):  # the minor axis first, as DTensor splits
        p = t.placements[i]
        if names[i] in axes and p.is_shard() and mesh.size(i) > 1:
            parts = [torch.empty_like(local) for _ in range(mesh.size(i))]
            dist.all_gather(parts, local.contiguous(), group=mesh.get_group(i))
            local = torch.cat(parts, dim=p.dim)
    return local


def shard_of(t: torch.Tensor, placements, mesh, axes=None) -> torch.Tensor:
    """This rank's piece of ``t`` under ``placements`` on the mesh axes
    ``axes`` (every axis by default): a view, cut as DTensor splits (the
    major axis first, even chunks)."""
    names = mesh_axis_names(mesh)
    for i, p in enumerate(placements):
        if p.is_shard() and (axes is None or names[i] in axes):
            c = t.shape[p.dim] // mesh.size(i)
            t = t.narrow(p.dim, mesh.get_local_rank(i) * c, c)
    return t


def map_tree(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)
