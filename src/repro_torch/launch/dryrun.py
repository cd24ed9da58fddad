"""Multi-pod dry run (port of ``repro.launch.dryrun``): trace every
(architecture x input-shape x mesh) cell on ``meta`` tensors, count one
device's step (``roofline.op_counter``) and write its H100 roofline
(``roofline.analysis``) and memory per device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 40 cells x 2 meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh card

Every cell runs at full size: meta tensors allocate nothing, so this runs
on a CPU.  A mesh here is a ``launch.mesh.AbstractMesh`` (no process
group): the sharding rules read only its shape and axis names.

What one device computes is what the port's sharded step runs, in the
pattern ``train.step.make_train_step`` records as its ``split`` (the
cell's ``split``):

- ``"model"`` (every family on a model axis above one: the dense GQA,
  MLA, MoE, Mamba2 and hybrid language models, the audio encoder and the
  VLM): GSPMD's split over ``model`` (``train.step.sharded_train_step``
  under the group of ``train.step.model_split``): each parameter gathered
  over the data axes only, keeping its model shard (whole where the split
  takes it whole: the frontends' ``frontend_proj``, K/V whose kv heads do
  not divide the axis), the step traced at those local shapes under an
  abstract model group, whose collectives run nothing and count their
  bytes (``distributed.tensor_parallel``);
- ``"repeat"`` (every family on a model axis of one): the parameters
  gathered whole (the FSDP pattern of ``train.step.sharded_train_step``).

A training step's MoE layers run under the batch's abstract data group
(``train.step.batch_data_group``), as the sharded step runs them: capacity
and drops over the whole batch.

Either way the batch is split over the data axes (``pod`` x ``data``; a
batch the data degree does not divide is replicated, the rules' fallback)
and AdamW updates this device's shard of each leaf.  Prefill and decode run
the same way, the split's caches holding this device's kv heads.  The
argument bytes are those of the rules' placements (parameters, optimizer
moments, caches and batch per device).  The collectives are counted from
the step: ``all-gather``, each parameter gathered to the form the step
computes with (over the data axes, and over ``model`` too where it is taken
whole); ``all-reduce``, in training each such gradient over the data axes;
``model all-reduce`` / ``model all-gather``, the split's reductions and
gathers over ``model`` (partial sums, gradients into split work, the
vocabulary's reductions, the router's logits).  ``gathered_param_bytes``
is what one device holds of the parameters while it computes.

Results are cached as JSON under --out (default experiments/dryrun_torch);
a cell is traced again only with --force.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ModelConfig, ParallelismConfig, ShapeConfig
from repro_torch.device import meta_trace
from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.distributed.sharding import ShardingRules, map_tree
from repro_torch.launch.mesh import abstract_mesh, data_axes, mesh_axis_size
from repro_torch.models import blocks, lm
from repro_torch.models import params as params_lib
from repro_torch.models.params import map_leaves
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import global_norm
from repro_torch.roofline import op_counter
from repro_torch.roofline.analysis import analyze_cell
from repro_torch.train import step as step_lib

#: name -> (shape, axis names)
MESHES = {
    "pod": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
    "pod2": ((128, 2), ("data", "model")),  # head-aligned small TP
    "pod8": ((32, 8), ("data", "model")),  # alternate aspect ratio
    "pod32": ((8, 32), ("data", "model")),
    "tiny": ((2, 2), ("data", "model")),  # tests
    "tinypod": ((2, 2, 2), ("pod", "data", "model")),
    "card": ((1, 1), ("data", "model")),  # the one H100 the port runs on
}


def make_mesh(name: str):
    if name not in MESHES:
        raise KeyError(name)
    return abstract_mesh(*MESHES[name])


def plan_for(cfg: ModelConfig, shape: ShapeConfig) -> ParallelismConfig:
    """Default parallelism plan per cell kind (the baseline a perf
    hillclimb starts from)."""
    remat = "minimal" if shape.kind == "train" else "none"
    # long-context cells shard the sequence/cache dim (SP)
    sp = shape.seq_len >= 32768 and shape.kind != "train"
    return ParallelismConfig(sp=sp, remat=remat)


# ---------------------------------------------------------------------------
# shards and their bytes
# ---------------------------------------------------------------------------


def _local_shape(shape, sharding) -> tuple[int, ...]:
    """One device's shard of a tensor of ``shape`` under ``sharding``."""
    mesh, out = sharding.mesh, list(shape)
    for dim, part in enumerate(sharding.spec):
        axes = () if part is None else (part,) if isinstance(part, str) else part
        out[dim] //= math.prod(mesh_axis_size(mesh, a) for a in axes)
    return tuple(out)


def _local_meta(t: torch.Tensor, sharding) -> torch.Tensor:
    return torch.empty(_local_shape(t.shape, sharding), dtype=t.dtype, device="meta")


def _local_bytes(t: torch.Tensor, sharding) -> int:
    return math.prod(_local_shape(t.shape, sharding)) * t.element_size()


def _tree_bytes(tree, shardings) -> int:
    return sum(_local_bytes(t, sh) for t, sh in zip(_leaves(tree), _leaves(shardings)))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _batch_shardings(rules, specs: dict) -> dict:
    return {k: rules.batch_sharding(v.ndim, shape=tuple(v.shape)) for k, v in specs.items()}


def device_batch(rules, shape: ShapeConfig) -> int:
    """The batch one device runs: the global batch over the data axes the
    rules split it by (a batch they do not divide stays whole)."""
    return _local_shape((shape.global_batch,), rules.batch_sharding(1, shape=(
        shape.global_batch,)))[0]


def _gather_bytes(computed, shardings) -> float:
    """All-gather bytes of the step: each parameter whose computed form
    (``computed``) is larger than its shard, gathered to that form."""
    return float(sum(t.numel() * t.element_size()
                     for t, sh in zip(_leaves(computed), _leaves(shardings))
                     if _local_shape(t.shape, sh) != tuple(t.shape)))


@dataclasses.dataclass
class _Split:
    """How one device computes: ``pattern`` ``"model"`` or ``"repeat"``;
    for ``"model"``, the abstract ``group`` and the ``local`` tree of
    ``train.step.model_split``."""

    pattern: str
    group: tp_lib.ModelGroup | None = None
    local: dict | None = None


def _split_for(cfg, mesh, param_shardings) -> _Split:
    group, local = step_lib.model_split(cfg, mesh, param_shardings)
    return _Split("repeat") if group is None else _Split("model", group, local)


def _device_cfg(cfg, split: _Split):
    """The config whose attention one device runs: its q and kv heads
    under a split by heads, else ``cfg``; the head dim stays the whole
    model's (the hybrid's shared block's, which ``shared_attn_cfg`` sets)."""
    if split.group is None or not split.group.layout.heads:
        return cfg
    size = split.group.size
    lo, hi = tp_lib.kv_head_range(cfg, split.group)
    hd = (blocks.shared_attn_cfg(cfg) if cfg.family == "hybrid" else cfg).resolved_head_dim
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // size, n_kv_heads=hi - lo,
                               head_dim=hd)


def _computed_meta(t: torch.Tensor, sharding, local: bool, size: int) -> torch.Tensor:
    """The form the split step computes with (``train.step.split_params``):
    this device's ``model`` shard where ``local``, else the whole leaf."""
    shape = list(t.shape)
    dim = tp_lib.model_dim(sharding.spec)
    if local and dim is not None:
        shape[dim] //= size
    return torch.empty(shape, dtype=t.dtype, device="meta")


def _computed_params(aparams, shardings, split: _Split):
    if split.group is None:
        return aparams
    return map_tree(lambda t, sh, loc: _computed_meta(t, sh, loc, split.group.size), aparams,
                    shardings, split.local)


def _model_coll(split: _Split) -> dict[str, float]:
    if split.group is None:
        return {}
    return {f"model {k}": v for k, v in split.group.bytes.items()}


def _meta_caches(cfg, batch, max_len):
    spec = lm.abstract_caches(cfg, batch, max_len)
    return {g: {k: torch.empty(s, dtype=dt, device="meta") for k, (s, dt) in leaves.items()}
            for g, leaves in spec.items()}


def _cache_shardings(rules, caches, cfg):
    axes = lm.cache_logical_axes(cfg)
    return {g: {k: rules.sharding_for(axes.get(g, axes["layers"])[k], t.shape)
                for k, t in leaves.items()} for g, leaves in caches.items()}


def _out_bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(x) if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class Trace:
    """One device's counted step: its count, the per-device shape, the
    collectives' bytes and the argument / output bytes per device."""

    count: op_counter.Count
    device_shape: ShapeConfig
    coll_bytes: dict[str, float]
    memory_stats: dict[str, int]
    pattern: str  # the step's split: "model" or "repeat"
    param_bytes: float  # the parameters one device holds while it computes
    device_cfg: ModelConfig  # the config whose attention heads one device runs


# ---------------------------------------------------------------------------
# per-kind traces
# ---------------------------------------------------------------------------


class _ShardUpdate:
    """AdamW as the sharded step applies it: the gradients averaged over the
    data axes, their global norm (split: summed over the model shards), then
    the update of this device's shard of each leaf (``opt_local``,
    ``params_local``)."""

    def __init__(self, optimizer, opt_local, params_local, shardings, n_data, split: _Split):
        self.optimizer, self.opt_local, self.params_local = optimizer, opt_local, params_local
        self.shardings, self.n_data, self.split = shardings, n_data, split

    def update(self, grads, _state, _params):
        if self.n_data > 1:  # the all-reduce's mean, the sharded step's copy and divide
            grads = map_leaves(lambda _, g: g.clone() / float(self.n_data), grads)
        if self.split.group is None:
            gnorm = global_norm(grads)
        else:
            gnorm = step_lib.split_global_norm(grads, self.split.local, self.shardings,
                                               self.split.group)
        local = map_tree(_shard_view, grads, self.params_local)
        return self.optimizer.update(local, self.opt_local, self.params_local, grad_norm=gnorm)


def _shard_view(t: torch.Tensor, shard: torch.Tensor) -> torch.Tensor:
    """A view of ``t`` the shape of this device's ``shard`` of its leaf."""
    for dim, n in enumerate(shard.shape):
        t = t.narrow(dim, 0, n)
    return t


def trace_train(cfg, shape, mesh, rules) -> Trace:
    optimizer = AdamW(schedule=lambda s: 3e-4)
    state = step_lib.abstract_train_state(cfg, optimizer)
    state_sh = rules.tree_shardings(state, step_lib.train_state_logical_axes(cfg))
    b = device_batch(rules, shape)
    dshape = dataclasses.replace(shape, global_batch=b)
    specs = lm.input_specs(cfg, shape)
    local_specs = lm.input_specs(cfg, dshape)
    n_data = math.prod(mesh_axis_size(mesh, a) for a in data_axes(mesh))
    local = map_tree(_local_meta, state, state_sh)  # this device's shards
    split = _split_for(cfg, mesh, state_sh["params"])
    computed = _computed_params(state["params"], state_sh["params"], split)
    shard_update = _ShardUpdate(optimizer, local["opt"], local["params"], state_sh["params"],
                                n_data, split)
    data = step_lib.batch_data_group(mesh, rules, specs)
    with meta_trace(), op_counter.OpCounter() as c:
        _, metrics = step_lib.train_step({"params": computed, "opt": state["opt"]}, local_specs,
                                         cfg=cfg, optimizer=shard_update,
                                         remat=rules.plan.remat,
                                         grad_accum=rules.plan.grad_accum, group=split.group,
                                         data=data)
    param_bytes = float(sum(t.numel() * t.element_size() for t in _leaves(computed)))
    coll = {"all-gather": _gather_bytes(computed, state_sh["params"])}
    if n_data > 1:
        coll["all-reduce"] = param_bytes
    coll.update(_model_coll(split))
    args = _tree_bytes(state, state_sh) + _tree_bytes(specs, _batch_shardings(rules, specs))
    outs = _tree_bytes(state, state_sh) + _out_bytes(metrics)
    return Trace(c.result(), dshape, coll, {"argument_bytes": args, "output_bytes": outs},
                 split.pattern, param_bytes, _device_cfg(cfg, split))


def _serve_trace(cfg, shape, mesh, rules, mode) -> Trace:
    aparams = lm.abstract_params(cfg)
    params_sh = rules.tree_shardings(aparams, params_lib.logical_axes(lm.param_spec(cfg)))
    split = _split_for(cfg, mesh, params_sh)
    computed = _computed_params(aparams, params_sh, split)
    b = device_batch(rules, shape)
    dshape = dataclasses.replace(shape, global_batch=b)
    caches = _meta_caches(cfg, shape.global_batch, shape.seq_len)
    cache_sh = _cache_shardings(rules, caches, cfg)
    local_caches = tp_lib.local_caches(cfg, _meta_caches(cfg, b, shape.seq_len), split.group)
    specs = lm.input_specs(cfg, shape)
    local = lm.input_specs(cfg, dshape)
    kw = dict(device="meta", in_place=True, group=split.group)
    with meta_trace(), torch.no_grad(), op_counter.OpCounter() as c:
        if mode == "decode":
            logits, _, _ = lm.forward(computed, cfg, {"tokens": local["tokens"]}, mode="decode",
                                      caches=local_caches, positions=local["positions"], **kw)
        else:
            logits, _, _ = lm.forward(computed, cfg, local, mode="prefill", caches=local_caches,
                                      **kw)
        last = logits[:, -1]
    cache_bytes = _tree_bytes(caches, cache_sh)
    args = (_tree_bytes(aparams, params_sh) + cache_bytes
            + _tree_bytes(specs, _batch_shardings(rules, specs)))
    coll = {"all-gather": _gather_bytes(computed, params_sh), **_model_coll(split)}
    param_bytes = float(sum(t.numel() * t.element_size() for t in _leaves(computed)))
    return Trace(c.result(), dshape, coll,
                 {"argument_bytes": args, "output_bytes": cache_bytes + _out_bytes(last)},
                 split.pattern, param_bytes, _device_cfg(cfg, split))


def trace_prefill(cfg, shape, mesh, rules) -> Trace:
    return _serve_trace(cfg, shape, mesh, rules, "prefill")


def trace_decode(cfg, shape, mesh, rules) -> Trace:
    return _serve_trace(cfg, shape, mesh, rules, "decode")


TRACE = {"train": trace_train, "prefill": trace_prefill, "decode": trace_decode}


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------


def run_cell(
    arch: str,
    shape_name: str,
    mesh_name: str,
    *,
    out_dir: str,
    force: bool = False,
    reduced: bool = False,
) -> dict:
    """The reference's JSON fields (and ``device_batch``); ``lower_s`` is
    the trace's seconds and ``compile_s`` 0 (nothing is compiled)."""
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape_name}__{mesh_name}.json"
    path = os.path.join(out_dir, fname)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    ok, reason = configs.cell_status(arch, shape_name)
    if not ok:
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "status": "skip", "reason": reason}
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
        return result

    cfg = configs.get_config(arch, reduced=reduced)
    shape = SHAPES[shape_name]
    if reduced:
        shape = dataclasses.replace(shape, seq_len=min(shape.seq_len, 128),
                                    global_batch=min(shape.global_batch, 8))
    mesh = make_mesh(mesh_name)
    plan = plan_for(cfg, shape)
    rules = ShardingRules(mesh=mesh, plan=plan)
    t0 = time.time()
    try:
        tr = TRACE[shape.kind](cfg, shape, mesh, rules)
        t_trace = time.time() - t0
        analysis = analyze_cell(arch=arch, shape_cfg=shape, cfg=cfg, mesh_name=mesh_name,
                                n_devices=math.prod(mesh.shape), count=tr.count,
                                device_shape=tr.device_shape, coll_bytes=tr.coll_bytes,
                                memory_stats=tr.memory_stats, device_cfg=tr.device_cfg)
        result = analysis.to_json()
        result.update(
            status="ok",
            lower_s=round(t_trace, 2),
            compile_s=0.0,
            fallbacks=rules.fallbacks,
            plan=dataclasses.asdict(plan),
            params=cfg.param_count_estimate(),
            active_params=cfg.active_param_count_estimate(),
            device_batch=tr.device_shape.global_batch,
            split=tr.pattern,
            gathered_param_bytes=tr.param_bytes,
        )
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK (trace {t_trace:.1f}s, "
              f"split={tr.pattern}, dominant={analysis.dominant}, "
              f"fused={analysis.terms_fused.dominant})", flush=True)
    except Exception as e:  # noqa: BLE001 - record and continue
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "status": "error", "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: FAILED {e}", flush=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=2, default=str)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["both", *MESHES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--reduced", action="store_true", help="reduced configs (tests)")
    args = ap.parse_args(argv)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a, s, _, _ in configs.dryrun_cells()]
    else:
        archs = [args.arch] if args.arch else configs.ARCH_NAMES
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]

    n_ok = n_skip = n_err = 0
    for arch, shape in cells:
        for mesh_name in meshes:
            r = run_cell(arch, shape, mesh_name, out_dir=args.out, force=args.force,
                         reduced=args.reduced)
            st = r.get("status")
            n_ok += st == "ok"
            n_skip += st == "skip"
            n_err += st == "error"
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
