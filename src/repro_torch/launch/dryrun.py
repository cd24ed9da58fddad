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

What one device computes is what the port's sharded step runs (the FSDP
pattern of ``train.step.sharded_train_step``): the parameters gathered
whole, the batch split over the data axes (``pod`` x ``data``; a batch the
data degree does not divide is replicated, the rules' fallback), the
``model`` axis repeating its data shard's compute (GSPMD's split over
``model`` is ROADMAP queue 2, item 11), and AdamW on this device's shard of
each leaf.  Prefill and decode run the same way: parameters gathered,
batch and caches split over the data axes.  The argument bytes are those
of the rules' placements (parameters, optimizer moments, caches and batch
per device); the collectives are counted from the step: each sharded
parameter gathered whole, and in training each gradient all-reduced over
the data axes.

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
from repro_torch.distributed.sharding import ShardingRules, map_tree
from repro_torch.launch.mesh import abstract_mesh, data_axes, mesh_axis_size
from repro_torch.models import lm
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


def _gather_bytes(aparams, shardings) -> float:
    """All-gather bytes of the step: each sharded parameter gathered whole."""
    return float(sum(t.numel() * t.element_size()
                     for t, sh in zip(_leaves(aparams), _leaves(shardings))
                     if _local_shape(t.shape, sh) != tuple(t.shape)))


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


# ---------------------------------------------------------------------------
# per-kind traces
# ---------------------------------------------------------------------------


class _ShardUpdate:
    """AdamW as the sharded step applies it: the gradients averaged over the
    data axes, their global norm, then the update of this device's shard of
    each leaf (``opt_local``, ``params_local``)."""

    def __init__(self, optimizer, opt_local, params_local, shardings, n_data):
        self.optimizer, self.opt_local, self.params_local = optimizer, opt_local, params_local
        self.shardings, self.n_data = shardings, n_data

    def update(self, grads, _state, _params):
        if self.n_data > 1:  # the all-reduce's mean, the sharded step's copy and divide
            grads = map_leaves(lambda _, g: g.clone() / float(self.n_data), grads)
        gnorm = global_norm(grads)
        local = map_tree(_shard_view, grads, self.shardings)
        return self.optimizer.update(local, self.opt_local, self.params_local, grad_norm=gnorm)


def _shard_view(t: torch.Tensor, sharding) -> torch.Tensor:
    for dim, n in enumerate(_local_shape(t.shape, sharding)):
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
    shard_update = _ShardUpdate(optimizer, local["opt"], local["params"], state_sh["params"],
                                n_data)
    with meta_trace(), op_counter.OpCounter() as c:
        _, metrics = step_lib.train_step(state, local_specs, cfg=cfg, optimizer=shard_update,
                                         remat=rules.plan.remat,
                                         grad_accum=rules.plan.grad_accum)
    grad_bytes = float(sum(t.numel() * t.element_size() for t in _leaves(state["params"])))
    coll = {"all-gather": _gather_bytes(state["params"], state_sh["params"])}
    if n_data > 1:
        coll["all-reduce"] = grad_bytes
    args = _tree_bytes(state, state_sh) + _tree_bytes(specs, _batch_shardings(rules, specs))
    outs = _tree_bytes(state, state_sh) + _out_bytes(metrics)
    return Trace(c.result(), dshape, coll, {"argument_bytes": args, "output_bytes": outs})


def _serve_trace(cfg, shape, rules, mode) -> Trace:
    aparams = lm.abstract_params(cfg)
    params_sh = rules.tree_shardings(aparams, params_lib.logical_axes(lm.param_spec(cfg)))
    b = device_batch(rules, shape)
    dshape = dataclasses.replace(shape, global_batch=b)
    caches = _meta_caches(cfg, shape.global_batch, shape.seq_len)
    cache_sh = _cache_shardings(rules, caches, cfg)
    local_caches = _meta_caches(cfg, b, shape.seq_len)
    specs = lm.input_specs(cfg, shape)
    local = lm.input_specs(cfg, dshape)
    with meta_trace(), torch.no_grad(), op_counter.OpCounter() as c:
        if mode == "decode":
            logits, _, _ = lm.forward(aparams, cfg, {"tokens": local["tokens"]}, mode="decode",
                                      caches=local_caches, positions=local["positions"],
                                      device="meta", in_place=True)
        else:
            logits, _, _ = lm.forward(aparams, cfg, local, mode="prefill", caches=local_caches,
                                      device="meta", in_place=True)
        last = logits[:, -1]
    cache_bytes = _tree_bytes(caches, cache_sh)
    args = (_tree_bytes(aparams, params_sh) + cache_bytes
            + _tree_bytes(specs, _batch_shardings(rules, specs)))
    return Trace(c.result(), dshape, {"all-gather": _gather_bytes(aparams, params_sh)},
                 {"argument_bytes": args, "output_bytes": cache_bytes + _out_bytes(last)})


def trace_prefill(cfg, shape, mesh, rules) -> Trace:
    return _serve_trace(cfg, shape, rules, "prefill")


def trace_decode(cfg, shape, mesh, rules) -> Trace:
    return _serve_trace(cfg, shape, rules, "decode")


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
                                memory_stats=tr.memory_stats)
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
        )
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK (trace {t_trace:.1f}s, "
              f"dominant={analysis.dominant}, fused={analysis.terms_fused.dominant})",
              flush=True)
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
