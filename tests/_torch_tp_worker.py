"""One rank of the gloo job of ``tests/test_torch_tensor_parallel.py``: four
CPU processes that run the reduced dense GQA, MoE, MLA, Mamba2 and hybrid
configs, the audio encoder, the VLM and granite-8b under ``int8_serve``
split over the model axis of a (data 2, model 2) and a (data 1, model 4)
mesh; the (data 4, model 1) mesh whose group of one must leave the
step as it was; a data-sharded MoE step whose capacity binds, on (data 2,
model 2) and on (data 2, model 1) (a (replica 2, data 2, model 1) mesh:
two independent replicas, the rules split nothing over ``replica``); and a
``loss_mask`` whose data shards hold unequal sums.  Imports torch and the
port only (no JAX).  Reads the parameters and batches the test wrote
(``<out>/inputs.pt``); every rank writes its results to
``<out>/tp<rank>.pt``."""

from __future__ import annotations

import copy
import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch.configs import ParallelismConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import precision as precision_lib
from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.distributed.sharding import ShardingRules, gather, local_shard, shard_of
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.optim import AdamW
from repro_torch.train import make_train_step, shard_train_state, train_step
from repro_torch.train.step import (batch_data_group, make_loss_fn, split_params,
                                    train_state_shardings, value_and_grad)

#: a case is an architecture, or "<architecture>:<precision policy>"
ARCHS = ("granite-8b", "granite-moe-3b-a800m", "starcoder2-7b", "minicpm-2b", "dbrx-132b",
         "minicpm3-4b", "mamba2-130m", "zamba2-1.2b", "hubert-xlarge", "internvl2-1b",
         "granite-8b:int8_serve")
MESHES = ((2, 2), (1, 4))
LR = 1e-3
PROMPT, DECODE = 8, 4
MOE_CF = 0.75  # granite-moe's capacity factor in the whole-batch cases: capacity binds
MOE_MESHES = {"2x1": ((2, 2, 1), ("replica", "data", "model")),
              "2x2": ((2, 2), ("data", "model"))}


def case_config(name: str):
    """The reduced config of a case name (module ``ARCHS``)."""
    arch, _, policy = name.partition(":")
    cfg = get_config(arch, reduced=True)
    return dataclasses.replace(cfg, precision=policy) if policy else cfg


def _batches(inp):
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in inp["batches"]]


def _items(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _items(tree[k], path + (k,))]
    return [("/".join(path), tree)]


def _state(cfg, opt, params_np):
    params = params_from_numpy(params_np, "cpu")
    return {"params": params, "opt": opt.init(params)}


def _data_mean(t, mesh):
    """``t``'s mean over the data axis, as the sharded step averages."""
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    t = t.clone()
    dist.all_reduce(t, group=mesh.get_group("data"))
    return t / n


def _grads(cfg, mesh, step, plain, sharded, batch):
    """Each leaf's split gradient on this rank's data shard of ``batch``
    (under the batch's data group, as the step computes it), averaged over
    the data axis, against the unsharded gradient of the whole batch, cut
    as the split step holds the leaf (its model shard, or whole); the
    metrics likewise (those the loss computes for the whole batch as they
    are)."""
    local, group = step.keywords["local"], step.keywords["group"]
    rules = step.keywords["rules"]
    rows = {k: local_shard(v, rules.batch_sharding(v.ndim, shape=tuple(v.shape)))
            for k, v in batch.items()}
    data = batch_data_group(mesh, rules, batch)
    params = split_params(sharded["params"], local, mesh)
    (_, m_split), g_split = value_and_grad(make_loss_fn(cfg, group=group, data=data), params,
                                           rows)
    (_, m_whole), g_whole = value_and_grad(make_loss_fn(cfg), plain["params"], batch)
    sh = step.keywords["shardings"]["params"]
    errs, shapes = {}, {}
    for (k, g), (_, w), (_, loc), (_, s), (_, p) in zip(
            _items(g_split), _items(g_whole), _items(local), _items(sh), _items(params)):
        want = shard_of(w, s.placements, mesh, ("model",)) if loc else w
        errs[k] = float((_data_mean(g, mesh) - want).abs().max())
        shapes[k] = (tuple(p.shape), bool(loc))
    metrics = {k: float((v if k in ("moe_aux_loss", "moe_dropped_frac")
                         else _data_mean(v.float(), mesh)) - m_whole[k])
               for k, v in m_split.items()}
    return errs, shapes, metrics, params, rows


def _model_shards(whole, step, mesh):
    """The split forward's parameters cut from ``whole``: each leaf's model
    shard where the split takes one, else the whole leaf."""
    local, sh = step.keywords["local"], step.keywords["shardings"]["params"]
    return {k: shard_of(w, s.placements, mesh, ("model",)) if loc else w
            for (k, w), (_, loc), (_, s) in zip(_items(whole), _items(local), _items(sh))}


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _serve(cfg, group, step, mesh, plain, rows):
    """``lm.forward`` logits, and (not for the encoder) a prefill plus
    greedy decode steps, split against unsharded, from this rank's rows.
    The weights are the precision plan's transform of the whole leaves,
    cut after it (the serving executor's order); the caches are int8
    where the plan says so, and the VLM's prefill takes the patches before
    the prompt's tokens, its decode continuing after them."""
    plan = precision_lib.resolve_model_plan(cfg)
    whole = precision_lib.apply_plan_to_params(plain["params"], plan)
    params = _nest(_model_shards(whole, step, mesh))
    inputs = {k: v for k, v in rows.items() if k != "labels"}
    split = lm.forward(params, cfg, inputs, device="cpu", group=group)[0]
    if split.shape[-1] < cfg.padded_vocab_size:
        split = tp_lib.all_gather(split, group, -1)
    full = lm.forward(whole, cfg, inputs, device="cpu")[0]
    out = dict(logits_err=float((split - full).abs().max()), decode_errs=[],
               split_tokens=torch.zeros(0), whole_tokens=torch.zeros(0), cache_shapes={},
               cache_stays_local={})
    if cfg.is_encoder:  # no caches, no decode step
        return out
    tokens = rows["tokens"]
    b = tokens.shape[0]
    off = cfg.n_frontend_tokens if "patches" in rows else 0
    caches = lm.init_caches(cfg, b, off + PROMPT + DECODE, torch.float32,
                            quantized=plan.int8_kv_cache, device="cpu")
    local = tp_lib.local_caches(cfg, caches, group)
    cache_shapes = {k: tuple(t.shape) for k, t in _items(local)}
    prompt = dict(inputs, tokens=tokens[:, :PROMPT])
    s_last, s_c = lm.prefill(params, cfg, prompt, local, device="cpu", group=group)
    w_last, w_c = lm.prefill(whole, cfg, prompt, caches, device="cpu")
    errs, s_tok, w_tok = [float((s_last - w_last).abs().max())], [], []
    for i in range(DECODE):
        st, wt = s_last.argmax(-1, keepdim=True), w_last.argmax(-1, keepdim=True)
        s_tok.append(st)
        w_tok.append(wt)
        pos = torch.full((b,), off + PROMPT + i, dtype=torch.int32)
        s_last, s_c = lm.decode_step(params, cfg, st, pos, s_c, device="cpu", group=group)
        w_last, w_c = lm.decode_step(whole, cfg, wt, pos, w_c, device="cpu")
        errs.append(float((s_last - w_last).abs().max()))
    out.update(decode_errs=errs, split_tokens=torch.cat(s_tok, 1), whole_tokens=torch.cat(w_tok, 1),
               cache_shapes=cache_shapes,
               cache_stays_local={k: tuple(t.shape) for k, t in _items(s_c)})
    if cfg.attn_kind == "mla":
        out.update(_mla_modes(cfg, group, params, plain, tokens))
    return out


def _mla_modes(cfg, group, params, plain, tokens):
    """MLA's absorbed decode (``kernel["mla_absorb"]``) and a
    cache-extending window (``mode="extend"``) of ``DECODE`` tokens, each
    from one prefill of the prompt, split against unsharded."""
    b = tokens.shape[0]
    caches = lm.init_caches(cfg, b, PROMPT + DECODE, torch.float32, device="cpu")
    prompt = {"tokens": tokens[:, :PROMPT]}
    _, s_c = lm.prefill(params, cfg, prompt, tp_lib.local_caches(cfg, caches, group),
                        device="cpu", group=group)
    _, w_c = lm.prefill(plain["params"], cfg, prompt, caches, device="cpu")
    absorb = {"mla_absorb": True}
    pos = torch.full((b,), PROMPT, dtype=torch.int32)
    tok = tokens[:, PROMPT:PROMPT + 1]
    s_last, _ = lm.decode_step(params, cfg, tok, pos, s_c, kernel=absorb, device="cpu",
                               group=group)
    w_last, _ = lm.decode_step(plain["params"], cfg, tok, pos, w_c, kernel=absorb, device="cpu")
    window = {"tokens": tokens[:, PROMPT:PROMPT + DECODE]}
    wpos = (PROMPT + torch.arange(DECODE, dtype=torch.int32))[None].expand(b, DECODE)
    s_ext = lm.forward(params, cfg, window, mode="extend", caches=s_c, positions=wpos,
                       device="cpu", group=group)[0]
    if s_ext.shape[-1] < cfg.padded_vocab_size:
        s_ext = tp_lib.all_gather(s_ext, group, -1)
    w_ext = lm.forward(plain["params"], cfg, window, mode="extend", caches=w_c, positions=wpos,
                       device="cpu")[0]
    return dict(absorbed_decode_err=float((s_last - w_last).abs().max()),
                extend_err=float((s_ext - w_ext).abs().max()))


def _case(arch, shape, inp):
    cfg = case_config(arch)
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    rules = ShardingRules(mesh=mesh, plan=ParallelismConfig())
    opt = AdamW(schedule=lambda s: LR)
    state0 = _state(cfg, opt, inp["params"])
    plain = copy.deepcopy(state0)
    shardings = train_state_shardings(cfg, opt, rules)
    sharded = shard_train_state(copy.deepcopy(state0), shardings)
    step = make_train_step(cfg, opt, mesh=mesh, rules=rules)
    batches = _batches(inp)
    grad_errs, shapes, metric_errs, params, rows = _grads(cfg, mesh, step, plain, sharded,
                                                          batches[0])
    serve = _serve(cfg, step.keywords["group"], step, mesh, plain, rows)
    held = {k: tuple(v.to_local().shape) for k, v in _items(sharded["params"])}
    steps = []
    for batch in batches:  # each split step from the state the unsharded step starts from
        before = copy.deepcopy(dict(_items(plain)))
        sharded = shard_train_state(copy.deepcopy(plain), shardings)
        _, m_plain = train_step(plain, batch, cfg=cfg, optimizer=opt)  # the whole batch
        _, m_split = step(sharded, batch)
        steps.append(dict(
            before=before, split={k: gather(v).clone() for k, v in _items(sharded)},
            plain=copy.deepcopy(dict(_items(plain))),
            loss={"split": float(m_split["loss"]), "plain": float(m_plain["loss"])}))
    return dict(split=step.split, grad_errs=grad_errs, compute_shapes=shapes, held_shapes=held,
                metric_errs=metric_errs, serve=serve, steps=steps,
                layout=dataclasses.asdict(step.keywords["group"].layout),
                collective_bytes=dict(step.keywords["group"].bytes))


def _whole_batch_steps(cfg, mesh, inp, batches):
    """Two sharded steps (``make_train_step(mesh=, rules=)``), each from the
    state the unsharded whole-batch step starts from, against that step:
    losses and every metric, states gathered."""
    rules = ShardingRules(mesh=mesh, plan=ParallelismConfig())
    opt = AdamW(schedule=lambda s: LR)
    plain = _state(cfg, opt, inp["params"])
    shardings = train_state_shardings(cfg, opt, rules)
    step = make_train_step(cfg, opt, mesh=mesh, rules=rules)
    steps = []
    for batch in batches:
        before = copy.deepcopy(dict(_items(plain)))
        sharded = shard_train_state(copy.deepcopy(plain), shardings)
        _, m_plain = train_step(plain, batch, cfg=cfg, optimizer=opt)
        _, m_split = step(sharded, batch)
        steps.append(dict(
            before=before, split={k: gather(v).clone() for k, v in _items(sharded)},
            plain=copy.deepcopy(dict(_items(plain))),
            metrics={"split": {k: float(v) for k, v in m_split.items()},
                     "plain": {k: float(v) for k, v in m_plain.items()}}))
    return dict(split=step.split, steps=steps)


def _moe_whole_batch(inp):
    """Reduced granite-moe-3b-a800m at ``MOE_CF``, data-sharded on each of
    ``MOE_MESHES``, against the unsharded step on the whole batch."""
    base = get_config("granite-moe-3b-a800m", reduced=True)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=MOE_CF))
    batches = _batches(inp)
    return {name: _whole_batch_steps(cfg, make_mesh(shape, axes, device_type="cpu"), inp,
                                     batches)
            for name, (shape, axes) in MOE_MESHES.items()}


def _masked(inp):
    """Reduced granite-8b on (data 2, model 2) with a ``loss_mask`` whose
    data shards hold unequal sums, against the whole-batch step."""
    cfg = get_config("granite-8b", reduced=True)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    batches = [dict(b, loss_mask=torch.from_numpy(inp["mask"])) for b in _batches(inp)]
    return _whole_batch_steps(cfg, mesh, inp, batches)


def _group_of_one(inp):
    """On (data 4, model 1): the step on the old path (within float32
    rounding of the unsharded step over the whole batch, its MoE layers
    the whole batch's), and ``lm.forward`` under a group of one bitwise the
    forward without one."""
    cfg = get_config("granite-moe-3b-a800m", reduced=True)
    mesh = make_mesh((4, 1), ("data", "model"), device_type="cpu")
    rules = ShardingRules(mesh=mesh, plan=ParallelismConfig())
    opt = AdamW(schedule=lambda s: LR)
    state0 = _state(cfg, opt, inp["params"])
    plain = copy.deepcopy(state0)
    sharded = shard_train_state(copy.deepcopy(state0), train_state_shardings(cfg, opt, rules))
    step = make_train_step(cfg, opt, mesh=mesh, rules=rules)
    batch = _batches(inp)[0]
    _, m_plain = train_step(plain, batch, cfg=cfg, optimizer=opt)
    _, m_step = step(sharded, batch)
    group = tp_lib.model_group(mesh)
    one = lm.forward(plain["params"], cfg, batch, device="cpu", group=group)[0]
    none = lm.forward(plain["params"], cfg, batch, device="cpu")[0]
    return dict(split=step.split, step_group=step.keywords.get("group"), group_size=group.size,
                forward_equal=torch.equal(one, none),
                loss_err=abs(float(m_plain["loss"]) - float(m_step["loss"])),
                dropped_equal=float(m_plain["moe_dropped_frac"]) == float(
                    m_step["moe_dropped_frac"]),
                state_close=max(float((gather(v).float() - p.float()).abs().max())
                                for (_, v), (_, p) in zip(_items(sharded), _items(plain))))


def run(rank: int, world: int, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out, 'pg')}",
                            rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
        results = {f"{arch}@{shape[0]}x{shape[1]}": _case(arch, shape, inputs[arch])
                   for arch in ARCHS for shape in MESHES}
        results["one"] = _group_of_one(inputs["granite-moe-3b-a800m"])
        results["moe_whole_batch"] = _moe_whole_batch(inputs["granite-moe-3b-a800m"])
        results["masked"] = _masked(inputs["granite-8b"])
        torch.save(results, os.path.join(out, f"tp{rank}.pt"))
        dist.barrier()  # a gloo rank that leaves early resets its peers
    finally:
        dist.destroy_process_group()
