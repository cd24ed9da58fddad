"""One rank of the gloo job of ``tests/test_torch_distributed.py``: four CPU
processes on a (data 2, model 2) mesh.  Imports torch and the port only (no
JAX).  Rank 0 writes the training results to ``<out>/rank0.pt``; every rank
writes its compressed all-reduce inputs, codes and scales
(``codes<rank>.npz``), its ring-matmul errors (``ring<rank>.npy``) and the
wrappers that refused a DTensor (``refused<rank>.npy``)."""

from __future__ import annotations

import copy
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ParallelismConfig, get_config
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import ShardingRules, gather, placements_for
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import AdamW
from repro_torch.train import (
    make_train_state,
    make_train_step,
    shard_train_state,
    train_state_shardings,
    train_step,
)

ARCH = "zamba2-1.2b"
BATCH, SEQ, STEPS = 4, 32, 2


def _tree_items(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_items(tree[k], path + (k,))]
    return [("/".join(path), tree)]


def _batches(cfg):
    g = torch.Generator().manual_seed(7)
    return [{"tokens": torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g,
                                     dtype=torch.int32)} for _ in range(STEPS)]


def _train(cfg, out, rank):
    """Two steps, each from the state the unsharded whole-batch step starts
    from: that step and the sharded step (zamba2-1.2b splits over
    ``model``: its ``split``); then the last sharded state saved on (2, 2)
    and restored onto (4, 1) and unsharded."""
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    rules = ShardingRules(mesh=mesh, plan=ParallelismConfig())
    opt = AdamW(schedule=lambda s: 1e-3)
    state0 = make_train_state(cfg, opt, torch.Generator().manual_seed(0), device="cpu")
    plain = copy.deepcopy(state0)
    shardings = train_state_shardings(cfg, opt, rules)
    update = make_train_step(cfg, opt, mesh=mesh, rules=rules)
    losses = {"plain": [], "sharded": []}
    states = {"plain": [], "sharded": []}
    for batch in _batches(cfg):
        sharded = shard_train_state(copy.deepcopy(plain), shardings)
        _, m = train_step(plain, batch, cfg=cfg, optimizer=opt)
        losses["plain"].append(float(m["loss"]))
        _, m = update(sharded, batch)
        losses["sharded"].append(float(m["loss"]))
        states["plain"].append(copy.deepcopy(dict(_tree_items(plain))))
        states["sharded"].append({k: gather(v).clone() for k, v in _tree_items(sharded)})
    # every parameter and moment leaf: its shard on this rank, as the rules say
    shard_shapes = {k: (tuple(v.to_local().shape), tuple(v.placements))
                    for k, v in _tree_items(sharded)}
    gathered = {k: gather(v).clone() for k, v in _tree_items(sharded)}

    ckpt = Checkpointer(os.path.join(out, "ckpt"))
    ckpt.save(STEPS, sharded, blocking=True)
    dist.barrier()
    mesh41 = make_mesh((4, 1), ("data", "model"), device_type="cpu")
    rules41 = ShardingRules(mesh=mesh41, plan=ParallelismConfig())
    sh41 = train_state_shardings(cfg, opt, rules41)
    on41 = ckpt.restore(state0, shardings=sh41)
    placed_as_rules = all(tuple(v.placements) == placements_for(mesh41, s.spec)
                          for (_, v), (_, s) in zip(_tree_items(on41), _tree_items(sh41)))
    restored41 = {k: gather(v) for k, v in _tree_items(on41)}
    unsharded = dict(_tree_items(ckpt.restore(state0, device="cpu")))
    if rank == 0:
        torch.save({"losses": losses, "states": states,
                    "pattern": update.split, "sharded": gathered,
                    "restored41": restored41, "unsharded": unsharded,
                    "placed_as_rules": placed_as_rules, "shard_shapes": shard_shapes},
                   os.path.join(out, "rank0.pt"))


def _compressed(out, rank):
    """The reference test's error-feedback run on the data axis of (2, 2):
    the same gradient on every rank, 20 compressed means accumulated."""
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(32, 32)).astype(np.float32))}
    err = collectives.init_error_buffers(g)
    f = collectives.make_compressed_grad_allreduce(mesh, axis_name="data")
    total_c, total_e = torch.zeros(32, 32), torch.zeros(32, 32)
    corrected, codes, scales = [], [], []
    for _ in range(20):
        c = g["w"] + err["w"]
        q, s = collectives._quantize_block(c)
        corrected.append(c.numpy())
        codes.append(q.numpy())
        scales.append(s.numpy())
        mean, err = f(g, err)
        total_c += mean["w"]
        total_e += g["w"]
    bias = float((total_c - total_e).abs().max() / total_e.abs().max())
    np.savez(os.path.join(out, f"codes{rank}.npz"), corrected=np.stack(corrected),
             codes=np.stack(codes), scales=np.stack(scales), bias=bias)


def _ring(out, rank):
    """x @ w with w's rows over a model axis of 2 (the (2, 2) mesh) and of 4."""
    errs = []
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(32, 24)).astype(np.float32))
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        n, idx = shape[1], mesh.get_local_rank("model")
        rows = 32 // n
        got = collectives.ring_collective_matmul(mesh, x, w[idx * rows:(idx + 1) * rows],
                                                 axis="model")
        errs.append(float((got - x @ w).abs().max()))
    np.save(os.path.join(out, f"ring{rank}.npy"), np.array(errs))


def _dtensor_refused(out, rank):
    """A DTensor handed to a kernel wrapper raises, rather than reading one
    shard through the plain version."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels.flash_attention import mha
    from repro_torch.kernels.layernorm import layernorm
    from repro_torch.kernels.ssd_scan import ssd

    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    q = distribute_tensor(torch.ones(1, 2, 8, 16), mesh, [Replicate(), Replicate()])
    calls = {"flash_attention": lambda: mha(q, q, q),
             "layernorm": lambda: layernorm(q, torch.ones(16)),
             "ssd_scan": lambda: ssd(q, q[..., 0], q, q, chunk=8)}
    refused = []
    for name, call in calls.items():
        try:
            call()
        except TypeError as e:
            if "DTensor" in str(e):
                refused.append(name)
    np.save(os.path.join(out, f"refused{rank}.npy"), np.array(refused))


def run(rank: int, world: int, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out, 'pg')}",
                            rank=rank, world_size=world)
    try:
        cfg = get_config(ARCH, reduced=True)
        _train(cfg, out, rank)
        _compressed(out, rank)
        _ring(out, rank)
        _dtensor_refused(out, rank)
        dist.barrier()  # a gloo rank that leaves early resets its peers
    finally:
        dist.destroy_process_group()
