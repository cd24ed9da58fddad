#!/usr/bin/env python3
"""A short first look at training the Mamba2 and hybrid families on one
CUDA device, before the whole of ``chip_smoke.py``'s phase 8.

    python3 tools/ssm_train_probe.py

Prints, each part on its own and none stopping the others:
- whether ``torch.cumsum`` of a float64 CUDA tensor raises under
  ``torch.use_deterministic_algorithms(True)`` (the plain SSD scan's prefix
  sums, which ``SSDScan``'s backward recomputes);
- ``SSDScan``'s gradients against torch autograd through the plain scan at
  mamba2-130m's (2, 2048, 24, 64, N 128) and zamba2-1.2b's (2, 2048, 64,
  64, N 64) widths, float32 and bf16, with fwd + bwd ms (CUDA events)
  beside the plain version's;
- ``run_training`` of the reduced mamba2-130m and zamba2-1.2b, then of
  mamba2-130m at 24 layers and zamba2-1.2b at 7 layers, float32, 2 x 2048,
  under deterministic algorithms: losses, step seconds, launches, peak GB;
- the sharded step (``make_train_step(mesh=, rules=)``) on a one-card NCCL
  mesh against the unsharded step, reduced zamba2-1.2b, two steps: the
  leaves that differ (none when bitwise).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
BUILD = ROOT / "build"


def part(name, fn):
    t0 = time.perf_counter()
    try:
        fn()
        print(f"[probe] {name}: ok {time.perf_counter() - t0:.1f} s", flush=True)
    except Exception:  # noqa: BLE001 - report the part's failure and go on with the next
        traceback.print_exc()
        print(f"[probe] {name}: FAILED {time.perf_counter() - t0:.1f} s", flush=True)


def cumsum_deterministic(dev):
    import torch

    torch.use_deterministic_algorithms(True)
    try:
        torch.cumsum(torch.ones(4, 8, device=dev, dtype=torch.float64), -1)
        print("cumsum f64 deterministic: no raise")
    except RuntimeError as e:
        print("cumsum f64 deterministic raises:", str(e)[:120])
    finally:
        torch.use_deterministic_algorithms(False)


def ssd_grads(dev):
    import torch

    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_with_state

    def ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters

    for (b, l, h, p, n, g) in ((2, 2048, 24, 64, 128, 1), (2, 2048, 64, 64, 64, 1)):
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator().manual_seed(l + h)
            xs = [torch.randn(b, l, h, p, generator=gen) * 0.5,
                  -torch.randn(b, l, h, generator=gen).abs() * 0.3,
                  torch.randn(b, l, g, n, generator=gen) * 0.5,
                  torch.randn(b, l, g, n, generator=gen) * 0.5]
            ins = [t.to(dev, dt).requires_grad_() for t in xs]
            y, _ = ssd_with_state(*ins, chunk=64)
            assert "SSDScan" in type(y.grad_fn).__name__, type(y.grad_fn).__name__
            dy = torch.randn(y.shape, generator=gen).to(dev, dt)
            gr = torch.autograd.grad(y, ins, dy)
            rep = h // g

            def plain(*t):
                return ssd_chunked(t[0].float(), t[1].float(),
                                   t[2].float().repeat_interleave(rep, 2),
                                   t[3].float().repeat_interleave(rep, 2), chunk=64)

            ref = torch.autograd.grad(plain(*ins)[0].to(dt), ins, dy)
            torch.cuda.synchronize()
            errs = [float((a.float() - r.float()).abs().max())
                    / max(1.0, float(r.float().abs().max())) for a, r in zip(gr, ref)]

            def fwd_bwd(f):
                return lambda: torch.autograd.grad(f(*ins)[0], ins, dy)

            kernel_ms = ms(fwd_bwd(lambda *t: ssd_with_state(*t, chunk=64)))
            print(f"ssd grad {(b, l, h, p, n, g)} {dt}: rel errs {errs} fwd+bwd "
                  f"{kernel_ms:.3f} ms plain {ms(fwd_bwd(plain)):.3f} ms", flush=True)


def train(dev, name, n_layers=None, steps=3, shape=(2, 32), reduced=True):
    import torch

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    from repro_torch.kernels import LAUNCHES
    from repro_torch.train import run_training

    cfg = dataclasses.replace(get_config(name, reduced=reduced), dtype="float32",
                              **({} if n_layers is None else {"n_layers": n_layers}))
    b, l = shape
    ds = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=l, global_batch=b))
    tc = TrainConfig(total_steps=steps, checkpoint_every=100, warmup_steps=1, learning_rate=3e-4)
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory(dir=BUILD) as d:
            t0 = time.perf_counter()
            r = run_training(cfg, tc, ds.batch, workdir=d, log_every=1, device=dev)
            total = time.perf_counter() - t0
        print(f"{name} {cfg.n_layers}L {shape}: losses {[m['loss'] for m in r.metrics_history]} "
              f"step s {[round(m['step_time_s'], 3) for m in r.metrics_history]} total "
              f"{total:.1f} s launches {dict(LAUNCHES)} peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True


def sharded_one_card(dev):
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ParallelismConfig, get_config
    from repro_torch.distributed.sharding import ShardingRules, gather
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamW
    from repro_torch.train import (make_train_state, make_train_step, shard_train_state,
                                   train_state_shardings, train_step)

    work = tempfile.mkdtemp(dir=BUILD)
    dist.init_process_group("nccl", init_method=f"file://{work}/pg", rank=0, world_size=1)
    try:
        cfg = get_config("zamba2-1.2b", reduced=True)
        mesh = make_mesh((1, 1), ("data", "model"))
        rules = ShardingRules(mesh=mesh, plan=ParallelismConfig())
        opt = AdamW(schedule=lambda s: 1e-3)
        s0 = make_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(0), device=dev)
        plain = copy.deepcopy(s0)
        sharded = shard_train_state(copy.deepcopy(s0), train_state_shardings(cfg, opt, rules))
        update = make_train_step(cfg, opt, mesh=mesh, rules=rules)
        g = torch.Generator().manual_seed(1)
        torch.use_deterministic_algorithms(True)
        for _ in range(2):
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32), generator=g,
                                             dtype=torch.int32).to(dev)}
            train_step(plain, batch, cfg=cfg, optimizer=opt)
            update(sharded, batch)
        torch.use_deterministic_algorithms(False)

        def leaves(t, p=()):
            if isinstance(t, dict):
                return [x for k in sorted(t) for x in leaves(t[k], p + (k,))]
            return [(p, t)]

        bad = [p for (p, a), (_, b) in zip(leaves(plain), leaves(sharded))
               if not torch.equal(a, gather(b))]
        print("nccl world-1 sharded vs unsharded differing leaves:", bad, flush=True)
    finally:
        dist.barrier()
        dist.destroy_process_group()


def main() -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("ssm_train_probe: no CUDA device", file=sys.stderr)
        return 2
    BUILD.mkdir(exist_ok=True)
    dev = torch.device("cuda")
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    part("cumsum", lambda: cumsum_deterministic(dev))
    part("ssd grads", lambda: ssd_grads(dev))
    part("mamba reduced", lambda: train(dev, "mamba2-130m"))
    part("zamba reduced", lambda: train(dev, "zamba2-1.2b"))
    part("mamba full 24L", lambda: train(dev, "mamba2-130m", reduced=False, shape=(2, 2048)))
    part("zamba full 7L", lambda: train(dev, "zamba2-1.2b", n_layers=7, reduced=False,
                                        shape=(2, 2048)))
    part("sharded one card", lambda: sharded_one_card(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
