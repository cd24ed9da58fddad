"""Training loop with checkpoint/restart, preemption handling, straggler
detection and a heartbeat (port of ``repro.train.loop``).

Restart-exactness contract: the data step is the state's step, and a
deterministic ``batch_fn`` and deterministic kernels mean that a run
killed at any step resumes from its latest checkpoint to bitwise the same
parameters as a straight run (``tests/test_torch_train_loop.py``; on the
card under ``torch.use_deterministic_algorithms(True)``).

With ``mesh=`` (a ``DeviceMesh``) and ``rules=`` every rank of the mesh runs
this loop: the state is held under the rules' shardings on the mesh's
device (``train.step``'s sharded step), a checkpoint is gathered to rank 0,
which writes it, and a restore places each leaf under the shardings,
whatever mesh the checkpoint was saved from (elastic restart).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.loader import to_device
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import gather, mesh_device
from repro_torch.optim import AdamW, make_schedule
from repro_torch.train import step as step_lib
from repro_torch.train.fault_tolerance import (
    FailureInjector,
    Heartbeat,
    PreemptionHandler,
    StepTimer,
)

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopResult:
    final_step: int
    metrics_history: list[dict]
    stragglers: list[tuple[int, float, float]]
    stopped_early: bool
    state: dict  # the final {"params", "opt"}, on the run's device


def run_training(
    cfg: ModelConfig,
    train_cfg: TrainConfig,
    batch_fn: Callable[[int, int, int], dict],
    *,
    workdir: str,
    mesh=None,
    rules=None,
    kernel: dict | None = None,
    remat: str = "none",
    preemption: PreemptionHandler | None = None,
    failure_injector: FailureInjector | None = None,
    log_every: int = 10,
    device: str | torch.device = "cuda",
) -> LoopResult:
    """Train ``cfg`` for ``train_cfg.total_steps`` on ``batch_fn(step, 0, 1)``
    batches, checkpointing into ``workdir/checkpoints`` every
    ``checkpoint_every`` steps, resuming from the latest checkpoint there.
    The parameters are drawn from a generator seeded with
    ``train_cfg.seed`` on ``device`` (the mesh's device, sharded)."""
    sharded = mesh is not None and rules is not None
    dev = mesh_device(mesh) if sharded else resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    optimizer = AdamW(
        schedule=make_schedule(train_cfg),
        b1=train_cfg.b1,
        b2=train_cfg.b2,
        eps=train_cfg.eps,
        weight_decay=train_cfg.weight_decay,
        grad_clip=train_cfg.grad_clip,
    )
    ckpt = Checkpointer(os.path.join(workdir, "checkpoints"), keep=train_cfg.keep_checkpoints)
    update = step_lib.make_train_step(cfg, optimizer, mesh=mesh, rules=rules, kernel=kernel,
                                      remat=remat)

    # ---- restore or init -------------------------------------------------
    generator = torch.Generator(device=dev).manual_seed(train_cfg.seed)
    state = step_lib.make_train_state(cfg, optimizer, generator, device=dev)
    shardings = None
    if sharded:
        shardings = step_lib.train_state_shardings(cfg, optimizer, rules)
        state = step_lib.shard_train_state(state, shardings)
    start_step = 0
    if ckpt.latest_step() is not None:
        state = ckpt.restore(state, shardings=shardings)
        start_step = int(gather(state["opt"]["step"]))
        log.info("restored checkpoint at step %d", start_step)

    preemption = preemption or PreemptionHandler(signals=())
    timer = StepTimer()
    rank = torch.distributed.get_rank() if sharded else 0
    hb = Heartbeat(os.path.join(workdir, "heartbeat" + (f".{rank}" if rank else ""))).start()
    history: list[dict] = []
    stopped_early = False

    try:
        step = start_step
        while step < train_cfg.total_steps:
            if preemption.should_stop:
                log.warning("preemption requested: checkpointing at %d", step)
                ckpt.save(step, state, blocking=True)
                stopped_early = True
                break
            # the global batch, copied off the host arrays first (the sharded
            # step keeps this rank's shard of it)
            batch = to_device(batch_fn(step, 0, 1), dev)
            timer.start()
            if failure_injector is not None:
                failure_injector.maybe_fail(step)
            state, metrics = update(state, batch)
            loss = float(metrics["loss"])  # waits for the step, as block_until_ready
            dt, straggler = timer.stop()
            step += 1
            if straggler:
                log.warning("straggler step %d: %.3fs", step, dt)
            if step % log_every == 0 or step == train_cfg.total_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["loss"] = loss
                m["step"] = step
                m["step_time_s"] = dt
                history.append(m)
                log.info("step %d loss %.4f lr %.2e (%.3fs)", step, loss, m.get("lr", 0), dt)
            if step % train_cfg.checkpoint_every == 0:
                ckpt.save(step, state)
        else:
            ckpt.save(train_cfg.total_steps, state, blocking=True)
        ckpt.wait()
    finally:
        hb.stop()
        ckpt.join()  # a save in flight finishes even when the loop failed

    return LoopResult(final_step=step, metrics_history=history,
                      stragglers=timer.straggler_events, stopped_early=stopped_early,
                      state=state)
