"""A closed-loop stream of event batches through the physics encoder, as
offline reprocessing runs it: each batch is copied from pinned host memory
to the card, classified by ``repro_torch.models.physics.forward``, and its
logits copied back; ``depth`` batches are in flight at once, so the next
batch's copy and launches overlap the current one's work.  The batches come
from a pool made in set-up from the seed and are used in turn.

``events_per_s``: events whose logits reached the host inside the window,
over the window's seconds.  Every batch completed in the window is then
compared event by event with the plain reference the configuration names
(its ``logits(events)``) on the same events.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from bench import harness, stats, trace, traffic
from bench.drivers import common


def _sync(dev):
    return (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)


def run(r: harness.Run) -> None:
    from repro_torch.core import precision
    from repro_torch.kernels import build
    from repro_torch.models import attention, layers, physics

    mix, conf, dev = r.traffic, r.config, r.device
    cfg = common.model_config(conf)
    r.mark("imports")
    if dev.type == "cuda":
        build.build_all(tuple(conf["kernels"]))
        r.mark("kernels built or found")
    batch, pool_n, depth = mix["batch"], mix["pool_batches"], mix["depth"]
    raw = common.make_weights(physics.param_spec(cfg), r.seed, dev)
    params = precision.apply_plan_to_params(raw, precision.resolve_model_plan(cfg))
    events = traffic.gw_events(batch * pool_n, r.seed, cfg.seq_len, cfg.input_vec_size)
    pool = torch.from_numpy(events).reshape(pool_n, batch, cfg.seq_len, cfg.input_vec_size)
    on_card = dev.type == "cuda"
    if on_card:
        pool = pool.pin_memory()
    r.mark("weights and events")
    out_host = torch.empty((depth, batch, cfg.n_classes), dtype=torch.float32,
                           pin_memory=on_card)
    sync = _sync(dev)

    def dispatch(k: int):
        x = pool[k % pool_n].to(dev, non_blocking=True)
        logits = physics.forward(params, cfg, x, device=dev)
        out_host[k % depth].copy_(logits, non_blocking=True)
        ev = None
        if on_card:
            ev = torch.cuda.Event()
            ev.record()
        return k, ev

    for k in range(mix["warmup_batches"]):
        dispatch(k)
    sync()
    if r.trace and on_card:
        trace.warm_up(sync, lambda: dispatch(0))
    r.setup_done()

    outputs: dict[int, list[np.ndarray]] = collections.defaultdict(list)
    inflight: collections.deque = collections.deque()
    completed = dispatched = 0
    t0 = time.perf_counter()
    t_end = t0 + r.seconds
    traced = harness.TracedStretch(
        r, t_end, min(r.seconds, mix["trace_seconds"]), sync,
        [(attention, "mha", "attention", _mha_call), (layers, "layernorm", "layernorm",
                                                       _norm_call)])
    r.counters["forwards_traced"] = 0
    while True:
        traced.poll(time.perf_counter())
        while len(inflight) < depth and time.perf_counter() < t_end:
            inflight.append(dispatch(dispatched))
            dispatched += 1
            r.counters["forwards_traced"] += traced.active
        if not inflight:
            break
        k, ev = inflight.popleft()
        if ev is not None:
            ev.synchronize()
        if time.perf_counter() <= t_end:
            completed += batch
            outputs[k % pool_n].append(out_host[k % depth].numpy().copy())
    traced.close()
    r.window = (t0, t_end)
    r.metrics["events_per_s"] = stats.rate(completed, r.window_s)
    r.counters["events_completed"] = completed
    r.counters["events_per_forward"] = batch
    r.attempted, r.failed = dispatched * batch, 0
    if on_card:
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

    del params, out_host
    common.free_device_memory()
    check(r, raw, pool, outputs)


def _mha_call(q, k, v, *, causal=False, window=None, mode="safe", kv_len=None):
    return (tuple(q.shape), tuple(k.shape), tuple(v.shape), str(q.dtype).removeprefix("torch."),
            bool(causal), mode)


def _norm_call(x, gamma, beta=None, *, use_lut=False, rms=False, eps=1e-5, precision=None):
    return (tuple(x.shape), str(x.dtype).removeprefix("torch."),
            str(gamma.dtype).removeprefix("torch."), bool(rms), bool(use_lut))


def compare(out: np.ndarray, ref: np.ndarray, tol: float) -> tuple[int, int, float]:
    """(events over ``tol``, events, largest |out - ref|) of one batch."""
    err = np.abs(out.astype(np.float64) - ref.astype(np.float64)).max(axis=-1)
    if not np.all(np.isfinite(out)):
        return len(err), len(err), float("inf")
    return int((err > tol).sum()), len(err), float(err.max())


def _judge(r: harness.Run, ref, pool, outputs) -> tuple[int, int, float]:
    """(events over the tolerance, events, largest |out - ref|) of the
    batches in ``outputs`` against ``ref`` on their events."""
    tol = r.config["check"]["event_tol"]
    over = total = 0
    worst = 0.0
    for idx, outs in outputs.items():
        want = ref.logits(pool[idx].to(r.device)).cpu().numpy()
        for out in outs:
            o, n, m = compare(out, want, tol)
            over, total, worst = over + o, total + n, max(worst, m)
    return over, total, worst


def check(r: harness.Run, raw, pool, outputs) -> None:
    """Every completed batch against the reference on its events."""
    conf = r.config
    ref = harness.reference(conf).build(raw, conf["model_config"], conf["policy"])
    over, total, worst = _judge(r, ref, pool, outputs)
    del ref
    if total == 0:
        r.checks["window_without_output"] = (1.0, 0.0)  # nothing to compare: not correct
        return
    r.kept.update(raw=raw, pool=pool)
    numbers = {"events_off_share": over / total, "max_abs_logit_err": worst}
    r.checks.update({k: (v, conf["check"][k]) for k, v in numbers.items() if k in conf["check"]})


def control(r: harness.Run, kwargs: dict) -> dict:
    """The numbers ``check`` compares, of the reference built with a
    control's ``kwargs`` in the program's place, over the run's pool."""
    conf = r.config
    raw, pool = r.kept["raw"], r.kept["pool"]
    ref = harness.reference(conf).build(raw, conf["model_config"], conf["policy"])
    ctl = harness.reference(conf).build(raw, conf["model_config"], conf["policy"], **kwargs)
    outputs = {i: [ctl.logits(pool[i].to(r.device)).cpu().numpy()] for i in range(len(pool))}
    over, total, worst = _judge(r, ref, pool, outputs)
    return {"events_off_share": over / total, "max_abs_logit_err": worst}
