"""End-to-end serving example (port of ``examples/serve_lm.py``): serve a
small LM with batched requests through the continuous-batching engine,
with the paper's quantized datapath available through ``--policy``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch granite-8b --requests 12
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu --stream

``--stream`` consumes two interleaved ``Engine.stream`` iterators (the rest
batch behind them) and prints per-token events with time to first token.
Every engine flag comes from the shared serving CLI (``serve/cli.py``); the
engine runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.api import Engine
from repro_torch.serve.cli import add_serving_args, config_from_args


def stream_demo(eng, handles):
    """Interleave the first two streams token by token (both make progress
    on shared engine pumps), then drain the rest."""
    first_ts = {}
    live = [eng.stream(h) for h in handles[:2]]
    while live:
        for it in list(live):
            ev = next(it, None)
            if ev is None:
                live.remove(it)
            else:
                first_ts.setdefault(ev.uid, ev.ts)
                print(f"  [stream] req {ev.uid} token#{ev.index} = {ev.token}"
                      f"{'  <done:' + ev.finish_reason + '>' if ev.finished else ''}")
    for h in handles[2:]:
        for ev in eng.stream(h):
            first_ts.setdefault(ev.uid, ev.ts)
    for h in handles[:3]:
        req = eng.result(h)
        if h.uid not in first_ts:  # a zero-token finish (the sequence cap)
            print(f"  req {h.uid}: no tokens -> {req.generated}")
            continue
        ttft_ms = (first_ts[h.uid] - req.created_at) * 1e3
        print(f"  req {h.uid}: ttft {ttft_ms:.1f} ms -> {req.generated}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--requests", type=int, default=12)
    add_serving_args(ap, max_batch=4, max_seq=128, max_new=16, temperature=0.7)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_config(args.arch, reduced=True)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = Engine(cfg, params, config_from_args(args, cfg), device=dev)
    print(f"serving {cfg.name} ({lm.count_params(cfg):,} params) on {dev}, "
          f"max_batch={args.max_batch}, policy={eng.executor.policy.name}, "
          f"kv_layout={eng.executor.kv_layout}, buckets={eng.executor.buckets or 'exact'}, "
          f"decode_steps={eng.serve_cfg.decode_steps}"
          + (f", prefill_chunk={args.prefill_chunk}" if args.prefill_chunk else ""))

    rng = np.random.default_rng(0)
    preamble = [int(t) for t in rng.integers(0, cfg.vocab_size, args.shared_prefix)]
    handles = [eng.submit(preamble + [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                                   rng.integers(3, 12))],
                          max_new_tokens=args.max_new)
               for _ in range(args.requests)]

    t0 = time.perf_counter()
    if args.stream:
        stream_demo(eng, handles)
    else:
        steps = 0
        while eng.has_work:
            stats = eng.step()
            steps += 1
            if steps % 8 == 0:
                print(f"  step {steps}: active={sum(s.active for s in eng.executor.slots)} "
                      f"queued={len(eng.scheduler.queue)} prefilled={stats['prefilled']} "
                      f"decoded={stats['decoded']}")
    results = {h.uid: eng.result(h) for h in handles}
    dt = time.perf_counter() - t0

    total = sum(len(r.generated) for r in results.values())
    print(f"\ncompleted {len(results)} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {dev})")
    tel = eng.telemetry
    print(f"telemetry: queue wait mean "
          f"{tel['queue_wait_s_total'] / max(tel['prompts_admitted'], 1) * 1e3:.1f} ms | "
          f"{tel['prefill_compiles']} prefill shapes, {tel['decode_compiles']} decode shape, "
          f"{tel['extend_compiles']} extend shape | prefill {tel['prefill_time_s']:.2f}s / "
          f"decode {tel['decode_time_s']:.2f}s")
    print(f"kv cache: layout={tel['kv_layout']} {tel['kv_bytes'] / 2**20:.2f} MiB | "
          f"pages peak {tel['pages_in_use_peak']}/{tel['pages_capacity']} "
          f"(page_size={tel['kv_page_size']})")
    if tel["disabled_features"]:
        print("disabled: " + "; ".join(tel["disabled_features"]))
    if args.speculative:
        acc = tel["draft_tokens_accepted"] / max(tel["draft_tokens_proposed"], 1)
        print(f"speculative: draft={args.draft or 'self'} k={args.spec_tokens} | "
              f"proposed {tel['draft_tokens_proposed']} / accepted "
              f"{tel['draft_tokens_accepted']} (rate {acc:.2f}) | "
              f"{tel['spec_dispatches']} verify dispatches")
    if args.kv_prefix_cache or args.kv_preemption:
        print(f"prefix cache: hit rate {tel['prefix_hit_rate']:.2f} | prefill tokens saved "
              f"{tel['prefill_tokens_saved']} (+{tel['prefix_tokens_shared']} shared-storage) | "
              f"{tel['cow_copies']} CoW copies | {tel['preemptions']} preemptions")
    if args.kv_host_pages:
        print(f"victim tier: {tel['swap_outs']} spills / {tel['swap_ins']} swap-ins | "
              f"host pages {tel['host_pages_used']}/{tel['host_pages_capacity']} "
              f"({tel['host_evictions']} tier evictions) | "
              f"swap time {tel['swap_latency_s'] * 1e3:.1f} ms")
    if args.scheduler == "edf" or args.deadline_ms is not None:
        print(f"slo: scheduler={args.scheduler} | {tel['deadline_requests']} deadlined "
              f"requests, {tel['deadline_missed']} missed ({tel['deadline_dropped']} dropped)")
    if tel["phases"]:
        print("phases (ms):")
        for name, s in tel["phases"].items():
            if isinstance(s, dict):
                print(f"  {name:>10}: p50 {s['p50_ms']:7.2f} | p95 {s['p95_ms']:7.2f} | "
                      f"p99 {s['p99_ms']:7.2f} | total {s['total_s']:.2f}s over {s['n']} steps")
    if not args.stream:
        for h in handles[:3]:
            r = results[h.uid]
            print(f"  req {h.uid}: prompt {r.prompt[:6]}... -> {r.generated}")


if __name__ == "__main__":
    main()
