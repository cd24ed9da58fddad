"""Serving launcher of the port: the continuous-batching ``Engine`` on
synthetic requests, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 4

``--arch`` picks a ported config (reduced widths unless ``--full-config``),
with random weights from seed 0; every engine flag comes from the shared
serving CLI (``serve/cli.py``).  ``--stream`` consumes the requests through
``Engine.stream`` and reports time to first token.
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


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    add_serving_args(ap, max_batch=4, max_seq=128, max_new=16, temperature=0.0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_config(args.arch, reduced=not args.full_config)
    serve_cfg = config_from_args(args, cfg)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = Engine(cfg, params, serve_cfg, device=dev)
    rng = np.random.default_rng(0)
    preamble = [int(t) for t in rng.integers(0, cfg.vocab_size, args.shared_prefix)]
    handles = [
        eng.submit(preamble + [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                            rng.integers(4, 16))],
                   max_new_tokens=args.max_new)
        for _ in range(args.requests)
    ]
    t0 = time.perf_counter()
    if args.stream:
        ttfts, toks = [], 0
        for h in handles:
            events = list(eng.stream(h))
            toks += len(events)
            if events:  # a request can legally finish with zero tokens
                ttfts.append(events[0].ts - eng.request(h).created_at)
        dt = time.perf_counter() - t0
        print(f"{len(handles)} requests streamed, {toks} tokens in {dt:.2f}s "
              f"({toks / dt:.1f} tok/s) | ttft p50 {np.percentile(ttfts, 50) * 1e3:.1f} ms / "
              f"p95 {np.percentile(ttfts, 95) * 1e3:.1f} ms"
              if ttfts else f"{len(handles)} requests streamed, {toks} tokens in {dt:.2f}s")
    else:
        results = eng.generate()
        dt = time.perf_counter() - t0
        toks = sum(len(results[h.uid].generated) for h in handles)
        print(f"{len(handles)} requests, {toks} tokens in {dt:.2f}s "
              f"({toks / dt:.1f} tok/s host throughput)")
    tel = eng.telemetry
    queue_wait_ms = tel["queue_wait_s_total"] / max(tel["prompts_admitted"], 1) * 1e3
    print(f"engine: device={dev} | policy={eng.executor.policy.name} | "
          f"queue wait mean {queue_wait_ms:.1f} ms | "
          f"{tel['prefill_compiles']} prefill shapes "
          f"(buckets={eng.executor.buckets or 'exact'}"
          f"{f', chunk={args.prefill_chunk}' if args.prefill_chunk else ''}), "
          f"{tel['decode_compiles']} decode shape (decode_steps={eng.serve_cfg.decode_steps})")
    print(f"kv cache: layout={tel['kv_layout']} {tel['kv_bytes'] / 2**20:.2f} MiB | "
          f"pages {tel['pages_in_use']}/{tel['pages_capacity']} in use "
          f"(peak {tel['pages_in_use_peak']}, page_size={tel['kv_page_size']})")
    if tel["disabled_features"]:
        print("disabled: " + "; ".join(tel["disabled_features"]))
    if args.kv_prefix_cache or args.kv_preemption:
        print(f"prefix cache: hit rate {tel['prefix_hit_rate']:.2f} "
              f"({tel['prefix_hits']}/{tel['prefix_queries']}) | "
              f"prefill tokens saved {tel['prefill_tokens_saved']} "
              f"(+{tel['prefix_tokens_shared']} shared-storage) | "
              f"{tel['pages_cached']} pages retained, {tel['cow_copies']} CoW copies, "
              f"{tel['page_evictions']} evictions | {tel['preemptions']} preemptions")
    if args.scheduler == "edf" or args.deadline_ms is not None:
        print(f"slo: scheduler={args.scheduler} | {tel['deadline_requests']} deadlined "
              f"requests, {tel['deadline_missed']} missed ({tel['deadline_dropped']} dropped)")
    if tel["phases"]:
        print("phases (ms): " + " | ".join(
            f"{name} p50 {s['p50_ms']:.2f} / p95 {s['p95_ms']:.2f}"
            for name, s in tel["phases"].items() if isinstance(s, dict)
        ))


if __name__ == "__main__":
    main()
