"""Serving launcher of the port: the continuous-batching ``Engine`` on
synthetic requests, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 4

``--arch`` picks a ported config (reduced widths unless ``--full-config``),
with random weights from seed 0; every engine flag comes from the shared
serving CLI (``serve/cli.py``).  ``--stream`` consumes the requests through
``Engine.stream`` and reports time to first token.  ``--replicas N`` puts
the ``ReplicaRouter`` in front of N engines; ``--shard-decode`` runs in a
process group of one rank that the launcher starts (gloo on the CPU, NCCL
on the card) and ends.
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.api import Engine
from repro_torch.serve.cli import add_serving_args, config_from_args
from repro_torch.serve.router import ReplicaRouter


@contextlib.contextmanager
def one_rank_group(dev: torch.device):
    """A ``torch.distributed`` process group of this process alone (what
    ``shard_decode``'s host mesh spans), ended on exit."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/pg", rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    add_serving_args(ap, max_batch=4, max_seq=128, max_new=16, temperature=0.0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with one_rank_group(dev) if args.shard_decode else contextlib.nullcontext():
        serve(args, dev)


def serve(args: argparse.Namespace, dev: torch.device) -> None:
    """Serve ``args.requests`` synthetic requests and print the engine's
    (or, with replicas, the fleet's) telemetry."""
    cfg = configs.get_config(args.arch, reduced=not args.full_config)
    serve_cfg = config_from_args(args, cfg)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    # replicas > 1: the same request-lifecycle API behind the least-loaded
    # data-parallel router
    eng = (ReplicaRouter(cfg, params, serve_cfg, device=dev) if serve_cfg.replicas > 1
           else Engine(cfg, params, serve_cfg, device=dev))
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
    if isinstance(eng, ReplicaRouter):
        fleet = eng.telemetry
        print(f"router: {fleet['replicas']} replicas | {fleet['tokens_generated']} tokens total | "
              f"per-replica admitted "
              f"{[t['prompts_admitted'] for t in fleet['replica_telemetry']]}")
        eng = eng.engines[0]  # the detailed lines: the first replica's view
    tel = eng.telemetry
    mode = "async (pipelined)" if eng.serve_cfg.async_loop else "sync"
    print(f"engine loop: {mode}" + (" | mesh-sharded decode" if eng.serve_cfg.shard_decode
                                    else ""))
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
    if args.kv_host_pages:
        print(f"victim tier: {tel['swap_outs']} spills / {tel['swap_ins']} swap-ins | "
              f"host pages {tel['host_pages_used']}/{tel['host_pages_capacity']} "
              f"({tel['host_evictions']} tier evictions) | "
              f"swap time {tel['swap_latency_s'] * 1e3:.1f} ms")
    if args.speculative:
        print(f"speculative: draft={args.draft or 'self'} k={args.spec_tokens} | "
              f"proposed {tel['draft_tokens_proposed']} / accepted "
              f"{tel['draft_tokens_accepted']} | {tel['spec_dispatches']} verify dispatches, "
              f"{tel['extend_dispatches']} extend dispatches")
    if args.scheduler == "edf" or args.deadline_ms is not None:
        print(f"slo: scheduler={args.scheduler} | {tel['deadline_requests']} deadlined "
              f"requests, {tel['deadline_missed']} missed ({tel['deadline_dropped']} dropped)")
    if tel["phases"]:
        print("phases (ms): " + " | ".join(
            f"{name} p50 {s['p50_ms']:.2f} / p95 {s['p95_ms']:.2f}"
            for name, s in tel["phases"].items() if isinstance(s, dict)
        ))
        if "overlap_efficiency" in tel["phases"]:
            ph = tel["phases"]
            print(f"overlap: device hidden {ph['device_overlap_s']:.3f}s | "
                  f"host bubble {ph['host_bubble_s']:.3f}s | "
                  f"efficiency {ph['overlap_efficiency']:.3f}")


if __name__ == "__main__":
    main()
