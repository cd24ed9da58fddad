"""Serving launcher of the port: the continuous-batching ``Engine`` on
synthetic requests, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 4

``--arch`` picks a ported config (reduced widths unless ``--full-config``),
with random weights from seed 0; every engine flag comes from the shared
serving CLI (``serve/cli.py``).  ``--stream`` consumes the requests through
``Engine.stream`` and reports time to first token.  ``--replicas N`` puts
the ``ReplicaRouter`` in front of N engines.  ``--shard-decode`` runs in
the process group of the world that ``torchrun`` describes (``RANK``,
``WORLD_SIZE``; one rank without it), which the launcher starts (gloo on the
CPU, NCCL on the card) and ends: the slots split over the ranks, rank 0
serves the requests and prints, the other ranks run
``serve.api.serve_worker``.

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu --shard-decode
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
from repro_torch.serve.api import Engine, serve_worker
from repro_torch.serve.cli import add_serving_args, config_from_args
from repro_torch.serve.router import ReplicaRouter


@contextlib.contextmanager
def world_group(dev: torch.device):
    """The ``torch.distributed`` process group that ``shard_decode``'s host
    mesh spans: the world of ``torchrun``'s ``RANK`` / ``WORLD_SIZE`` (its
    ``MASTER_ADDR`` / ``MASTER_PORT`` rendezvous), or this process alone;
    ended on exit.  Two ranks on one card take gloo (NCCL refuses them)."""
    import os

    import torch.distributed as dist

    rank, world = int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))
    if dev.type == "cuda" and world > 1:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    one_card = dev.type == "cuda" and world > torch.cuda.device_count()
    backend = "nccl" if dev.type == "cuda" and not one_card else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        init = "env://" if world > 1 else f"file://{tmp}/pg"
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
        try:
            yield rank
        finally:
            dist.barrier()  # a gloo rank that leaves early resets its peers
            dist.destroy_process_group()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    add_serving_args(ap, max_batch=4, max_seq=128, max_new=16, temperature=0.0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if not args.shard_decode:
        serve(args, dev)
        return
    with world_group(dev) as rank:
        if rank == 0:
            serve(args, dev)
        else:  # the same model and engine arguments as rank 0's
            cfg = configs.get_config(args.arch, reduced=not args.full_config)
            serve_worker(cfg, _params(cfg, dev), config_from_args(args, cfg), device=dev)


def _params(cfg, dev: torch.device):
    """Random weights from seed 0, the same on every rank."""
    return lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)


def serve(args: argparse.Namespace, dev: torch.device) -> None:
    """Serve ``args.requests`` synthetic requests and print the engine's
    (or, with replicas, the fleet's) telemetry."""
    cfg = configs.get_config(args.arch, reduced=not args.full_config)
    serve_cfg = config_from_args(args, cfg)
    params = _params(cfg, dev)
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
    eng.close()  # a shard_decode engine's worker ranks return
    if isinstance(eng, ReplicaRouter):
        fleet = eng.telemetry
        print(f"router: {fleet['replicas']} replicas | {fleet['tokens_generated']} tokens total | "
              f"per-replica admitted "
              f"{[t['prompts_admitted'] for t in fleet['replica_telemetry']]}")
        eng = eng.engines[0]  # the detailed lines: the first replica's view
    tel = eng.telemetry
    mode = "async (pipelined)" if eng.serve_cfg.async_loop else "sync"
    shard = eng.executor.shard
    print(f"engine loop: {mode}" + (
        "" if shard is None else
        f" | mesh-sharded decode over {shard.world} rank(s), rank 0 slots "
        f"[{shard.lo}, {shard.hi})" + (" (every rank every slot)" if shard.world > 1
                                      and not shard.split else "")))
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
