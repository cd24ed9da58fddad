"""Shared serving CLI (port of ``repro.serve.cli``): one flag set and one
ServeConfig builder for the serving entry points (``launch/serve.py``), so
a new engine knob lands in every CLI by construction.  The port adds
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
On the card the features that need the cache-extending prefill program
(chunked prefill, prefix-skip, preemption resume, speculative decoding)
report themselves disabled, as the reference's Pallas-kernel datapath does;
``--shard-decode`` splits the slots over the ranks of the launcher's
process group (``torchrun``'s world, or one rank).
"""

from __future__ import annotations

import argparse

from repro_torch.configs.base import ServeConfig


def resolve_policy_arg(policy: str | None, quantized: bool, cfg) -> str | None:
    """Shared --policy semantics for the serving CLIs: explicit --policy
    wins; 'auto' resolves to the arch's recommended ``cfg.serve_policy``;
    the deprecated --quantized maps to the int8_serve preset."""
    if policy == "auto":
        return cfg.serve_policy
    if policy is not None:
        return policy
    if quantized:
        return "int8_serve"
    return None


def add_serving_args(
    ap: argparse.ArgumentParser,
    *,
    max_batch: int = 4,
    max_seq: int = 128,
    max_new: int = 16,
    temperature: float = 0.0,
) -> argparse.ArgumentParser:
    """Register the engine flag set (batch/sequence shape, precision
    policy, prefill/decode knobs, KV-cache layout and sharing, chunked
    prefill, streaming).  Per-script defaults ride the keyword args."""
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine runs: the card (default) or, when "
                         "asked, the CPU's plain PyTorch path")
    ap.add_argument("--max-batch", type=int, default=max_batch)
    ap.add_argument("--max-seq", type=int, default=max_seq)
    ap.add_argument("--max-new", type=int, default=max_new)
    ap.add_argument("--temperature", type=float, default=temperature)
    ap.add_argument("--policy", default=None,
                    help="precision policy: a preset name (float, int8_serve, "
                         "paper_vu13p, ptq_fixed<W,I>, qat_fixed<W,I>) or "
                         "'auto' for the arch's recommended serve_policy")
    ap.add_argument("--quantized", action="store_true",
                    help="deprecated alias for --policy int8_serve")
    ap.add_argument("--prefill-buckets", type=int, nargs="*", default=None,
                    help="prompt-length buckets (default: powers of two; "
                         "pass with no values for exact-length v1 prefill)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: admit long prompts one "
                         "chunk-sized dispatch at a time, interleaved with "
                         "resident decode; later chunks ride the "
                         "cache-extending prefill program on every datapath "
                         "(GQA, MLA, int8-KV, LUT softmax; must not exceed "
                         "the largest bucket; requires a bucketable cache)")
    ap.add_argument("--decode-steps", type=int, default=4,
                    help="decode tokens per host dispatch")
    ap.add_argument("--max-prefill-per-step", type=int, default=0,
                    help="cap on prompts admitted per step (0 = all free slots)")
    ap.add_argument("--kv-layout", default="dense",
                    choices=("dense", "paged"),
                    help="KV-cache storage layout: dense per-slot slabs or "
                         "block-table pages (serve/kv_cache.py)")
    ap.add_argument("--kv-page-size", type=int, default=16,
                    help="tokens per page (paged layout; must divide "
                         "--max-seq)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="physical pages in the pool (default: worst case "
                         "max_batch x max_seq / page_size, + trash page)")
    ap.add_argument("--kv-prefix-cache", action="store_true",
                    help="share full prompt pages across same-prefix "
                         "requests (paged layout; copy-on-write)")
    ap.add_argument("--kv-preemption", action="store_true",
                    help="preempt the youngest resident instead of "
                         "head-of-line blocking when the page pool is "
                         "exhausted; resumes are token-exact on every "
                         "datapath (paged layout)")
    ap.add_argument("--kv-host-pages", type=int, default=0,
                    help="host-memory victim tier: pages evicted off the "
                         "prefix-cache LRU spill their rows to a host ring "
                         "of this many pages and swap back into fresh "
                         "device pages on a later prefix hit (paged layout "
                         "with --kv-prefix-cache; 0 = off)")
    ap.add_argument("--no-kv-victim-tier", action="store_true",
                    help="kill switch: keep --kv-host-pages configured but "
                         "never spill or swap (evictions discard rows, as "
                         "without a tier)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a fixed preamble of this many tokens to "
                         "every request (prefix-cache exercise; think "
                         "repeated detector-geometry preambles)")
    ap.add_argument("--no-cache-extend", action="store_true",
                    help="disable the cache-extending prefill program "
                         "(chunked prefill / prefix-skip / preemption fall "
                         "back to bit-exact-datapath gating, as before)")
    ap.add_argument("--speculative", action="store_true",
                    help="speculative decoding: a draft model proposes "
                         "--spec-tokens greedy tokens per slot; the target "
                         "verifies the window in one cache-extending "
                         "dispatch (accept-prefix + correction; greedy "
                         "output stays bitwise identical on bit-exact "
                         "datapaths)")
    ap.add_argument("--draft", default=None,
                    help="draft model for --speculative: a config-zoo arch "
                         "name (reduced shape), or 'self'/omitted for "
                         "self-drafting with the target model")
    ap.add_argument("--spec-tokens", type=int, default=4,
                    help="draft tokens proposed per speculative step "
                         "(capped by the extend window width)")
    ap.add_argument("--stream", action="store_true",
                    help="consume requests through Engine.stream "
                         "(per-token events with TTFT) instead of the "
                         "batch Engine.generate wrapper")
    ap.add_argument("--scheduler", default="fifo",
                    choices=("fifo", "edf"),
                    help="admission policy: fifo (arrival order) or edf "
                         "(earliest-deadline-first, serve/slo.py)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="default per-request completion budget in ms "
                         "(engine clock); advisory under fifo (misses "
                         "are counted), enforced under edf")
    ap.add_argument("--overdue", default="drop",
                    choices=("drop", "demote", "ignore"),
                    help="edf policy for a queued request whose deadline "
                         "passed: drop (finish_reason='deadline'), demote "
                         "(run behind feasible work), or ignore")
    ap.add_argument("--trace-phases", action="store_true",
                    help="per-step phase summaries: each step's spans "
                         "(repro_torch.trace) summed by phase (schedule/"
                         "host_prep/dispatch/device/sample, wall = the "
                         "engine.step span), with device fencing; "
                         "p50/p95/p99 land in Engine.telemetry['phases']. "
                         "Off by default: fencing serializes dispatch")
    ap.add_argument("--phase-mode", default="fenced",
                    choices=("fenced", "overlap"),
                    help="tracer mode under --trace-phases: fenced isolates "
                         "device time by blocking each dispatch; overlap "
                         "never fences and reports, from the spans, "
                         "device_overlap_s (a decode span's end to the "
                         "collect span it caused) / host_bubble_s "
                         "(collect's own time) / overlap_efficiency instead "
                         "(use with --async-loop)")
    ap.add_argument("--async-loop", action="store_true",
                    help="pipelined engine loop: dispatch step N+1 while "
                         "step N's decode scan runs on device; greedy "
                         "token streams stay bit-identical to the "
                         "synchronous loop (results surface one step late)")
    ap.add_argument("--shard-decode", action="store_true",
                    help="place params and KV pools as DTensors over the "
                         "process group's (data, model=1) host mesh and split "
                         "the slots over its ranks: rank 0 serves, the others "
                         "run each dispatch on their slots (the launcher "
                         "joins torchrun's world, or starts a one-rank group; "
                         "one rank: a semantic no-op)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel engines behind one ReplicaRouter "
                         "front door with least-loaded admission (each "
                         "replica owns its KV pool and programs)")
    return ap


def config_from_args(args: argparse.Namespace, model_cfg) -> ServeConfig:
    """Build the ServeConfig from parsed serving args (``model_cfg``
    resolves ``--policy auto`` to the arch's recommended preset)."""
    return ServeConfig(
        max_batch=args.max_batch,
        max_seq_len=args.max_seq,
        temperature=args.temperature,
        policy=resolve_policy_arg(args.policy, args.quantized, model_cfg),
        prefill_buckets=(
            None if args.prefill_buckets is None
            else tuple(args.prefill_buckets)
        ),
        prefill_chunk=args.prefill_chunk,
        decode_steps=args.decode_steps,
        max_prefill_per_step=args.max_prefill_per_step,
        kv_layout=args.kv_layout,
        kv_page_size=args.kv_page_size,
        kv_pages=args.kv_pages,
        kv_prefix_cache=args.kv_prefix_cache,
        kv_preemption=args.kv_preemption,
        kv_host_pages=getattr(args, "kv_host_pages", 0),
        kv_victim_tier=not getattr(args, "no_kv_victim_tier", False),
        cache_extend=not getattr(args, "no_cache_extend", False),
        speculative=getattr(args, "speculative", False),
        spec_tokens=getattr(args, "spec_tokens", 4),
        draft_config=getattr(args, "draft", None),
        scheduler=getattr(args, "scheduler", "fifo"),
        deadline_ms=getattr(args, "deadline_ms", None),
        overdue_policy=getattr(args, "overdue", "drop"),
        trace_phases=getattr(args, "trace_phases", False),
        phase_mode=getattr(args, "phase_mode", "fenced"),
        async_loop=getattr(args, "async_loop", False),
        shard_decode=getattr(args, "shard_decode", False),
        replicas=getattr(args, "replicas", 1),
    )
