"""One rank of the gloo job of ``tests/test_torch_shard_decode.py``: two CPU
processes that serve reduced granite-8b under ``ServeConfig.shard_decode``,
rank 0 through ``serve.api.Engine`` and rank 1 through
``serve.api.serve_worker``, one engine per scenario of :data:`SCENARIOS`.
Imports torch and the port only (no JAX).  Reads the parameters the test
wrote (``<out>/inputs.pt``); every rank writes its results to
``<out>/shard<rank>.pt``: rank 0 the streams and its executor's shard and
program counts, rank 1 its own shard and program counts."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.configs import ServeConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.serve import Engine, SamplingParams, StepClock, serve_worker, workloads

ARCH = "granite-8b"
BASE = dict(max_batch=2, max_seq_len=64, prefill_buckets=(8, 16, 32), decode_steps=3,
            temperature=0.0)
PAGED = dict(kv_layout="paged", kv_page_size=8, kv_prefix_cache=True)
#: a tight pool whose residents preempt and whose evicted prefix pages
#: spill to the host tier and swap back (the launcher's combination)
TIGHT = dict(max_seq_len=32, decode_steps=2, kv_layout="paged", kv_page_size=8, kv_pages=5,
             kv_prefix_cache=True, kv_preemption=True, kv_host_pages=16)
EVERYTHING = dict(async_loop=True, trace_phases=True, phase_mode="overlap", scheduler="edf",
                  kv_layout="paged", kv_page_size=8, kv_prefix_cache=True, kv_preemption=True,
                  prefill_chunk=8, speculative=True, spec_tokens=3)
#: name -> (ServeConfig fields, workload); those in ``GREEDY`` are also held
#: against the JAX engine
SCENARIOS = {
    "dense-sync-greedy": (dict(BASE), "greedy"),
    "paged-async-greedy": (dict(BASE, async_loop=True, **PAGED), "greedy"),
    "dense-async-sampled": (dict(BASE, async_loop=True), "sampled"),
    "paged-sync-sampled": (dict(BASE, **PAGED), "sampled"),
    "tight-greedy": (dict(BASE, **TIGHT), "tight"),
    "everything": (dict(BASE, **EVERYTHING), "everything"),
    "undivided-batch": (dict(BASE, max_batch=3, async_loop=True, **PAGED), "greedy"),
}
GREEDY = ("paged-async-greedy", "tight-greedy")
PREFIX = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]  # shared by every prompt: prefix-cache hits
PROMPTS = [PREFIX + tail for tail in ([5, 9, 3, 7], [11, 2, 6], [1, 2, 3, 4, 5, 6, 7], [4, 4],
                                      [8, 1, 6, 2, 9])]
PROGRAM_COUNTS = ("prefill_compiles", "decode_compiles", "extend_compiles",
                  "draft_prefill_compiles")


def engine_kwargs(workload: str) -> dict:
    return {"clock": StepClock()} if workload == "everything" else {}


def run_workload(eng, workload: str) -> dict:
    """The workload's finished requests' tokens, keyed by submission order
    (uid), and the engine's telemetry that the test reads."""
    if workload == "greedy":
        for p in PROMPTS:
            eng.submit(list(p), max_new_tokens=8)
    elif workload == "sampled":  # seeded rows, rows on the engine's generator, a greedy row
        for i, p in enumerate(PROMPTS):
            eng.submit(list(p), SamplingParams(
                max_new_tokens=8, temperature=(0.0, 0.9, 0.7)[i % 3],
                top_k=(None, 12, None)[i % 3], top_p=(None, 0.95, None)[i % 3],
                seed=(None, 7 + i, None)[i % 3]))
    elif workload == "tight":
        for i in range(4):
            eng.submit([3, 1, 4, 1, 5, 9, 2, 6, 7 + i], max_new_tokens=20)
    else:  # everything: EDF replay, mixed sampling and an n-best fork
        cfg = eng.executor.cfg
        events = workloads.poisson(rate=50.0, n=12, vocab_size=cfg.vocab_size, seed=0,
                                   max_new_tokens=6, deadline_s=(0.5, 5.0), shared_prefix=8)
        workloads.replay(eng, events, step_cost=0.1)
        eng.submit([5, 9, 3], SamplingParams(max_new_tokens=4))
        eng.submit([2, 4, 6, 8], SamplingParams(max_new_tokens=4, temperature=0.9, top_k=12,
                                                top_p=0.95, seed=7))
        eng.submit([7, 7, 1], SamplingParams(max_new_tokens=4, temperature=0.7, seed=11), n=2)
    fin = eng.generate()
    tel = eng.telemetry
    keep = ("preemptions", "swap_outs", "swap_ins", "prefix_hits", "forks",
            "draft_tokens_proposed", "cow_copies")
    return dict(streams={uid: tuple(r.generated) for uid, r in sorted(fin.items())},
                tel={k: tel.get(k, 0) for k in keep + PROGRAM_COUNTS})


def _counts(executor) -> dict:
    out = {k: executor.tel.get(k, 0) for k in PROGRAM_COUNTS}
    out["decode_shapes"] = sorted(executor._decode_shapes)
    out["buckets"] = executor.buckets
    if executor.draft is not None:
        out["draft_prefill_shapes"] = len(executor.draft._prefill_shapes)
    shard = executor.shard
    out["shard"] = (shard.lo, shard.hi, shard.split, shard.world)
    return out


def run(rank: int, world: int, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out, 'pg')}",
                            rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
        cfg = get_config(ARCH, reduced=True)
        params = params_from_numpy(inputs["params"], "cpu")
        results = {}
        for name, (fields, workload) in SCENARIOS.items():
            sc = ServeConfig(**fields, shard_decode=True)
            if rank == 0:
                eng = Engine(cfg, params, sc, device="cpu", **engine_kwargs(workload))
                r = run_workload(eng, workload)
                eng.close()
                r["counts"] = _counts(eng.executor)
            else:
                r = {"counts": _counts(serve_worker(cfg, params, sc, device="cpu"))}
            results[name] = r
        torch.save(results, os.path.join(out, f"shard{rank}.pt"))
        dist.barrier()  # a gloo rank that leaves early resets its peers
    finally:
        dist.destroy_process_group()
