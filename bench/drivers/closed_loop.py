"""Closed-loop clients of the serving engine (``repro_torch.serve.api.Engine``):
each of ``clients`` clients sends its next request as soon as its previous
one has finished, so the queue holds about ``clients - max_batch``
requests all through the window.  The loop pumps ``Engine.step`` and reads
each request's ``TokenEvent`` s from its stream.

- ``ttft_p95_ms``: the 95th percentile, over every request sent inside the
  window, of its first token's ``TokenEvent.ts`` less the moment the client
  sent it; after the window the engine is pumped, with nothing more sent,
  until each of those requests has its first token (a request that never
  gets one counts as missing).
- ``output_tokens_per_s``: the output tokens whose ``TokenEvent.ts`` falls
  inside the window, over the window's seconds.

Correctness: a sample of the finished requests, drawn from the seed with
the longest among them, is run through the plain reference the
configuration names (its ``logits(tokens, prompt_len)``), prompt and served
tokens together, and each served token's reference logit is held against
the reference's best at its position.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench import harness, stats, trace, traffic
from bench.drivers import common


def _sync(dev):
    return (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)


class Client:
    """One request in flight and what its stream delivered."""

    def __init__(self, k: int, uid: int, sent: float, prompt: list[int], max_new: int, it):
        self.k, self.uid, self.sent, self.prompt, self.max_new = k, uid, sent, prompt, max_new
        self.it, self.ts, self.tokens, self.finished = it, [], [], False


def run(r: harness.Run) -> None:
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels import build
    from repro_torch.models import attention, lm
    from repro_torch.serve.api import Engine
    from repro_torch.serve.sampling import SamplingParams

    mix, conf, dev = r.traffic, r.config, r.device
    cfg = common.model_config(conf)
    r.mark("imports")
    if dev.type == "cuda":
        build.build_all(tuple(conf["kernels"]))
        r.mark("kernels built or found")
    raw = common.make_weights(lm.param_spec(cfg), r.seed, dev)
    r.mark("weights")
    engine = Engine(cfg, raw, ServeConfig(**conf["serve"], policy=conf["policy"]), device=dev)
    r.mark("engine")
    stream = traffic.RequestStream(mix, r.seed, cfg.vocab_size)
    sync = _sync(dev)
    # warm-up: one request per prefill bucket the mix reaches, and the decode steps
    warm = np.random.default_rng(traffic.seed_sequence(r.seed, 3))
    engine.generate([warm.integers(0, cfg.vocab_size, n).tolist()
                     for n in mix["warmup_prompt_tokens"]],
                    SamplingParams(max_new_tokens=mix["warmup_new_tokens"]))
    sync()
    if r.trace and dev.type == "cuda":
        trace.warm_up(sync, lambda: torch.ones(1, device=dev).add_(1))
    r.setup_done()

    clients: dict[int, Client] = {}
    live: list[Client] = []
    sent = 0

    def send() -> None:
        nonlocal sent
        prompt, max_new = stream.prompt(sent), stream.max_new(sent)
        t = time.perf_counter()
        h = engine.submit(prompt, SamplingParams(max_new_tokens=max_new))
        c = Client(sent, h.uid, t, prompt, max_new, engine.stream(h))
        clients[h.uid] = c
        live.append(c)
        sent += 1

    def collect() -> list[Client]:
        done = []
        for c in live:
            req = engine.request(c.uid)
            while len(c.tokens) < len(req.generated):
                ev = next(c.it)
                c.ts.append(ev.ts)
                c.tokens.append(ev.token)
            if engine.result(c.uid) is not None:
                c.finished = True
                done.append(c)
        for c in done:
            live.remove(c)
        return done

    t0 = time.perf_counter()
    t_end = t0 + r.seconds
    traced = harness.TracedStretch(
        r, t_end, min(r.seconds, mix["trace_seconds"]), sync,
        [(attention, "mha", "attention", _mha_call)])
    for _ in range(mix["clients"]):
        send()
    while time.perf_counter() < t_end:
        traced.poll(time.perf_counter())
        engine.step()
        for _ in collect():
            if time.perf_counter() < t_end:
                send()
    traced.close()
    r.window = (t0, t_end)
    # the first token of every request sent in the window, counted in no rate
    wait_end = time.perf_counter() + mix["first_token_wait_s"]
    while any(not c.ts for c in live) and time.perf_counter() < wait_end and engine.has_work:
        engine.step()
        collect()
    if dev.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

    all_clients = list(clients.values())
    ttft = [(c.ts[0] - c.sent) if c.ts else float("inf") for c in all_clients]
    r.metrics["ttft_p95_ms"] = stats.percentile(ttft, 95) * 1e3
    out_tokens = sum(stats.in_window(c.ts, t0, t_end) for c in all_clients)
    r.metrics["output_tokens_per_s"] = stats.rate(out_tokens, r.window_s)
    r.attempted, r.failed = len(all_clients), sum(1 for c in all_clients if not c.ts)
    r.requests = [{"sent": c.sent, "ts": list(c.ts), "prompt_len": len(c.prompt),
                   "admitted": engine.request(c.uid).admitted_at} for c in all_clients]
    finished = [c for c in all_clients if c.finished]
    for c in all_clients:  # each stream holds the engine
        c.it = None
    del engine
    common.free_device_memory()
    check(r, raw, finished)


def _mha_call(q, k, v, *, causal=False, window=None, mode="safe", kv_len=None):
    return (tuple(q.shape), tuple(k.shape), tuple(v.shape), str(q.dtype).removeprefix("torch."),
            bool(causal), mode)


def sample(r: harness.Run, finished: list[Client], n: int) -> list[Client]:
    """``n`` finished requests drawn from the seed, the longest among them."""
    if not finished:
        return []
    longest = max(finished, key=lambda c: (len(c.prompt) + len(c.tokens), c.k))
    rest = sorted((c for c in finished if c is not longest), key=lambda c: c.k)
    rng = np.random.default_rng(traffic.seed_sequence(r.seed, 4))
    picks = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(picks)]


def reference(r: harness.Run, raw, **control):
    conf = r.config
    return harness.reference(conf).build(raw, conf["model_config"], conf["policy"], **control)


def ref_logits(ref, c: Client, device) -> torch.Tensor:
    seq = torch.tensor(c.prompt + c.tokens[:-1], dtype=torch.int64, device=device)
    return ref.logits(seq, len(c.prompt))


def served_gaps(ref_logits: torch.Tensor, prompt_len: int, served: list[int]) -> torch.Tensor:
    """For each served token, how far its reference logit lies below the
    reference's best at the position that produced it."""
    rows = ref_logits[prompt_len - 1: prompt_len - 1 + len(served)]
    chosen = rows[torch.arange(len(served), device=rows.device),
                  torch.tensor(served, device=rows.device)]
    return rows.max(dim=-1).values - chosen


def check(r: harness.Run, raw, finished: list[Client]) -> None:
    lim = r.config["check"]
    picked = sample(r, finished, lim["requests"])
    if not picked:
        r.checks["window_without_output"] = (1.0, 0.0)  # nothing to compare: not correct
        return
    with torch.no_grad():
        ref = reference(r, raw)
        gaps = [served_gaps(ref_logits(ref, c, r.device), len(c.prompt), c.tokens)
                for c in picked]
    r.kept.update(raw=raw, picked=picked)
    gap = torch.cat(gaps)
    r.counters["tokens_checked"] = int(gap.numel())
    r.checks["max_served_gap"] = (float(gap.max()), lim["max_served_gap"])


def control(r: harness.Run, kwargs: dict) -> dict:
    """The number ``check`` compares, with the tokens a control (the
    reference built with ``kwargs``) puts first at each position of the same
    prompts and served tokens in place of the served ones."""
    picked = r.kept["picked"]
    gaps = []
    with torch.no_grad():
        ref = reference(r, r.kept["raw"])
        refs = [ref_logits(ref, c, r.device).cpu() for c in picked]
        del ref
        ctl = reference(r, r.kept["raw"], **kwargs)
        for c, rl in zip(picked, refs):
            top = ref_logits(ctl, c, r.device).cpu()[len(c.prompt) - 1:][:len(c.tokens)]
            gaps.append(served_gaps(rl, len(c.prompt), top.argmax(dim=-1).tolist()))
        del ctl
    return {"max_served_gap": float(torch.cat(gaps).max())}
