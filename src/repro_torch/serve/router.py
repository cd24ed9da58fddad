"""Data-parallel replica routing (port of ``repro.serve.router``): N
engines, one front door.

A :class:`ReplicaRouter` owns ``ServeConfig.replicas`` independent
:class:`~repro_torch.serve.api.Engine` instances (each with its own
scheduler, executor, KV pool and program counts) and routes each submitted
request to the least-loaded replica at admission.  Replicas share no
request state, so everything one engine guarantees (token identity, the
program budget, cancel and preemption, the async loop) holds per replica;
the router multiplexes the request-lifecycle API over them:

* :meth:`submit`: the replica with the fewest open requests (queued +
  resident) wins, ties to the lowest index, so a fixed submission order
  routes deterministically; n-best siblings stay on one replica.
* :meth:`stream` / :meth:`result` / :meth:`cancel`: delegate to the owning
  replica; router handles carry router-level uids (TokenEvents are
  re-stamped on the way out).
* :meth:`step` pumps every replica with work; :meth:`generate` runs them
  all to idle.
* :attr:`telemetry`: per-replica telemetries plus fleet sums.

The params are shared by reference: N replicas on one card read the same
weight tensors and cost N KV pools, not N copies of the weights.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.serve.api import Engine, RequestHandle, TokenEvent
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Request, Scheduler

#: telemetry counters summed across replicas (the fleet-level view)
_SUMMED = (
    "tokens_generated",
    "prefill_dispatches",
    "extend_dispatches",
    "prompts_admitted",
    "preemptions",
    "deadline_requests",
    "deadline_missed",
    "deadline_dropped",
    "draft_tokens_proposed",
    "draft_tokens_accepted",
    "spec_dispatches",
    "gen_pages_shared",
)


class ReplicaRouter:
    """Front door over ``ServeConfig.replicas`` data-parallel engines.

    The signature is :class:`~repro_torch.serve.api.Engine`'s; every
    replica is built from the same config with ``replicas=1`` and the same
    base ``seed``, salted by its replica index (the executor's
    ``_salted_seed``), so unseeded sampled replicas draw distinct streams
    while greedy and per-request seeded streams equal one engine's."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        serve_cfg: ServeConfig | None = None,
        kernel: dict | None = None,
        seed: int = 0,
        scheduler_factory: Callable[..., Scheduler] | None = None,
        clock: Callable[[], float] | None = None,
        draft: tuple | None = None,
        *,
        device: str | torch.device = "cuda",
    ):
        sc = serve_cfg or ServeConfig()
        if sc.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {sc.replicas}")
        if sc.shard_decode and sc.replicas > 1 and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise ValueError("replicas of a shard_decode engine over several ranks: each "
                             "replica would need worker ranks of its own; run one engine")
        per_replica = dataclasses.replace(sc, replicas=1)
        self.serve_cfg = sc
        self.engines = [
            Engine(cfg, params, per_replica, kernel=kernel, seed=seed,
                   scheduler_factory=scheduler_factory, clock=clock, replica=i, draft=draft,
                   device=device)
            for i in range(sc.replicas)
        ]
        self._uid = 0
        #: router uid -> (replica index, that replica's local uid)
        self._route: dict[int, tuple[int, int]] = {}

    def close(self) -> None:
        """``Engine.close`` on every replica."""
        for eng in self.engines:
            eng.close()

    # --------------------------------------------------------- admission --
    def _load(self, idx: int) -> int:
        """Open requests on replica ``idx``: queued + resident (host state
        only, no device sync)."""
        eng = self.engines[idx]
        return len(eng.scheduler.queue) + sum(s.active for s in eng.executor.slots)

    def submit(self, prompt: list[int], params: SamplingParams | None = None,
               **kw) -> RequestHandle | list[RequestHandle]:
        """Admit to the least-loaded replica (ties -> lowest index) and
        return a router-level handle (a list of them for ``n > 1``: the
        siblings stay on one replica, so their pages can be shared)."""
        idx = min(range(len(self.engines)), key=lambda i: (self._load(i), i))
        local = self.engines[idx].submit(prompt, params, **kw)
        out = []
        for lh in local if isinstance(local, list) else [local]:
            self._uid += 1
            self._route[self._uid] = (idx, lh.uid)
            out.append(RequestHandle(self._uid))
        return out if isinstance(local, list) else out[0]

    def replica_of(self, handle: RequestHandle | int) -> int:
        """Which replica a request was routed to."""
        uid = handle.uid if isinstance(handle, RequestHandle) else handle
        return self._route[uid][0]

    def _resolve(self, handle: RequestHandle | int) -> tuple[Engine, int]:
        uid = handle.uid if isinstance(handle, RequestHandle) else handle
        try:
            idx, local = self._route[uid]
        except KeyError:
            raise KeyError(f"unknown request {uid}") from None
        return self.engines[idx], local

    # --------------------------------------------------------- lifecycle --
    def cancel(self, handle: RequestHandle | int) -> bool:
        eng, local = self._resolve(handle)
        return eng.cancel(local)

    def result(self, handle: RequestHandle | int) -> Request | None:
        eng, local = self._resolve(handle)
        return eng.result(local)

    def request(self, handle: RequestHandle | int) -> Request:
        eng, local = self._resolve(handle)
        return eng.request(local)

    def finish_reason(self, handle: RequestHandle | int) -> str | None:
        eng, local = self._resolve(handle)
        return eng.finish_reason(local)

    def stream(self, handle: RequestHandle | int) -> Iterator[TokenEvent]:
        """The owning replica's event stream, re-stamped with the router
        uid; pumping it advances that replica only."""
        uid = handle.uid if isinstance(handle, RequestHandle) else handle
        eng, local = self._resolve(uid)
        for ev in eng.stream(local):
            yield dataclasses.replace(ev, uid=uid)

    @property
    def has_work(self) -> bool:
        return any(eng.has_work for eng in self.engines)

    # -------------------------------------------------------------- loop --
    def step(self) -> dict:
        """One engine iteration on every replica with work; summed stats."""
        total: dict = {}
        for eng in self.engines:
            if eng.has_work:
                for k, v in eng.step().items():
                    total[k] = total.get(k, 0) + v
        return total

    def generate(self, prompts: list[list[int]] | None = None,
                 params: SamplingParams | None = None, *, max_new_tokens: int = 16,
                 eos_id: int | None = None, max_steps: int = 10_000) -> dict[int, Request]:
        """Submit ``prompts`` through least-loaded admission, run every
        replica to idle, and return the finished requests keyed by router
        uid (those submitted earlier through :meth:`submit` too)."""
        if prompts is not None:
            sp = params or SamplingParams(max_new_tokens=max_new_tokens, eos_id=eos_id)
            for prompt in prompts:
                self.submit(prompt, sp)
        steps = 0
        while self.has_work and steps < max_steps:
            self.step()
            steps += 1
        out: dict[int, Request] = {}
        for uid, (idx, local) in self._route.items():
            req = self.engines[idx].result(local)
            if req is not None:
                out[uid] = req
        return out

    # --------------------------------------------------------- telemetry --
    @property
    def telemetry(self) -> dict:
        """``replicas``, per-replica telemetries and routing loads, and the
        fleet sums of the core counters."""
        per = [eng.telemetry for eng in self.engines]
        tel: dict = {
            "replicas": len(self.engines),
            "replica_telemetry": per,
            "replica_loads": [self._load(i) for i in range(len(self.engines))],
        }
        for key in _SUMMED:
            tel[key] = sum(t.get(key, 0) for t in per)
        return tel

    def kv_stats(self) -> list[dict]:
        return [eng.kv_stats() for eng in self.engines]
