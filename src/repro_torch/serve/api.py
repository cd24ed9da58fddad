"""Client-facing serving API: submit / stream / cancel / generate (port of
``repro.serve.api``).

The top layer of the Scheduler / Executor / Engine split (see
``serve/scheduler.py`` for the layering contract).  :class:`Engine`
wires a scheduling policy to a :class:`~repro_torch.serve.executor.ModelExecutor`
and exposes the request lifecycle the batch-only ``run()`` API could
not express:

* :meth:`Engine.submit` — enqueue a prompt, get a :class:`RequestHandle`.
* :meth:`Engine.stream` — iterate :class:`TokenEvent`s as they are
  produced (time-to-first-token and inter-token latency are the event
  timestamp deltas).  Pumping any one stream advances the whole engine;
  events for other requests buffer on their own handles, so interleaved
  streams each see their full ordered token sequence.
* :meth:`Engine.cancel` — drop a queued request, or evict a resident one
  and free its KV pages immediately.
* :meth:`Engine.generate` — the batch convenience wrapper (submit
  everything, run to completion, return finished requests) that
  ``ServingEngine.run()`` callers migrate to.

The engine loop is single-threaded: each :meth:`Engine.step` asks the
scheduler for an explicit
:class:`~repro_torch.serve.scheduler.ScheduleDecision` and has the
executor apply it, synchronously, or under ``ServeConfig.async_loop``
pipelined: the step dispatches its decision and collects the previous
step's (:meth:`Engine._step_async`).  ``submit(..., n=k)`` fans a prompt
into k candidates (n-best), which fork off the first one's pages where the
datapath can replay.  All telemetry is merged from the two layers plus the
cache manager under :attr:`Engine.telemetry` (the reference's key set).
The engine runs on the card unless it is given ``device="cpu"``.

Under ``ServeConfig.shard_decode`` in a process group of several ranks
(``torchrun``), rank 0 builds the :class:`Engine` and every other rank
calls :func:`serve_worker` with the same arguments: the slots split over
the ranks (``serve.executor``), the API and the scheduler stay on rank 0,
and :meth:`Engine.close` ends the workers.
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import time
import warnings
from collections.abc import Iterator
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import trace
from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.device import resolve_device
from repro_torch.serve.executor import InflightStep, ModelExecutor
from repro_torch.serve.phases import make_tracer
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import FifoScheduler, Request, Scheduler
from repro_torch.serve.slo import DeadlineScheduler

#: finish reasons stamped on the terminal TokenEvent / request
FINISH_EOS = "eos"
FINISH_LENGTH = "length"
FINISH_CANCELLED = "cancelled"
#: dropped past-deadline by the SLO scheduler (serve/slo.py); the
#: terminal event carries no token (token == NO_TOKEN)
FINISH_DEADLINE = "deadline"

#: sentinel ``TokenEvent.token`` for a tokenless terminal event (a
#: deadline drop is an answer — "this request will not be served" — not
#: a generated token)
NO_TOKEN = -1

#: ServeConfig.scheduler name -> default policy class
SCHEDULERS = {"fifo": FifoScheduler, "edf": DeadlineScheduler}


def _draft_model(serve_cfg: ServeConfig, draft, seed: int, device):
    """Speculative decoding's draft ``(config, params)``: ``draft`` when
    given, else the named ``ServeConfig.draft_config`` from the port's
    registry (reduced), on weights drawn from a generator on the device
    seeded with ``seed``; None without speculation or with the target as
    its own draft.  The executor rejects a draft whose vocabulary differs
    from the target's."""
    if draft is not None or not serve_cfg.speculative:
        return draft
    if serve_cfg.draft_config in (None, "self"):
        return None
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    dev = resolve_device(device)
    dcfg = get_config(serve_cfg.draft_config, reduced=True)
    return dcfg, lm.init_params(dcfg, torch.Generator(device=dev).manual_seed(seed), device=dev)


def serve_worker(cfg: ModelConfig, params, serve_cfg: ServeConfig, kernel: dict | None = None,
                 seed: int = 0, draft: tuple | None = None, *,
                 device: str | torch.device = "cuda") -> ModelExecutor:
    """A worker rank of a ``shard_decode`` engine (``ServeConfig.shard_decode``
    in a process group of several ranks): build the executor that rank 0's
    :class:`Engine` builds from the same arguments, then run the device
    programs rank 0 sends, on this rank's slots, until rank 0's engine
    closes (:meth:`Engine.close`); returns the worker's executor.  An error
    on any rank fails the run: there is no fallback to fewer ranks."""
    if not serve_cfg.shard_decode:
        raise ValueError("serve_worker serves a shard_decode engine: set "
                         "ServeConfig.shard_decode")
    executor = ModelExecutor(cfg, params, serve_cfg, kernel=kernel, seed=seed,
                             draft=_draft_model(serve_cfg, draft, seed, device), device=device)
    return executor.serve_worker()


def _accepts_clock(factory: Callable) -> bool:
    """Whether a scheduler factory takes a ``clock`` keyword (built-ins
    do; pre-existing custom factories keep the 3-argument contract)."""
    try:
        params = inspect.signature(factory).parameters
    except (TypeError, ValueError):
        return False
    return "clock" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
    )


@dataclasses.dataclass(frozen=True)
class RequestHandle:
    """Opaque ticket for a submitted request."""

    uid: int


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One generated token, stamped when its decode/prefill dispatch
    result reached the host.  ``index`` is the token's position in the
    request's generated sequence; ``finished`` marks the request's final
    token (``finish_reason`` in {"eos", "length"}).  A cancelled request
    simply stops producing events — cancellation is not a token."""

    uid: int
    token: int
    index: int
    ts: float
    finished: bool = False
    finish_reason: str | None = None


class Engine:
    """Streaming serving engine: a scheduling policy (default
    :class:`~repro_torch.serve.scheduler.FifoScheduler`) driving a
    :class:`~repro_torch.serve.executor.ModelExecutor`.

    ``scheduler_factory`` swaps the policy: it is called with
    ``(serve_cfg, executor.caps, executor.cache_mgr)`` — plus
    ``clock=`` when its signature accepts one — and must return a
    :class:`~repro_torch.serve.scheduler.Scheduler`.  Without a factory,
    ``ServeConfig.scheduler`` picks the policy ("fifo" or "edf").

    ``clock`` is the engine's time source for every wait / deadline /
    TokenEvent stamp (default ``time.perf_counter``).  Pass a
    :class:`~repro_torch.serve.workloads.StepClock` to run queueing and SLO
    dynamics in deterministic simulation time; phase tracing
    (``ServeConfig.trace_phases``) always measures real host/device
    seconds regardless.

    ``draft`` is speculative decoding's ``(config, params)``; without it a
    ``ServeConfig.draft_config`` other than None / "self" names a config of
    the port's registry (its reduced shape), on weights drawn from a
    ``torch.Generator`` on the engine's device seeded with ``seed``.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        serve_cfg: ServeConfig | None = None,
        kernel: dict | None = None,
        seed: int = 0,
        scheduler_factory: Callable[..., Scheduler] | None = None,
        clock: Callable[[], float] | None = None,
        replica: int = 0,
        draft: tuple | None = None,
        *,
        device: str | torch.device = "cuda",
    ):
        sc_in = serve_cfg or ServeConfig()
        if sc_in.shard_decode and dist.is_initialized() and dist.get_rank() != 0:
            raise ValueError(
                f"rank {dist.get_rank()} of a shard_decode engine runs serve_worker; the Engine "
                "(its API and scheduler) lives on rank 0")
        self.executor = ModelExecutor(
            cfg, params, serve_cfg, kernel=kernel, seed=seed, replica=replica,
            draft=_draft_model(sc_in, draft, seed, device), device=device,
        )
        self.serve_cfg = self.executor.serve_cfg
        self.clock = clock if clock is not None else time.perf_counter
        self._tracer = make_tracer(
            self.serve_cfg.trace_phases, self.serve_cfg.phase_ring,
            mode=self.serve_cfg.phase_mode,
        )
        if (self.serve_cfg.trace_phases and self.serve_cfg.async_loop
                and self.serve_cfg.phase_mode == "fenced"):
            warnings.warn(
                "trace_phases with phase_mode='fenced' fences every "
                "dispatch, serializing the async_loop pipeline it is "
                "measuring; use phase_mode='overlap' for non-destructive "
                "overlap accounting",
                UserWarning,
                stacklevel=2,
            )
        self.executor.tracer = self._tracer
        #: the dispatched-but-uncollected step (the async loop's double buffer)
        self._inflight: InflightStep | None = None
        if scheduler_factory is None:
            try:
                factory = SCHEDULERS[self.serve_cfg.scheduler]
            except KeyError:
                raise ValueError(
                    f"unknown ServeConfig.scheduler "
                    f"{self.serve_cfg.scheduler!r}; "
                    f"expected one of {sorted(SCHEDULERS)}"
                ) from None
        else:
            factory = scheduler_factory
        args = (self.serve_cfg, self.executor.caps, self.executor.cache_mgr)
        if _accepts_clock(factory):
            self.scheduler: Scheduler = factory(*args, clock=self.clock)
        else:  # older custom factories keep the 3-arg contract
            self.scheduler = factory(*args)
        if self.serve_cfg.speculative and self.executor.draft is None:
            # the executor warned; the port also lists it with the scheduler's
            # disabled knobs (the reference only warns)
            self.scheduler.stats["disabled_features"].append(
                "speculative: drafts verify through the cache-extending prefill "
                "program, which this datapath does not support")
        self._uid = 0
        #: engine steps taken (the ``engine.step`` span's ``step``)
        self._steps = 0
        self._requests: dict[int, Request] = {}
        self._finished: dict[int, Request] = {}
        self._finish_reason: dict[int, str] = {}
        self._events: dict[int, collections.deque[TokenEvent]] = {}
        self._run_tel: dict[str, float] = {}
        #: SLO accounting over requests that carried a deadline —
        #: engine-level so FIFO engines report misses too (the
        #: EDF-vs-FIFO comparison needs both sides measured)
        self._slo = {
            "deadline_requests": 0,
            "deadline_missed": 0,
            "deadline_dropped": 0,
        }

    # --------------------------------------------------------- lifecycle --
    def close(self) -> None:
        """End a ``shard_decode`` engine's worker ranks (their
        :func:`serve_worker` returns); a no-op for an engine of one rank.
        The engine takes no step after it."""
        self.executor.close()

    def submit(
        self,
        prompt: list[int],
        params: SamplingParams | None = None,
        *,
        max_new_tokens: int | None = None,
        eos_id: int | None = None,
        deadline_s: float | None = None,
        n: int = 1,
    ) -> RequestHandle | list[RequestHandle]:
        """Enqueue a prompt.  Per-request knobs ride a
        :class:`~repro_torch.serve.sampling.SamplingParams` (or the keyword
        shortcuts); returns a handle for :meth:`stream` / :meth:`cancel`
        / :meth:`result`.

        ``n > 1`` fans the prompt into n independent candidates (n-best)
        and returns a list of n handles.  Where the scheduler can fork
        (paged layout, a replayable datapath) the siblings map the first
        candidate's live pages copy-on-write, so the prompt prefills once;
        otherwise each sibling prefills on its own.  A seeded request's
        siblings get consecutive seeds (seed + i); unseeded siblings diverge
        through the engine's generator.

        ``deadline_s`` is the request's completion budget in seconds
        from now (engine clock); None inherits
        ``ServeConfig.deadline_ms`` when set.  Deadlines are advisory
        under FIFO (misses are counted in telemetry) and enforced by the
        EDF policy (``ServeConfig.scheduler="edf"``)."""
        if params is None:
            params = SamplingParams(
                max_new_tokens=16 if max_new_tokens is None else max_new_tokens,
                eos_id=eos_id,
            )
        elif max_new_tokens is not None or eos_id is not None:
            raise ValueError(
                "pass either SamplingParams or the keyword shortcuts, not both"
            )
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if params.temperature is not None and params.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {params.temperature}"
            )
        if params.top_k is not None and params.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {params.top_k}")
        if params.top_p is not None and not 0.0 < params.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {params.top_p}"
            )
        if params.seed is not None and params.seed < 0:
            raise ValueError(f"seed must be >= 0, got {params.seed}")
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.serve_cfg.max_seq_len:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_seq_len "
                f"{self.serve_cfg.max_seq_len}"
            )
        if deadline_s is None and self.serve_cfg.deadline_ms is not None:
            deadline_s = self.serve_cfg.deadline_ms / 1e3
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        cache = self.executor.cache_mgr
        need = cache.pages_for(
            min(len(prompt) + params.max_new_tokens, self.serve_cfg.max_seq_len)
        )
        if need > cache.pages_capacity:
            raise ValueError(
                f"request needs {need} KV pages (prompt {len(prompt)} + "
                f"up to {params.max_new_tokens} new tokens) but the pool only "
                f"holds {cache.pages_capacity}; raise "
                "ServeConfig.kv_pages or lower max_new_tokens"
            )
        handles = []
        fork_of = None
        for i in range(n):
            now = self.clock()
            req = Request(
                self._uid + 1, list(prompt),
                params.max_new_tokens, params.eos_id,
                created_at=now, submitted_at=now,
                deadline_at=None if deadline_s is None else now + deadline_s,
            )
            req.temperature = params.temperature
            req.top_k = params.top_k
            req.top_p = params.top_p
            req.seed = (
                None if params.seed is None else params.seed + i
            )
            req.fork_of = fork_of
            self._uid += 1
            self._requests[req.uid] = req
            self._events[req.uid] = collections.deque()
            self.scheduler.enqueue(req)
            handles.append(RequestHandle(req.uid))
            if fork_of is None:
                fork_of = req.uid
        return handles if n > 1 else handles[0]

    def cancel(self, handle: RequestHandle | int) -> bool:
        """Cancel a request: a queued one is dropped before it ever
        prefills; a resident one is evicted and its KV pages return to
        the pool immediately.  Returns False when the request already
        finished (nothing to cancel)."""
        uid = handle.uid if isinstance(handle, RequestHandle) else handle
        if uid in self._finished or uid not in self._requests:
            return False
        req = self.scheduler.remove(uid)
        if req is None:
            for idx, slot in enumerate(self.executor.slots):
                if slot.active and slot.request.uid == uid:
                    req = slot.request
                    self.executor.release(idx)
                    break
        if req is None:  # not queued, not resident: raced a finish
            return False
        req.cancelled = True
        self._finished[uid] = req
        self._finish_reason[uid] = FINISH_CANCELLED
        return True

    def result(self, handle: RequestHandle | int) -> Request | None:
        """The finished request, or None while it is still queued/running."""
        uid = handle.uid if isinstance(handle, RequestHandle) else handle
        return self._finished.get(uid)

    def request(self, handle: RequestHandle | int) -> Request:
        """The live request record (queued, resident, or finished) —
        e.g. for submit timestamps while a stream is still open."""
        uid = handle.uid if isinstance(handle, RequestHandle) else handle
        return self._requests[uid]

    def finish_reason(self, handle: RequestHandle | int) -> str | None:
        uid = handle.uid if isinstance(handle, RequestHandle) else handle
        return self._finish_reason.get(uid)

    @property
    def has_work(self) -> bool:
        return (
            bool(self.scheduler.queue)
            or any(s.active for s in self.executor.slots)
            # an uncollected dispatch still owes tokens and finishes (the
            # async loop's drain: one more step collects it)
            or (self._inflight is not None and not self._inflight.empty)
        )

    # -------------------------------------------------------------- loop --
    def _route_output(self, out, ts: float) -> None:
        """Route one collected step's emissions into per-request event
        queues and finish bookkeeping, stamping everything with ``ts``, the
        engine clock at the step's dispatch (its collect under the
        synchronous loop, one step earlier under the async loop, so both
        loops give the same virtual-clock timelines)."""
        with trace.span("route", tokens=len(out.tokens)):
            finished_uids = {req.uid for req in out.finished}
            reasons = {
                req.uid: (
                    FINISH_EOS
                    if req.eos_id is not None
                    and req.generated
                    and req.generated[-1] == req.eos_id
                    else FINISH_LENGTH
                )
                for req in out.finished
            }
            last_index = {
                req.uid: len(req.generated) - 1 for req in out.finished
            }
            for uid, token, index in out.tokens:
                final = uid in finished_uids and index == last_index[uid]
                self._events.setdefault(uid, collections.deque()).append(TokenEvent(
                    uid=uid, token=token, index=index, ts=ts,
                    finished=final,
                    finish_reason=reasons[uid] if final else None,
                ))
            for req in out.finished:
                req.finished_at = ts
                self._finished[req.uid] = req
                self._finish_reason[req.uid] = reasons[req.uid]
            self._account_slo(out.finished)

    def _route_dropped(self, dropped, ts: float) -> None:
        """Finish past-deadline drops: the scheduler removed them from
        its queue; they finish here with a tokenless terminal event so
        every consumer (stream / generate / result) sees an answered
        request."""
        if not dropped:
            return
        with trace.span("route", dropped=len(dropped)):
            for req in dropped:
                req.finished_at = ts
                self._finished[req.uid] = req
                self._finish_reason[req.uid] = FINISH_DEADLINE
                self._events.setdefault(req.uid, collections.deque()).append(
                    TokenEvent(
                        uid=req.uid, token=NO_TOKEN, index=len(req.generated),
                        ts=ts, finished=True, finish_reason=FINISH_DEADLINE,
                    )
                )
            self._account_slo(dropped)

    def _account_slo(self, reqs) -> None:
        for req in reqs:
            if req.deadline_at is None:
                continue
            self._slo["deadline_requests"] += 1
            dropped = self._finish_reason.get(req.uid) == FINISH_DEADLINE
            self._slo["deadline_dropped"] += dropped
            self._slo["deadline_missed"] += (
                dropped or req.finished_at > req.deadline_at
            )

    def step(self) -> dict:
        """One engine iteration: ``scheduler.schedule`` then
        ``executor.execute``; route the step's emissions into per-request
        event queues, finish any past-deadline drops the policy reported,
        and stamp SLO accounting.  Under ``ServeConfig.async_loop`` the
        execute splits across steps (:meth:`_step_async`)."""
        if self.executor.async_loop:
            return self._step_async()
        tr = self._tracer
        tr.begin_step()
        self._steps += 1
        with trace.span("engine.step", step=self._steps):
            decision = self._schedule()
            out = self.executor.execute(decision)
            now = self.clock()
            self._route_output(out, now)
            self._route_dropped(decision.dropped, now)
        stats = out.stats
        stats.update(
            prefill_compiles=self.executor.tel["prefill_compiles"],
            decode_compiles=self.executor.tel["decode_compiles"],
        )
        tr.end_step()
        return stats

    def _schedule(self):
        with trace.span("schedule") as sp:
            decision = self.scheduler.schedule(self.executor.slots)
            sp.set(admissions=len(decision.admissions))
        return decision

    def _step_async(self) -> dict:
        """One pipelined iteration: schedule and *dispatch* step N, then
        *collect* step N-1, so N-1's decode steps run on the device under
        N's schedule and host_prep.  The stats returned (and the tokens
        routed) are N-1's, stamped with its dispatch-time clock.  The
        scheduler sees host slot state one step stale for in-flight slots;
        collect checks every slot against its dispatch-time snapshot and
        ``admit_seq``, so tokens of a slot preempted, cancelled or turned
        over meanwhile are discarded (a preempted request regenerates
        them), and deadline drops touch queued requests only."""
        tr = self._tracer
        tr.begin_step()
        self._steps += 1
        with trace.span("engine.step", step=self._steps):
            decision = self._schedule()
            inflight = self.executor.dispatch(decision)
            inflight.dispatched_at = self.clock()
            self._route_dropped(decision.dropped, inflight.dispatched_at)
            prev, self._inflight = self._inflight, inflight
            stats = {"prefilled": 0, "decoded": 0}
            if prev is not None:
                out = self.executor.collect(prev)
                ts = prev.dispatched_at if prev.dispatched_at is not None else self.clock()
                self._route_output(out, ts)
                stats = out.stats
        stats.update(
            prefill_compiles=self.executor.tel["prefill_compiles"],
            decode_compiles=self.executor.tel["decode_compiles"],
        )
        tr.end_step()
        return stats

    def stream(self, handle: RequestHandle | int) -> Iterator[TokenEvent]:
        """Yield the request's :class:`TokenEvent`s in order, pumping the
        engine as needed.  Other requests progress on the same pumps;
        their events buffer for their own streams.  The iterator ends
        after the request's final event (or silently on cancellation)."""
        uid = handle.uid if isinstance(handle, RequestHandle) else handle
        if uid not in self._requests:
            raise KeyError(f"unknown request {uid}")
        queue = self._events.get(uid, collections.deque())
        while True:
            while queue:
                yield queue.popleft()
            if uid in self._finished or not self.has_work:
                # a finished request emits no further events: release the
                # (drained) buffer so a long-lived engine stays bounded
                self._events.pop(uid, None)
                return
            self.step()

    def generate(
        self,
        prompts: list[list[int]] | None = None,
        params: SamplingParams | None = None,
        *,
        max_new_tokens: int = 16,
        eos_id: int | None = None,
        max_steps: int = 10_000,
    ) -> dict[int, Request]:
        """Batch convenience wrapper (the ``ServingEngine.run`` migration
        target): optionally submit ``prompts`` (all with the same
        sampling params), run the engine until idle, and return every
        finished request keyed by uid — including requests submitted
        earlier through :meth:`submit`.

        Buffered :class:`TokenEvent`s of requests that finished are
        discarded on return (generated tokens live on the Request):
        streams opened before this call drain normally, but the batch
        path never accumulates per-token event state across waves."""
        if prompts is not None:
            sp = params or SamplingParams(
                max_new_tokens=max_new_tokens, eos_id=eos_id
            )
            for prompt in prompts:
                self.submit(prompt, sp)
        t0 = time.perf_counter()
        tokens0 = self.executor.tel["tokens_generated"]
        steps = 0
        while self.has_work and steps < max_steps:
            self.step()
            steps += 1
        dt = time.perf_counter() - t0
        self._run_tel["run_wall_s"] = dt
        self._run_tel["tokens_per_s"] = (
            self.executor.tel["tokens_generated"] - tokens0
        ) / max(dt, 1e-9)
        admitted = max(self.scheduler.stats["prompts_admitted"], 1)
        self._run_tel["queue_wait_s_mean"] = (
            self.scheduler.stats["queue_wait_s_total"] / admitted
        )
        self._run_tel["queue_wait_created_s_mean"] = (
            self.scheduler.stats["queue_wait_created_s_total"] / admitted
        )
        # finished requests emit no further events; dropping their
        # buffers keeps a wave-after-wave batch engine O(resident), not
        # O(tokens ever generated).  Open streams hold their own deque
        # reference and still drain what was buffered before this call.
        for uid in [u for u in self._events if u in self._finished]:
            del self._events[uid]
        return dict(self._finished)

    # --------------------------------------------------------- telemetry --
    @property
    def telemetry(self) -> dict:
        """Merged view over the scheduler, executor, cache-manager, and
        run-level counters (the historical monolith's key set)."""
        tel = dict(self.executor.tel)
        tel.update(self.scheduler.stats)
        tel.update(self.executor.cache_mgr.stats().as_dict())
        tel.update(self._run_tel)
        tel.update(self._slo)
        #: per-phase latency summary ({} unless ServeConfig.trace_phases)
        tel["phases"] = self._tracer.summary()
        return tel

    def kv_stats(self) -> dict:
        return self.executor.kv_stats()
