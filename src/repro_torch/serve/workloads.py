"""Deterministic serving workloads: seeded arrival processes, trace
files, and a replay loop with SLO accounting.

Benchmarks used to submit every request up front and drain the engine —
a closed loop that hides queueing behavior entirely.  This module
replaces that with *timed* workloads:

* :func:`poisson` — seeded Poisson arrivals (exponential inter-arrival
  gaps) with seeded prompt payloads, an optional shared system-prompt
  preamble (the physics pattern: one detector-geometry prefix ahead of
  per-event payloads), and optional per-request deadlines (fixed or
  uniformly mixed — mixed urgency is what separates an EDF scheduler
  from FIFO).
* :func:`synchronous` — every request at t=0 (the legacy closed loop,
  expressed as a workload so every benchmark path goes through one
  replay loop).
* :func:`multi_tenant` — Poisson arrivals cycling over N distinct
  seeded tenant preambles, the warm-prefix stream whose working set is
  sized to overflow a small device page pool (the tiered-KV-cache
  exercise: tenant prefixes spill to the host victim tier between
  visits and swap back on re-arrival).
* :func:`save_trace` / :func:`load_trace` — JSONL trace files, so a
  recorded or hand-written arrival trace replays exactly
  (``{"at": .., "prompt": [..], "max_new_tokens": .., "deadline_s": ..}``
  per line).
* :class:`StepClock` — a virtual engine clock.  Arrival times and
  deadlines are *simulation* time; tests advance it a fixed amount per
  engine step, making queueing/deadline dynamics bit-reproducible
  across machines (wall-clock SLO tests are flake factories).
* :func:`replay` — the open-loop runner: submits each event when the
  engine clock passes its arrival time, pumps the engine, and returns a
  :class:`ReplayReport` with completion/deadline-miss accounting.

No torch imports here either: workloads are host-side policy inputs (a
port, by copy, of ``repro.serve.workloads``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import time

import numpy as np


# ------------------------------------------------------------- events --
@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    """One request arrival: ``at`` seconds (engine-clock) after the
    replay starts, ``deadline_s`` relative to arrival (None = no SLO)."""

    at: float
    prompt: tuple[int, ...]
    max_new_tokens: int = 16
    deadline_s: float | None = None
    eos_id: int | None = None


def _prompt(
    rng: np.random.Generator,
    vocab_size: int,
    prompt_len: tuple[int, int],
    preamble: tuple[int, ...],
) -> tuple[int, ...]:
    lo, hi = prompt_len
    n = int(rng.integers(lo, hi + 1))
    return preamble + tuple(
        int(t) for t in rng.integers(0, vocab_size, n)
    )


def poisson(
    *,
    rate: float,
    n: int,
    vocab_size: int,
    seed: int = 0,
    prompt_len: tuple[int, int] = (4, 12),
    shared_prefix: int = 0,
    max_new_tokens: int = 16,
    deadline_s: float | tuple[float, float] | None = None,
    eos_id: int | None = None,
) -> list[ArrivalEvent]:
    """``n`` arrivals with exponential inter-arrival gaps at ``rate``
    requests per (engine-clock) second, fully determined by ``seed``.

    ``deadline_s``: None = no deadlines; a float = every request gets
    that budget from its arrival; a (lo, hi) tuple = per-request uniform
    draw — the mixed-urgency stream where deadline-aware ordering pays.
    ``shared_prefix`` > 0 prepends one seeded preamble of that many
    tokens to every prompt (prefix-cache fodder).
    """
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    preamble = tuple(
        int(t) for t in rng.integers(0, vocab_size, shared_prefix)
    )
    events, t = [], 0.0
    for _ in range(n):
        t += float(rng.exponential(1.0 / rate))
        if deadline_s is None:
            dl = None
        elif isinstance(deadline_s, tuple):
            dl = float(rng.uniform(*deadline_s))
        else:
            dl = float(deadline_s)
        events.append(
            ArrivalEvent(
                at=t,
                prompt=_prompt(rng, vocab_size, prompt_len, preamble),
                max_new_tokens=max_new_tokens,
                deadline_s=dl,
                eos_id=eos_id,
            )
        )
    return events


def synchronous(
    *,
    n: int,
    vocab_size: int,
    seed: int = 0,
    prompt_len: tuple[int, int] = (4, 12),
    shared_prefix: int = 0,
    max_new_tokens: int = 16,
    deadline_s: float | tuple[float, float] | None = None,
    eos_id: int | None = None,
) -> list[ArrivalEvent]:
    """The legacy closed loop as a workload: all ``n`` requests arrive at
    t=0 (same seeded prompt distribution as :func:`poisson`)."""
    events = poisson(
        rate=1.0, n=n, vocab_size=vocab_size, seed=seed,
        prompt_len=prompt_len, shared_prefix=shared_prefix,
        max_new_tokens=max_new_tokens, deadline_s=deadline_s,
        eos_id=eos_id,
    )
    return [dataclasses.replace(ev, at=0.0) for ev in events]


def multi_tenant(
    *,
    rate: float,
    n: int,
    vocab_size: int,
    tenants: int = 4,
    preamble_len: int = 24,
    seed: int = 0,
    prompt_len: tuple[int, int] = (4, 12),
    max_new_tokens: int = 16,
    deadline_s: float | tuple[float, float] | None = None,
    eos_id: int | None = None,
) -> list[ArrivalEvent]:
    """Warm-prefix multi-tenant stream: ``tenants`` distinct seeded
    preambles of ``preamble_len`` tokens each, with ``n`` Poisson
    arrivals cycling round-robin over the tenants (request *i* belongs
    to tenant ``i % tenants``), so every tenant's prefix keeps coming
    back warm.

    This is the victim-tier exercise: the warm working set is
    ``tenants * ceil(preamble_len / page_size)`` prefix pages, and a
    device pool sized *below* that forces the LRU to spill tenant
    prefixes between visits — with ``kv_host_pages`` > 0 they swap back
    from the host tier (prefill-skip on re-arrival); without a tier
    each re-arrival recomputes its preamble.  Fully determined by
    ``seed``; ``deadline_s`` follows :func:`poisson` semantics.
    """
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    if tenants < 1:
        raise ValueError(f"need at least one tenant, got {tenants}")
    rng = np.random.default_rng(seed)
    preambles = [
        tuple(int(t) for t in rng.integers(0, vocab_size, preamble_len))
        for _ in range(tenants)
    ]
    events, t = [], 0.0
    for i in range(n):
        t += float(rng.exponential(1.0 / rate))
        if deadline_s is None:
            dl = None
        elif isinstance(deadline_s, tuple):
            dl = float(rng.uniform(*deadline_s))
        else:
            dl = float(deadline_s)
        events.append(
            ArrivalEvent(
                at=t,
                prompt=_prompt(
                    rng, vocab_size, prompt_len, preambles[i % tenants]
                ),
                max_new_tokens=max_new_tokens,
                deadline_s=dl,
                eos_id=eos_id,
            )
        )
    return events


# -------------------------------------------------------------- traces --
def save_trace(events: list[ArrivalEvent], path: str) -> None:
    """Write a workload as a JSONL trace (one event per line, sorted by
    arrival) — the interchange format for recorded or synthetic traces."""
    with open(path, "w") as f:
        for ev in sorted(events, key=lambda e: e.at):
            f.write(json.dumps({
                "at": ev.at,
                "prompt": list(ev.prompt),
                "max_new_tokens": ev.max_new_tokens,
                "deadline_s": ev.deadline_s,
                "eos_id": ev.eos_id,
            }) + "\n")


def load_trace(path: str) -> list[ArrivalEvent]:
    """Load a JSONL trace written by :func:`save_trace` (or by hand —
    only ``at`` and ``prompt`` are required per line)."""
    events = []
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            try:
                events.append(ArrivalEvent(
                    at=float(rec["at"]),
                    prompt=tuple(int(t) for t in rec["prompt"]),
                    max_new_tokens=int(rec.get("max_new_tokens", 16)),
                    deadline_s=(
                        None if rec.get("deadline_s") is None
                        else float(rec["deadline_s"])
                    ),
                    eos_id=(
                        None if rec.get("eos_id") is None
                        else int(rec["eos_id"])
                    ),
                ))
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(
                    f"{path}:{line_no}: bad trace record {rec!r}"
                ) from e
    return sorted(events, key=lambda e: e.at)


# --------------------------------------------------------------- clock --
class StepClock:
    """A virtual engine clock: ``clock()`` reads it, :meth:`advance`
    moves it.  Pass one to ``Engine(clock=...)`` and :func:`replay` to
    make arrivals, queue waits, and deadlines deterministic simulation
    time instead of wall time."""

    __slots__ = ("t",)

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self.t += dt


# -------------------------------------------------------------- replay --
@dataclasses.dataclass
class ReplayReport:
    """What a replayed workload did, per request and in aggregate.
    ``deadline_missed`` counts drops *and* late completions among the
    ``deadline_total`` requests that carried a deadline."""

    requests: int = 0
    completed: int = 0
    dropped: int = 0
    deadline_total: int = 0
    deadline_missed: int = 0
    tokens: int = 0
    #: engine-clock span of the replay (== wall seconds for a real clock)
    clock_span_s: float = 0.0
    #: real host seconds the replay loop took
    host_wall_s: float = 0.0
    per_request: list[dict] = dataclasses.field(default_factory=list)

    @property
    def miss_rate(self) -> float:
        return self.deadline_missed / max(self.deadline_total, 1)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("per_request")
        d["miss_rate"] = self.miss_rate
        return d


def replay(
    engine,
    events: list[ArrivalEvent],
    *,
    step_cost: float | None = None,
    max_steps: int = 100_000,
) -> ReplayReport:
    """Open-loop replay: submit each event once the engine clock reaches
    its arrival time, pump :meth:`Engine.step` while there is work, and
    account completions against deadlines.

    The clock is the engine's own (``engine.clock``).  With a
    :class:`StepClock`, ``step_cost`` sets how much simulation time one
    engine step costs (None = advance by the step's measured wall time,
    keeping virtual arrivals paced by real compute), and idle gaps jump
    instantly.  With the default wall clock, arrivals pace in real time
    (idle waits sleep in 1 ms slices) and ``step_cost`` must be None.
    """
    clock = engine.clock
    virtual = hasattr(clock, "advance")
    if step_cost is not None and not virtual:
        raise ValueError(
            "step_cost only applies to a virtual engine clock (StepClock)"
        )
    pending = sorted(events, key=lambda e: e.at)
    t_start = clock()
    host0 = time.perf_counter()
    handles = []
    i = 0
    steps = 0
    while i < len(pending) or engine.has_work:
        now = clock() - t_start
        while i < len(pending) and pending[i].at <= now:
            ev = pending[i]
            i += 1
            handles.append((
                engine.submit(
                    list(ev.prompt),
                    max_new_tokens=ev.max_new_tokens,
                    eos_id=ev.eos_id,
                    deadline_s=ev.deadline_s,
                ),
                ev,
            ))
        if engine.has_work:
            if steps >= max_steps:
                raise RuntimeError(
                    f"replay exceeded max_steps={max_steps} "
                    "(engine not making progress?)"
                )
            t0 = time.perf_counter()
            engine.step()
            steps += 1
            if virtual:
                clock.advance(
                    time.perf_counter() - t0 if step_cost is None
                    else step_cost
                )
        elif i < len(pending):
            gap = pending[i].at - (clock() - t_start)
            if gap > 0:
                if virtual:
                    # ``gap`` comes from subtracting two clock readings
                    # much larger than itself (a reused clock far from
                    # zero); the residual can round below one ulp of the
                    # clock value, making advance() a no-op forever —
                    # nudge by an ulp so the arrival check must cross
                    before = clock()
                    clock.advance(gap)
                    if clock() == before:
                        clock.advance(math.ulp(before))
                else:
                    time.sleep(min(gap, 1e-3))
    report = ReplayReport(
        requests=len(handles),
        clock_span_s=clock() - t_start,
        host_wall_s=time.perf_counter() - host0,
    )
    for handle, ev in handles:
        req = engine.result(handle)
        reason = engine.finish_reason(handle)
        dropped = reason == "deadline"
        report.completed += not dropped
        report.dropped += dropped
        report.tokens += len(req.generated)
        missed = None
        if req.deadline_at is not None:
            report.deadline_total += 1
            missed = dropped or req.finished_at > req.deadline_at
            report.deadline_missed += missed
        report.per_request.append({
            "uid": req.uid,
            "arrived_at": ev.at,
            "deadline_s": ev.deadline_s,
            "finish_reason": reason,
            "tokens": len(req.generated),
            "finished_at": req.finished_at - t_start,
            "preemptions": req.preemptions,
            "missed": missed,
        })
    return report
