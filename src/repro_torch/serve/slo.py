"""SLO-aware scheduling: earliest-deadline-first on the Scheduler seam.

The source paper's setting is a hard-real-time physics trigger — an
answer that arrives after its bunch-crossing window is *worthless*, not
late.  :class:`DeadlineScheduler` brings that discipline to the serving
stack as a drop-in policy for the ``Scheduler`` protocol
(``Engine(scheduler_factory=...)`` or ``ServeConfig.scheduler="edf"``):

* **EDF admission order** — the queue is kept sorted by each request's
  absolute ``deadline_at`` (engine-clock time); requests without a
  deadline run FIFO behind every deadlined one.  Everything else —
  prefix-cache hit planning, chunked prefill, page reservation,
  preemption bookkeeping — is inherited from
  :class:`~repro_torch.serve.scheduler.FifoScheduler` unchanged, which is the
  whole point of the scheduler/executor split: a new policy is a
  reordering, not a re-implementation.
* **Overdue policy** (``ServeConfig.overdue_policy``) for a *queued*
  request whose deadline passes before admission:

  - ``"drop"`` (default): remove it and report it — the API layer
    finishes it with ``finish_reason="deadline"`` and streams a
    terminal :class:`~repro_torch.serve.api.TokenEvent`, so a drop is an
    answered request, and the capacity it would have burned serves
    still-feasible work instead.
  - ``"demote"``: keep it, but behind every still-feasible request.
  - ``"ignore"``: pure EDF order, no special handling (it will run,
    and be counted as a miss).

  A *resident* past-deadline request always runs to completion: its
  pages and KV content are never invalidated mid-flight, it is simply
  counted as a miss by the engine's SLO telemetry.
* **Deadline-aware preemption victims** — when the page pool blocks the
  queue head, the evicted resident is the one with the *least urgent*
  deadline (deadline-less first, then latest deadline; youngest breaks
  ties), instead of FIFO's youngest-resident rule.

This module is policy only: like ``serve/scheduler.py`` it imports no
torch and performs no device work (a port, by copy, of ``repro.serve.slo``).
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

from repro_torch.serve.scheduler import (
    ExecutorCaps,
    FifoScheduler,
    Request,
    ScheduleDecision,
    Slot,
)

if TYPE_CHECKING:
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve.kv_cache import CacheManager

#: valid ``ServeConfig.overdue_policy`` values
OVERDUE_POLICIES = ("drop", "demote", "ignore")


def _urgency(req: Request) -> float:
    """EDF sort key: absolute deadline, +inf when none (deadline-less
    requests yield to every deadlined one)."""
    return req.deadline_at if req.deadline_at is not None else math.inf


class DeadlineScheduler(FifoScheduler):
    """Earliest-deadline-first admission with a configurable past-deadline
    policy, composing with prefix caching, chunked prefill, and
    page-aware preemption through the inherited FIFO machinery."""

    def __init__(
        self,
        serve_cfg: ServeConfig,
        caps: ExecutorCaps,
        cache: CacheManager,
        clock=None,
    ):
        super().__init__(serve_cfg, caps, cache, clock=clock)
        self.overdue_policy = serve_cfg.overdue_policy
        if self.overdue_policy not in OVERDUE_POLICIES:
            raise ValueError(
                f"overdue_policy must be one of {OVERDUE_POLICIES}, "
                f"got {self.overdue_policy!r}"
            )
        #: queued requests removed past their deadline (drop policy)
        self.stats["deadline_drops"] = 0

    # ----------------------------------------------------------- policy --
    def schedule(self, slots: list[Slot]) -> ScheduleDecision:
        """Apply the overdue policy, re-sort the queue EDF, then run the
        inherited admission/preemption machinery over the reordered
        queue.  Sorting is host-side list work on O(queue) records —
        exactly the kind of policy the device layer never sees."""
        now = self.clock()
        dropped: list[Request] = []
        if self.overdue_policy == "drop" and self.queue:
            feasible = []
            for req in self.queue:
                if req.deadline_at is not None and now > req.deadline_at:
                    # never admitted this residency -> no pages held
                    # (a preempted requeue freed its pages at eviction);
                    # removing it is pure bookkeeping
                    dropped.append(req)
                    self.stats["deadline_drops"] += 1
                else:
                    feasible.append(req)
            self.queue[:] = feasible
        # stable sort: same-deadline (and deadline-less) requests keep
        # FIFO order among themselves, so EDF degrades to exactly FIFO
        # when nobody carries a deadline
        self.queue.sort(key=_urgency)
        if self.overdue_policy == "demote" and self.queue:
            fresh = [
                r for r in self.queue
                if r.deadline_at is None or now <= r.deadline_at
            ]
            overdue = [
                r for r in self.queue
                if r.deadline_at is not None and now > r.deadline_at
            ]
            self.queue[:] = fresh + overdue
        decision = super().schedule(slots)
        decision.dropped = dropped
        return decision

    def _pick_victim(self, victims: list[int], slots: list[Slot]) -> int:
        """Evict the least-urgent resident: deadline-less before
        deadlined, later deadlines before earlier ones; admit_seq
        (youngest) breaks ties — protecting urgent in-flight work is
        what makes preemption deadline-aware rather than merely
        page-aware."""
        return max(
            victims,
            key=lambda i: (_urgency(slots[i].request), slots[i].admit_seq),
        )
