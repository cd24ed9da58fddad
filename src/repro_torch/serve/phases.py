"""Per-engine-step phase tracing: where does a step's time actually go?

The paper's discipline is *accountable* latency — a 64-cycle MLP is only
meaningful inside its ~140k-cycle shell if you can say where the other
cycles went.  The serving counterpart: each engine step decomposes into

    schedule   policy: FifoScheduler/DeadlineScheduler.schedule()
    host_prep  numpy batch assembly + page-table bookkeeping
               (ensure / flush_copies / write_table) before a dispatch
    dispatch   launching the program's device work (returns as soon
               as it is enqueued; first-call kernel builds also land
               here)
    device     waiting for the dispatched tensors (a device synchronise)
    sample     host-side post-processing: device->host transfers,
               token sampling/routing, slot bookkeeping

:class:`PhaseTracer` accumulates per-phase seconds for the current step,
pushes the finished record into a bounded ring buffer, and summarizes
p50/p95/p99 on demand.  Isolating ``device`` requires *fencing* every
dispatch (``torch.cuda.synchronize``), which serializes host and device
work — so tracing is **off by default** (``ServeConfig.trace_phases``)
and the off path is :data:`NULL_TRACER`, whose methods are no-ops and
which never fences: an untraced engine runs the exact code it ran
before, test-enforced to cost no measurable throughput.

The fenced tracer *destroys the pipeline it measures*: under the
pipelined engine loop (``ServeConfig.async_loop``) a fence between
dispatch N and schedule N+1 is exactly the serialization the loop
exists to remove.  :class:`OverlapTracer`
(``ServeConfig.phase_mode="overlap"``) is the non-fencing alternative:
it records, per step,

    overlap    host seconds between a dispatch returning and its
               collect starting — device compute hidden under host
               work (schedule/host_prep/sample of the next step)
    collect    the residual blocking wait inside ``collect`` — host
               time the device did NOT hide (the pipeline bubble)

and its summary adds ``device_overlap_s`` (total overlap),
``host_bubble_s`` (total collect wait), and ``overlap_efficiency`` =
overlap / (overlap + bubble) — 1.0 means the loop is fully pipelined,
0.0 means it is effectively synchronous.  ``overlap`` is an upper
bound on hidden device time (the device may finish early inside the
span); ``collect`` is exact.

The tracer always stamps with ``time.perf_counter`` — real host/device
seconds — even when the engine itself runs on a virtual clock
(:class:`~repro_torch.serve.workloads.StepClock`): phase timings are physical
measurements, arrival/deadline bookkeeping is simulation time.

This module stays importable without torch (the single
``torch.cuda.synchronize`` call imports lazily), so host-side tooling can
consume recorded phase data anywhere the scheduler runs.  A port, by copy,
of ``repro.serve.phases``; the fence synchronises the CUDA device the
fenced tensors live on, and is a no-op for CPU tensors.
"""

from __future__ import annotations

import collections
import time

#: phase names in within-step order (``wall`` is the whole step)
PHASES = ("schedule", "host_prep", "dispatch", "device", "sample")


def _percentile(xs: list[float], q: float) -> float:
    """Nearest-rank percentile of a sorted list (numpy-free: the policy
    layer must not grow device deps for a summary)."""
    if not xs:
        return 0.0
    idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[idx]


def _cuda_devices(value, torch) -> set[int]:
    """Indices of the CUDA devices the tensors in ``value`` live on."""
    if isinstance(value, torch.Tensor):
        return {value.device.index or 0} if value.is_cuda else set()
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return set().union(*(_cuda_devices(v, torch) for v in value))
    return set()


class _NullCtx:
    """Reusable no-op context manager (one shared instance, no allocation
    per phase on the untraced path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class NullTracer:
    """The off switch: every hook is a no-op and :meth:`fence` never
    touches the device, so an untraced engine's hot loop is unchanged."""

    enabled = False
    _ctx = _NullCtx()
    #: record key the executor wraps collect's blocking transfer in
    #: ("sample" keeps the fenced/untraced record schema; the overlap
    #: tracer renames it "collect" — the pipeline-bubble measurement)
    collect_phase = "sample"

    def begin_step(self) -> None:
        pass

    def end_step(self) -> None:
        pass

    def phase(self, name: str) -> _NullCtx:
        return self._ctx

    def fence(self, value):
        return value

    def mark_dispatch(self) -> float:
        """Timestamp a decode dispatch's return (overlap accounting);
        the no-op tracer never reads a clock."""
        return 0.0

    def collect_begin(self, dispatched_at: float) -> None:
        """Record the dispatch->collect host span as hidden device time
        (overlap accounting); no-op here."""

    def records(self) -> list[dict]:
        return []

    def summary(self) -> dict:
        return {}


#: the shared untraced instance every executor starts with
NULL_TRACER = NullTracer()


class _PhaseCtx:
    """Context manager accumulating elapsed seconds into the tracer's
    current step record under ``name`` (re-entrant per step: repeated
    phases — one per dispatch — sum)."""

    __slots__ = ("tracer", "name", "t0")

    def __init__(self, tracer: PhaseTracer, name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        cur = self.tracer._cur
        if cur is not None:
            cur[self.name] = (
                cur.get(self.name, 0.0) + time.perf_counter() - self.t0
            )
        return False


class PhaseTracer:
    """Accumulate per-step phase timings into a bounded ring buffer.

    Usage (the engine/executor wiring)::

        tracer.begin_step()
        with tracer.phase("schedule"):
            decision = scheduler.schedule(slots)
        with tracer.phase("dispatch"):
            out = program(...)           # returns once enqueued
        with tracer.phase("device"):
            tracer.fence(out)            # device synchronise
        tracer.end_step()

    ``fence`` is the only device-touching call and exists so the *same*
    executor source runs fenced and unfenced: under :data:`NULL_TRACER`
    it is a pass-through.
    """

    enabled = True
    #: per-step record keys the summary reports (subclasses extend)
    _names = PHASES
    #: see NullTracer.collect_phase
    collect_phase = "sample"

    def __init__(self, ring: int = 512):
        if ring < 1:
            raise ValueError(f"phase ring must hold >= 1 record, got {ring}")
        self._ring: collections.deque[dict] = collections.deque(maxlen=ring)
        self._cur: dict | None = None
        self._t0 = 0.0
        #: dispatches fenced so far (the off-costs-nothing guard test
        #: asserts an untraced engine performs zero fences)
        self.fences = 0

    # ------------------------------------------------------------ hooks --
    def begin_step(self) -> None:
        self._cur = {}
        self._t0 = time.perf_counter()

    def end_step(self) -> None:
        if self._cur is None:
            return
        self._cur["wall"] = time.perf_counter() - self._t0
        self._ring.append(self._cur)
        self._cur = None

    def phase(self, name: str) -> _PhaseCtx:
        return _PhaseCtx(self, name)

    def fence(self, value):
        """Wait for every tensor in ``value`` (nested tuples, lists and
        dicts) to be ready on its device.  Call inside a
        ``phase("device")`` block, right after the dispatch returned, to
        split launch time from device time.  CPU tensors are ready when
        the call returns: no-op for them."""
        import torch  # lazy: keep the module importable host-side

        self.fences += 1
        for dev in sorted(_cuda_devices(value, torch)):
            torch.cuda.synchronize(dev)
        return value

    def mark_dispatch(self) -> float:
        """Timestamp a decode dispatch's return.  The fenced tracer
        already isolates device time via :meth:`fence`; the stamp is
        consumed by :class:`OverlapTracer.collect_begin`."""
        return time.perf_counter()

    def collect_begin(self, dispatched_at: float) -> None:
        """Overlap accounting hook; the fenced tracer measures device
        time by fencing instead, so this records nothing."""

    # ---------------------------------------------------------- reading --
    def records(self) -> list[dict]:
        """Completed per-step records, oldest first (bounded by the ring)."""
        return list(self._ring)

    def summary(self) -> dict:
        """Per-phase p50/p95/p99/mean in milliseconds plus totals, over
        the retained ring.  A phase absent from a step (e.g. no prefill
        that step) does not drag its percentiles toward zero: each
        phase summarizes only the steps it appeared in."""
        recs = self.records()
        out: dict = {"steps": len(recs), "ring": self._ring.maxlen}
        for name in self._names + ("wall",):
            xs = sorted(r[name] for r in recs if name in r)
            if not xs:
                continue
            total = sum(xs)
            out[name] = {
                "n": len(xs),
                "p50_ms": _percentile(xs, 50) * 1e3,
                "p95_ms": _percentile(xs, 95) * 1e3,
                "p99_ms": _percentile(xs, 99) * 1e3,
                "mean_ms": total / len(xs) * 1e3,
                "total_s": total,
            }
        if recs:
            # time the phase model did not attribute (python routing in
            # the engine loop, telemetry merges): honest accounting
            # means the residual is reported, not hidden
            walls = sum(r.get("wall", 0.0) for r in recs)
            attributed = sum(
                v for r in recs
                for k, v in r.items()
                if k != "wall"
            )
            out["unattributed_s"] = max(0.0, walls - attributed)
        return out


class OverlapTracer(PhaseTracer):
    """The non-fencing tracer for the pipelined loop: same per-phase
    accumulation as :class:`PhaseTracer`, but :meth:`fence` is a
    pass-through (device and host stay overlapped) and device time is
    accounted by *span*, not by blocking:

    * ``overlap`` — host seconds between :meth:`mark_dispatch` (a decode
      dispatch returned, device busy) and :meth:`collect_begin` (the
      host finally needs the results).  Under the async loop this span
      contains the *next* step's schedule/host_prep — exactly the work
      the pipeline hides.  Upper bound on hidden device time.
    * ``collect`` — wrapped by the executor around the blocking
      device->host conversion in ``collect()``: host time the device
      did not hide (the pipeline bubble).  Exact.

    The summary adds ``device_overlap_s`` / ``host_bubble_s`` /
    ``overlap_efficiency`` totals over the ring.
    """

    _names = PHASES + ("collect", "overlap")
    collect_phase = "collect"

    def fence(self, value):
        """Never blocks — fencing would serialize the pipeline this
        tracer exists to measure.  ``fences`` stays 0."""
        return value

    def collect_begin(self, dispatched_at: float) -> None:
        if self._cur is not None and dispatched_at > 0.0:
            span = max(0.0, time.perf_counter() - dispatched_at)
            self._cur["overlap"] = self._cur.get("overlap", 0.0) + span

    def summary(self) -> dict:
        out = super().summary()
        recs = self.records()
        overlap = sum(r.get("overlap", 0.0) for r in recs)
        bubble = sum(r.get("collect", 0.0) for r in recs)
        out["device_overlap_s"] = overlap
        out["host_bubble_s"] = bubble
        out["overlap_efficiency"] = (
            overlap / (overlap + bubble) if (overlap + bubble) > 0 else 0.0
        )
        return out


def make_tracer(
    trace: bool, ring: int = 512, mode: str = "fenced"
) -> PhaseTracer | NullTracer:
    """The ServeConfig -> tracer factory: a live tracer when tracing is
    requested (``mode`` "fenced" = :class:`PhaseTracer`, "overlap" =
    :class:`OverlapTracer`), the shared no-op otherwise."""
    if not trace:
        return NULL_TRACER
    if mode == "overlap":
        return OverlapTracer(ring=ring)
    if mode == "fenced":
        return PhaseTracer(ring=ring)
    raise ValueError(
        f"phase_mode must be 'fenced' or 'overlap', got {mode!r}"
    )
