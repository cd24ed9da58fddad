"""Per-engine-step phase summaries, computed from the port's spans: where
does a step's time actually go?

The paper's discipline is *accountable* latency — a 64-cycle MLP is only
meaningful inside its ~140k-cycle shell if you can say where the other
cycles went.  The serving counterpart: each engine step opens spans
(:mod:`repro_torch.trace`), and a step's record sums them by phase:

    phase      span          what
    schedule   schedule      policy: FifoScheduler/DeadlineScheduler.schedule()
    host_prep  host_prep     numpy batch assembly + page-table bookkeeping
                             (ensure / flush_copies / write_table) before a
                             dispatch
    dispatch   launch        launching the program's device work (returns
                             as soon as it is enqueued; first-call kernel
                             builds also land here)
    device     device        waiting for the dispatched tensors (a device
                             synchronise)
    sample     sample        host-side post-processing: device->host
                             transfers, token sampling, slot bookkeeping
    wall       engine.step   the whole step

The dispatch spans (``prefill``, ``decode``, ``extend``, ``verify``) hold
these phases, and ``collect`` holds the decode results' blocking wait (its
own time, outside its ``sample`` child).  Time in no phase (``route``, the
dispatch spans' own lines) is the summary's ``unattributed_s``.

:class:`PhaseTracer` listens to the spans of one step at a time
(``begin_step`` / ``end_step``), pushes the step's record into a bounded
ring buffer, and summarizes p50/p95/p99 on demand.  Isolating ``device``
requires *fencing* every dispatch (``torch.cuda.synchronize``), which
serializes host and device work — so tracing is **off by default**
(``ServeConfig.trace_phases``) and the off path is :data:`NULL_TRACER`,
whose methods are no-ops and which never fences: an untraced engine's span
sites cost one check each (:mod:`repro_torch.trace`).

The fenced tracer *destroys the pipeline it measures*: under the
pipelined engine loop (``ServeConfig.async_loop``) a fence between
dispatch N and schedule N+1 is exactly the serialization the loop
exists to remove.  :class:`OverlapTracer`
(``ServeConfig.phase_mode="overlap"``) is the non-fencing alternative:
it records, per step,

    overlap    host seconds from a ``decode`` span's end to the start of
               the ``collect`` span it caused — device compute hidden
               under host work (schedule/host_prep/sample of the next step)
    collect    the ``collect`` span's own time, its blocking wait — host
               time the device did NOT hide (the pipeline bubble)

and its summary adds ``device_overlap_s`` (total overlap),
``host_bubble_s`` (total collect wait), and ``overlap_efficiency`` =
overlap / (overlap + bubble) — 1.0 means the loop is fully pipelined,
0.0 means it is effectively synchronous.  ``overlap`` is an upper
bound on hidden device time (the device may finish early inside the
span); ``collect`` is exact.  The fenced tracer counts the wait in
``sample``, as the untraced record schema does (``collect_phase``).

Spans stamp with ``time.time_ns`` — real host/device time — even when the
engine itself runs on a virtual clock
(:class:`~repro_torch.serve.workloads.StepClock`): phase timings are physical
measurements, arrival/deadline bookkeeping is simulation time.

This module needs torch only for the fence (imported lazily).  The
summary is a port, by copy, of ``repro.serve.phases``'s; the fence
synchronises the CUDA device the fenced tensors live on, and is a no-op
for CPU tensors.
"""

from __future__ import annotations

import collections

from repro_torch import trace

#: phase names in within-step order (``wall`` is the whole step)
PHASES = ("schedule", "host_prep", "dispatch", "device", "sample")
#: the phase each span name sums into (``collect`` apart: its own time)
PHASE_OF = {"schedule": "schedule", "host_prep": "host_prep", "launch": "dispatch",
            "device": "device", "sample": "sample", "engine.step": "wall"}
#: the span each phase name opens (:meth:`PhaseTracer.phase`)
SPAN_OF = {phase: name for name, phase in PHASE_OF.items()}


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


class NullTracer:
    """The off switch: every hook is a no-op and :meth:`fence` never
    touches the device, so an untraced engine's hot loop is unchanged."""

    enabled = False
    #: record key of collect's blocking wait ("sample" keeps the
    #: fenced/untraced record schema; the overlap tracer names it
    #: "collect" — the pipeline-bubble measurement)
    collect_phase = "sample"

    def begin_step(self) -> None:
        pass

    def end_step(self) -> None:
        pass

    def phase(self, name: str):
        return trace.NULL

    def fence(self, value):
        return value

    def records(self) -> list[dict]:
        return []

    def summary(self) -> dict:
        return {}


#: the shared untraced instance every executor starts with
NULL_TRACER = NullTracer()


class PhaseTracer:
    """Sum each engine step's spans into a per-phase record, kept in a
    bounded ring buffer.

    Usage (the engine/executor wiring)::

        tracer.begin_step()                  # listen to the spans
        with trace.span("engine.step"):
            with trace.span("schedule"):
                decision = scheduler.schedule(slots)
            with trace.span("launch"):
                out = program(...)           # returns once enqueued
            with trace.span("device"):
                tracer.fence(out)            # device synchronise
        tracer.end_step()                    # the step's record

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
        #: the current step's spans (None between steps)
        self._spans: list | None = None
        #: dispatches fenced so far (the off-costs-nothing guard test
        #: asserts an untraced engine performs zero fences)
        self.fences = 0

    # ------------------------------------------------------------ hooks --
    def begin_step(self) -> None:
        if self._spans is not None:  # a step that raised never ended
            trace.unlisten(self._spans)
        self._spans = []
        trace.listen(self._spans)

    def end_step(self) -> None:
        if self._spans is None:
            return
        spans, self._spans = self._spans, None
        trace.unlisten(spans)
        self._ring.append(self._record(spans))

    def phase(self, name: str):
        """A span of phase ``name`` (``dispatch`` opens ``launch``)."""
        return trace.span(SPAN_OF.get(name, name))

    def fence(self, value):
        """Wait for every tensor in ``value`` (nested tuples, lists and
        dicts) to be ready on its device.  Call inside a ``device`` span,
        right after the dispatch returned, to split launch time from
        device time.  CPU tensors are ready when the call returns: no-op
        for them."""
        import torch  # lazy: keep the module importable host-side

        self.fences += 1
        for dev in sorted(_cuda_devices(value, torch)):
            torch.cuda.synchronize(dev)
        return value

    def _record(self, spans: list) -> dict:
        """One step's record: seconds per phase, summed over its spans."""
        rec: dict[str, float] = {}
        children: dict[int, int] = collections.Counter()
        for s in spans:
            children[s.parent] += s.end - s.start
        for s in spans:
            if s.name == "collect":
                key, ns = self.collect_phase, s.end - s.start - children[s.id]
            elif s.name in PHASE_OF:
                key, ns = PHASE_OF[s.name], s.end - s.start
            else:
                continue
            rec[key] = rec.get(key, 0.0) + ns / 1e9
        return rec

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
    sums as :class:`PhaseTracer`, but :meth:`fence` is a pass-through
    (device and host stay overlapped) and device time is accounted by
    *span*, not by blocking:

    * ``overlap`` — host seconds from a ``decode`` span's end (the
      dispatch returned, device busy) to the start of the ``collect``
      span that names it as its cause (the host finally needs the
      results).  Under the async loop this gap contains the *next*
      step's schedule/host_prep — exactly the work the pipeline hides.
      Upper bound on hidden device time.
    * ``collect`` — the ``collect`` span's own time, its blocking
      device->host wait: host time the device did not hide (the
      pipeline bubble).  Exact.

    The summary adds ``device_overlap_s`` / ``host_bubble_s`` /
    ``overlap_efficiency`` totals over the ring.
    """

    _names = PHASES + ("collect", "overlap")
    collect_phase = "collect"

    def __init__(self, ring: int = 512):
        super().__init__(ring)
        #: end of each decode span of the last step (its collect comes in
        #: the next step under the async loop, in the same one otherwise)
        self._decode_end: dict[int, int] = {}

    def fence(self, value):
        """Never blocks — fencing would serialize the pipeline this
        tracer exists to measure.  ``fences`` stays 0."""
        return value

    def _record(self, spans: list) -> dict:
        rec = super()._record(spans)
        ends = {s.id: s.end for s in spans if s.name == "decode"}
        prior, self._decode_end = self._decode_end, ends
        ends = {**prior, **ends}
        for s in spans:
            if s.name == "collect" and s.cause in ends:
                gap = max(0, s.start - ends[s.cause])
                rec["overlap"] = rec.get("overlap", 0.0) + gap / 1e9
        return rec

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
