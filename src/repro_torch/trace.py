"""The port's span recorder: named stretches of host work, stamped on the
clock of the device trace, and the readers that put them beside one.

A span is one named interval of the program's host work (a serving step, a
prefill dispatch, a precision pass of a forward): its ``start`` and ``end``
in Unix-epoch nanoseconds (``time.time_ns``, the clock ``torch.profiler``
stamps host runtime calls and device operations on), the span open around
it (``parent``), the span that caused it (``cause``: the decode dispatch a
``collect`` waits for), and a few small ``attrs`` (counts, request uids).
Ids are unique in the process; 0 means none.

Recording is off by default.  Off, a span site costs one check of the
module's recorder and gets the shared no-op :data:`NULL` back: it makes no
span, reads no clock and never synchronises the device.  :func:`start`
turns recording on and :func:`stop` turns it off and returns the spans that
closed in between; a :class:`~repro_torch.serve.phases.PhaseTracer`
listens to one engine step at a time (:func:`listen` / :func:`unlisten`).
Spans nest in the order they open and close, so they are recorded from one
thread: the engine loop and a forward each run on one.  A span whose
attributes cost work to compute sets them only when it is real::

    with trace.span("prefill") as sp:
        if sp is not trace.NULL:
            sp.set(rows=len(group), uids=[a.request.uid for a in group])

The readers (:func:`device_ops` and below) take a ``torch.profiler`` trace
of the same stretch: a device operation belongs to the innermost span open
when its launching runtime call (the host call with the operation's
correlation id) began, and to every span around that one.
"""

from __future__ import annotations

import itertools
import time

#: the clock every span reads (the tests swap in a counting stub)
_clock = time.time_ns
_ids = itertools.count(1)


class Span:
    """One recorded span; a context manager that closes it on exit."""

    __slots__ = ("id", "name", "parent", "cause", "start", "end", "attrs", "_rec")

    def __init__(self, rec: _Recorder, name: str, cause: int, attrs: dict):
        self._rec = rec
        self.id = next(_ids)
        self.name = name
        self.parent = rec.stack[-1].id if rec.stack else 0
        self.cause = cause
        self.attrs = attrs
        self.end = 0
        rec.stack.append(self)
        self.start = _clock()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end = _clock()
        self._rec.close(self)
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, cause={self.cause}, "
                f"{(self.end - self.start) / 1e6:.3f} ms, {self.attrs})")


class _NullSpan:
    """The span site's answer while nothing records: one shared instance."""

    __slots__ = ()
    id = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NULL = _NullSpan()


class _Recorder:
    """The open spans, innermost last, and the lists that receive each span
    as it closes."""

    def __init__(self):
        self.stack: list[Span] = []
        self.sinks: list[list[Span]] = []

    def close(self, span: Span) -> None:
        stack = self.stack
        while stack:
            if stack.pop() is span:
                break
        for sink in self.sinks:
            sink.append(span)


#: the recorder while anything listens; None = off (the one check a site makes)
_rec: _Recorder | None = None
#: :func:`start`'s sink
_kept: list[Span] | None = None


def span(name: str, cause: int = 0, **attrs):
    """A span named ``name`` (``with trace.span(...) as sp``), or :data:`NULL`
    while nothing records."""
    rec = _rec
    if rec is None:
        return NULL
    return Span(rec, name, cause, attrs)


def listen(sink: list) -> None:
    """Append every span that closes from now on to ``sink`` too."""
    global _rec
    if _rec is None:
        _rec = _Recorder()
    _rec.sinks.append(sink)


def unlisten(sink: list) -> None:
    """Stop appending to ``sink``; recording ends when no sink is left."""
    global _rec
    if _rec is None:
        return
    _rec.sinks = [s for s in _rec.sinks if s is not sink]
    if not _rec.sinks:
        _rec = None


def start() -> None:
    """Turn recording on until :func:`stop`."""
    global _kept
    if _kept is not None:
        raise RuntimeError("span recording is already on")
    _kept = []
    listen(_kept)


def stop() -> list[Span]:
    """Turn recording off; the spans that closed since :func:`start`, in the
    order they closed."""
    global _kept
    spans, _kept = _kept, None
    if spans is None:
        raise RuntimeError("span recording is not on")
    unlisten(spans)
    return spans


# ---------------------------------------------------------------------------
# Reading spans beside a device trace
# ---------------------------------------------------------------------------


def device_ops(prof) -> list[tuple[int, int, str, int]]:
    """(start ns, end ns, name, launch ns) of every device operation in a
    finished ``torch.profiler.profile``; launch ns is the start of the host
    runtime call with the operation's correlation id (0 when the trace holds
    none).  Host operators carry correlation ids of their own, so only
    runtime calls (named ``cu...``) are matched."""
    from torch.autograd import DeviceType

    ops, launch = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            ops.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name(),
                        ev.correlation_id()))
        elif ev.name().startswith("cu") and ev.correlation_id():
            launch[ev.correlation_id()] = ev.start_ns()
    return [(s, e, name, launch.get(corr, 0)) for s, e, name, corr in ops]


def union_ns(intervals) -> int:
    """Nanoseconds covered by the union of (start, end, ...) intervals."""
    total, cur_s, cur_e = 0, None, None
    for iv in sorted(intervals):
        s, e = iv[0], iv[1]
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total if cur_e is None else total + cur_e - cur_s


def innermost(spans, times) -> list[int]:
    """The id of the innermost span open at each of ``times`` (start
    inclusive, end exclusive; 0 where none is)."""
    order = sorted(range(len(times)), key=times.__getitem__)
    by_start = sorted(spans, key=lambda s: (s.start, -s.end))
    out, stack, i = [0] * len(times), [], 0
    for k in order:
        t = times[k]
        while i < len(by_start) and by_start[i].start <= t:
            s = by_start[i]
            i += 1
            while stack and stack[-1].end <= s.start:
                stack.pop()
            stack.append(s)
        while stack and stack[-1].end <= t:
            stack.pop()
        out[k] = stack[-1].id if stack else 0
    return out


def _within(by_id: dict, sid: int, name: str) -> int:
    """The id of the nearest span named ``name`` at or around span ``sid``
    (0 when none)."""
    while sid in by_id:
        s = by_id[sid]
        if s.name == name:
            return sid
        sid = s.parent
    return 0


def device_ns_under(spans, ops, name: str) -> int:
    """Device nanoseconds (the union of their intervals) of the operations
    launched inside a span named ``name``."""
    by_id = {s.id: s for s in spans}
    owners = innermost(spans, [op[3] for op in ops])
    return union_ns([op for op, sid in zip(ops, owners) if op[3] and _within(by_id, sid, name)])


def idle_by_span(spans, ops, t0: int, t1: int) -> dict[int, int]:
    """The device's idle nanoseconds in [t0, t1) (no operation running), by
    the innermost span open meanwhile (0: outside any span)."""
    gaps, end = [], t0
    for s, e, *_ in sorted(ops):
        if s > end:
            gaps.append((end, min(s, t1)))
        end = max(end, e)
        if end >= t1:
            break
    if end < t1:
        gaps.append((end, t1))
    cuts = sorted({t0, t1} | {t for s in spans for t in (s.start, s.end) if t0 < t < t1})
    owners = innermost(spans, cuts[:-1])
    out: dict[int, int] = {}
    j = 0
    for a, b in gaps:
        while j + 1 < len(cuts) and cuts[j + 1] <= a:
            j += 1
        k = j
        while k + 1 < len(cuts) and cuts[k] < b:
            lo, hi = max(a, cuts[k]), min(b, cuts[k + 1])
            if hi > lo:
                out[owners[k]] = out.get(owners[k], 0) + hi - lo
            k += 1
    return out


def idle_by_name(spans, ops, t0: int, t1: int) -> dict[str, int]:
    """:func:`idle_by_span` summed by span name, a span inside a dispatch or
    a forward named with it (``decode/launch``); "outside any span" for 0."""
    by_id = {s.id: s for s in spans}
    out: dict[str, int] = {}
    for sid, ns in idle_by_span(spans, ops, t0, t1).items():
        name = "outside any span"
        if sid:
            s = by_id[sid]
            parent = by_id.get(s.parent)
            name = s.name if parent is None or parent.name == "engine.step" else (
                f"{parent.name}/{s.name}")
        out[name] = out.get(name, 0) + ns
    return out


#: spans whose own time is a wait for the device, not host work
WAITS = ("device", "collect")


def host_idle_ns(spans, ops, t0: int, t1: int) -> int:
    """Idle device nanoseconds in [t0, t1) while the innermost open span lay
    inside an ``engine.step`` and was neither ``device`` nor the blocking
    wait of ``collect`` (its own time): idle time the engine's host work
    caused."""
    by_id = {s.id: s for s in spans}
    return sum(ns for sid, ns in idle_by_span(spans, ops, t0, t1).items()
               if sid and by_id[sid].name not in WAITS and _within(by_id, sid, "engine.step"))


def padding_share(spans) -> float | None:
    """1 - the prompt tokens the ``prefill`` spans filled over the rows they
    ran (``max_batch`` x ``bucket`` each); None without a prefill."""
    rows = sum(s.attrs["max_batch"] * s.attrs["bucket"] for s in spans if s.name == "prefill")
    if not rows:
        return None
    return 1.0 - sum(s.attrs["fill_tokens"] for s in spans if s.name == "prefill") / rows
