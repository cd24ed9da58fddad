"""A device trace of a stretch of the window, and its reduction: the union
of the device's operation intervals (busy time, never a sum of overlapping
kernels), device time by operation name, and the idle gaps between them,
each labelled by the host's CUDA runtime call under way at the gap, if any.

Only the device side is traced (``ProfilerActivity.CUDA``), with the runtime
calls that CUPTI reports beside it: tracing the host's operators as well
would slow the traced stretch and the reading of the trace.
"""

from __future__ import annotations

import bisect
import dataclasses
import time


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    ops: list  # (start_ns, end_ns, name) of every device operation
    host_calls: list  # (start_ns, end_ns, name) of the CUDA runtime calls

    def busy_s(self) -> float:
        total, cur_s, cur_e = 0, None, None
        for s, e, _ in sorted(self.ops):
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e9

    def device_s(self, *names: str) -> tuple[float, int]:
        """(summed device seconds, count) of the operations whose name
        contains any of ``names``."""
        hits = [e - s for s, e, n in self.ops if any(k in n for k in names)]
        return sum(hits) / 1e9, len(hits)

    def top_ops(self, n: int = 10) -> list:
        by_name: dict[str, int] = {}
        for s, e, name in self.ops:
            by_name[name] = by_name.get(name, 0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v / 1e9] for k, v in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest gaps between device operations, by the host call
        under way when each began ("host code" when none was)."""
        ops = sorted(self.ops)
        gaps, end = [], None
        for s, e, _ in ops:
            if end is not None and s > end:
                gaps.append((s - end, end))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        starts = [c[0] for c in self.host_calls]
        by_label: dict[str, int] = {}
        for length, at in gaps:
            i = bisect.bisect_right(starts, at) - 1
            label = "host code"
            if i >= 0 and self.host_calls[i][1] >= at:
                label = self.host_calls[i][2]
            by_label[label] = by_label.get(label, 0) + length
        top = sorted(by_label.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]


def _short(name: str) -> str:
    name = name.removeprefix("void ")
    return name[:96]


def warm_up(sync, work) -> None:
    """Start and stop the profiler once around ``work``: its first start in
    a process sets up CUPTI for seconds, which belongs to set-up, not to
    the traced stretch."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        work()
        sync()


class Stretch:
    """Profile the device while the block runs; ``result`` is the
    ``DeviceTrace`` (None when the profiler saw no device operation)."""

    def __init__(self, sync):
        self.sync, self.result = sync, None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is None:
            ops, calls = _events(self.prof)
            self.result = DeviceTrace(window_s, ops, calls) if ops else None
        return False


def _events(prof):
    """Device operations and host runtime calls from the profiler's raw
    (kineto) events."""
    from torch.autograd import DeviceType

    ops, calls = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() if hasattr(ev, "start_ns") else int(ev.start_us() * 1000)
        dur = ev.duration_ns() if hasattr(ev, "duration_ns") else int(ev.duration_us() * 1000)
        rec = (start, start + dur, ev.name())
        if ev.device_type() == DeviceType.CUDA:
            ops.append(rec)
        elif ev.name().startswith("cuda"):
            calls.append(rec)
    calls.sort()
    return ops, calls
