"""The executor's inter-token latency: per request with two tokens or more,
all of them inside the window, (last - first TokenEvent.ts) / (tokens - 1),
the median over those requests.  (A decode dispatch emits its steps' tokens
with one stamp, so the gaps between single stamps are mostly 0.)"""

import statistics


def read(run):
    t0, t_end = run.window
    per = [(q["ts"][-1] - q["ts"][0]) / (len(q["ts"]) - 1) for q in run.requests
           if len(q["ts"]) >= 2 and t0 <= q["ts"][0] and q["ts"][-1] <= t_end]
    return statistics.median(per) * 1e3 if per else None
