"""The scheduler's queue wait: the 95th percentile, over every request sent
in the window, of the engine's admission stamp (``Request.admitted_at``)
less the moment it was sent; a request never admitted counts as missing."""

import math

from bench import stats


def read(run):
    if not run.requests:
        return None
    waits = [(q["admitted"] - q["sent"]) if q["admitted"] > 0 else math.inf
             for q in run.requests]
    return stats.percentile(waits, 95) * 1e3
