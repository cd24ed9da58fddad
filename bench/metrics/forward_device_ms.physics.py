"""Device milliseconds per physics forward: the union of the device's
operation intervals over the traced stretch, over the forwards dispatched
in it (the stretch opens and closes on an idle device)."""


def read(run):
    dt, n = run.device_trace, run.counters.get("forwards_traced", 0)
    if dt is None or n == 0:
        return None
    return dt.busy_s() / n * 1e3
