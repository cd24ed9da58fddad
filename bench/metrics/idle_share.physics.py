"""The share of the traced stretch's wall time in which no device operation
ran (one minus the union of their intervals over the stretch), in percent."""


def read(run):
    dt = run.device_trace
    if dt is None or dt.window_s <= 0:
        return None
    return (1.0 - dt.busy_s() / dt.window_s) * 100.0
