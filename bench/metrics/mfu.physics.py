"""Model FLOPs per second of the traced stretch (the events of the forwards
dispatched in it times the per-event count of the configuration's
reference family, ``flops_per_event``), as a share of the H100's float32
peak (67 TFLOP/s, at 700 W; bench/yardstick.py), in percent."""

from bench import harness, yardstick


def read(run):
    dt, n = run.device_trace, run.counters.get("forwards_traced", 0)
    if dt is None or n == 0:
        return None
    events = n * run.counters["events_per_forward"]
    flops = events * harness.reference(run.config).flops_per_event(run.config["model_config"])
    return flops / dt.window_s / yardstick.PEAKS["float32"] * 100.0
