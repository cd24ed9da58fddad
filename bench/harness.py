"""The benchmark's common half: reading ``BENCHMARK.json`` and a cell's
files by name, the run record the drivers fill, the per-layer readers, the
calls recorded around the program's layers in a traced stretch, and the
result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name: ``bench/configs/<config>.json``
(through the configuration's ``file``), whose ``reference`` names a module
of ``bench/references`` (the plain reference of the model family, its
controls and its FLOPs) and whose ``kernels`` are the program's kernels
built in set-up; ``bench/traffic/<traffic>.json``, whose ``driver`` names
a module of ``bench/drivers`` (``run(run)`` drives the window and checks
it against the reference, ``control(run, kwargs)`` reads a control's
numbers); and ``bench/metrics/<metric>.py``, whose ``read(run)`` returns
the metric or None when the run holds nothing to read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
#: top-level module names that no process of the benchmark may hold: the
#: reference package and its framework, which the port replaces
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_files(spec: dict, workload: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(cell, configuration file, traffic file) of the cell named ``workload``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "bench" / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def banned_modules() -> list[str]:
    """The banned top-level names among the loaded modules, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


@dataclasses.dataclass
class Run:
    """One run of one cell: its inputs, and what the driver measured."""

    workload: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t_process: float  # host clock at process start
    setup_s: float | None = None
    window: tuple[float, float] | None = None  # (start, end), host clock
    device_trace: object = None  # trace.DeviceTrace of the traced stretch
    calls: dict = dataclasses.field(default_factory=dict)  # layer -> recorded calls
    counters: dict = dataclasses.field(default_factory=dict)
    requests: list = dataclasses.field(default_factory=list)
    metrics: dict = dataclasses.field(default_factory=dict)  # end-to-end
    checks: dict = dataclasses.field(default_factory=dict)  # name -> (value, limit)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    #: the inputs and outputs the check compared, for bench/control.py
    kept: dict = dataclasses.field(default_factory=dict)
    #: (step, seconds since process start) of set-up's steps, for stderr
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, step: str) -> None:
        self.marks.append((step, time.perf_counter() - self.t_process))

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_process
        self.marks.append(("setup done", self.setup_s))

    @property
    def window_s(self) -> float | None:
        return None if self.window is None else self.window[1] - self.window[0]

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for v, lim in self.checks.values())

    def judged(self, numbers: dict) -> "Run":
        """This run with ``numbers`` (a control's readings) in place of its
        checked numbers, each against the same limit."""
        missing = set(self.checks) - set(numbers)
        if missing:
            raise KeyError(f"no reading of {sorted(missing)}")
        return dataclasses.replace(self, checks={k: (float(numbers[k]), lim)
                                                 for k, (_, lim) in self.checks.items()})


@contextlib.contextmanager
def recording(run: Run, module, attr: str, layer: str, describe):
    """Record ``describe(*args, **kw)`` of every call of ``module.attr``
    made inside the block into ``run.calls[layer]``: a span around a call
    into one of the program's layers, taken by the benchmark."""
    original = getattr(module, attr)
    calls = run.calls.setdefault(layer, [])

    @functools.wraps(original)
    def recorded(*args, **kw):
        calls.append(describe(*args, **kw))
        return original(*args, **kw)

    setattr(module, attr, recorded)
    try:
        yield
    finally:
        setattr(module, attr, original)


class TracedStretch:
    """The traced stretch of a ``--trace 1`` window: its last ``length``
    seconds (the window's end at ``end``, host clock), with the device
    profiled and the calls into ``layers`` ((module, attribute, layer name,
    describe) each) recorded, so that reading the trace falls after the
    window.  The driver calls :meth:`poll` between dispatches and
    :meth:`close` after the window; ``active`` says whether a dispatch made
    now falls inside."""

    def __init__(self, run: Run, end: float, length: float, sync, layers):
        from bench.trace import Stretch

        self.run, self.start, self.length, self.layers = run, end - length, length, layers
        self.stretch, self.stack, self.active = Stretch(sync), None, False

    def poll(self, now: float) -> None:
        if not self.run.trace:
            return
        if self.stack is None and now >= self.start:
            self.stack = contextlib.ExitStack()
            self.stack.enter_context(self.stretch)
            for module, attr, layer, describe in self.layers:
                self.stack.enter_context(recording(self.run, module, attr, layer, describe))
            self.active = True

    def close(self) -> None:
        if self.active:
            self.stack.close()
            self.active = False
            self.run.device_trace = self.stretch.result


def per_layer(spec: dict, workload: str) -> list[dict]:
    """The per-layer metrics whose ``workloads`` name this cell."""
    return [m for m in spec["per_layer"] if workload in m.get("workloads", [workload])]


def end_to_end(spec: dict, workload: str) -> list[dict]:
    return [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]


def read_per_layer(spec: dict, run: Run) -> dict:
    out = {}
    for m in per_layer(spec, run.workload):
        path = BENCH / "metrics" / f"{m['name']}.py"
        mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{len(out)}", path)
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        value = module.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def driver(traffic: dict):
    return importlib.import_module(f"bench.drivers.{traffic['driver']}")


def reference(config: dict):
    """The reference module the configuration file names."""
    return importlib.import_module(f"bench.references.{config['reference']}")


def result_line(spec: dict, run: Run) -> dict:
    import torch

    if run.trace:
        metrics = read_per_layer(spec, run)
    else:
        units = {m["name"]: m["unit"] for m in end_to_end(spec, run.workload)}
        measured = {**run.metrics, "setup_s": run.setup_s}
        metrics = {k: {"value": float(v), "unit": units[k]} for k, v in measured.items()
                   if k in units}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
           "count": int(run.cell["chips"]), "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": run.correct, "attempted": int(run.attempted), "failed": int(run.failed),
            "metrics": metrics, "device": dev}
    if run.trace and run.device_trace is not None:
        dt = run.device_trace
        dev["busy_s"], dev["window_s"] = dt.busy_s(), dt.window_s
        line["breakdown"] = {"device_ops": dt.top_ops(10), "idle_gaps": dt.idle_gaps(10)}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return line
