#!/usr/bin/env python3
"""One benchmark cell run as ``bench/run.py`` runs it, with the port's spans
(``repro_torch.trace``) recorded and read beside its device trace.

    python3 tools/span_stretch.py --workload W --seed N --seconds S [--mode traced|spans|plain]

From the root of a checkout, on a card.  ``--mode traced`` (the default) is
the benchmark's ``--trace 1`` run with the recorder on over the traced
stretch too; from the spans and the stretch's device trace it reads

- ``precision_share.physics``: device time of the operations launched in
  ``precision`` spans over that of those launched in ``physics.forward``
  spans (each the union of their intervals), in percent;
- ``prefill_device_ms.serve`` / ``decode_device_ms.serve``: device time of
  the operations launched in ``prefill`` / ``decode`` spans over the spans;
- ``prefill_padding_share.serve``: 1 - Σ ``fill_tokens`` / Σ
  (``max_batch`` x ``bucket``) of the ``prefill`` spans, in percent;
- ``host_idle_share.serve``: the stretch's device idle time while the
  innermost open span lay in an ``engine.step`` and was neither ``device``
  nor ``collect``'s own wait, over the stretch, in percent;

and prints the stretch's idle time by innermost span to standard error.
``--mode spans`` records spans over the whole window with no profiler and
``--mode plain`` records none (both as ``--trace 0``): their end-to-end
metrics, one against the other on one seed, give the recorder's cost.
Prints the cell's result line as ``bench/run.py`` does, then one JSON line
of readings, also written to ``chiprun_out/spans/<workload>-<seed>-<mode>.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(spans, ops, t0: int, t1: int) -> dict:
    """The five span metrics of a stretch [t0, t1) (those it has spans for)."""
    from repro_torch import trace

    out = {}
    names = {s.name for s in spans}
    if "physics.forward" in names:
        whole = trace.device_ns_under(spans, ops, "physics.forward")
        if whole:
            out["precision_share.physics"] = (
                trace.device_ns_under(spans, ops, "precision") / whole * 100.0)
    for name in ("prefill", "decode"):
        n = sum(s.name == name for s in spans)
        if n:
            out[f"{name}_device_ms.serve"] = trace.device_ns_under(spans, ops, name) / n / 1e6
    share = trace.padding_share(spans)
    if share is not None:
        out["prefill_padding_share.serve"] = share * 100.0
    if "engine.step" in names:
        out["host_idle_share.serve"] = trace.host_idle_ns(spans, ops, t0, t1) / (t1 - t0) * 100.0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=("traced", "spans", "plain"), default="traced")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness
    from bench import run as bench_run

    from repro_torch import trace

    got: dict = {}

    class SpanStretch(harness.TracedStretch):
        """The benchmark's traced stretch, the recorder on inside it (or over
        the whole window under ``--mode spans``)."""

        def poll(self, now):
            was = self.active
            super().poll(now)
            if "t0" not in got and (args.mode == "spans" or (self.active and not was)):
                trace.start()
                got["t0"] = time.time_ns()

        def close(self):
            if "t0" in got and "t1" not in got:
                got["t1"], got["spans"] = time.time_ns(), trace.stop()
            super().close()
            if args.mode == "traced" and self.run.device_trace is not None:
                got["ops"] = trace.device_ops(self.stretch.prof)

    line_of = harness.result_line

    def result_line(spec, run):
        got["run"] = run
        return line_of(spec, run)

    harness.TracedStretch, harness.result_line = SpanStretch, result_line
    rc = bench_run.main(["--workload", args.workload, "--seed", str(args.seed),
                         "--seconds", str(args.seconds),
                         "--trace", "1" if args.mode == "traced" else "0"])
    if rc or "run" not in got:
        return rc or 1
    run = got["run"]
    out = {"workload": args.workload, "seed": args.seed, "mode": args.mode,
           "end_to_end": dict(run.metrics, setup_s=run.setup_s), "correct": run.correct}
    if "spans" in got:
        t0, t1, spans = got["t0"], got["t1"], got["spans"]
        out["spans"] = len(spans)
        out["spans_per_s"] = len(spans) / ((t1 - t0) / 1e9)
    if "ops" in got:
        ops = got["ops"]
        out["stretch_s"] = (t1 - t0) / 1e9
        out["ops"], out["ops_unlinked"] = len(ops), sum(1 for op in ops if not op[3])
        out["metrics"] = readings(spans, ops, t0, t1)
        idle = sorted(trace.idle_by_name(spans, ops, t0, t1).items(), key=lambda kv: -kv[1])
        out["idle_by_span_s"] = {k: v / 1e9 for k, v in idle}
        print("idle by innermost span (s of %.3f): " % out["stretch_s"]
              + ", ".join(f"{k} {v / 1e9:.4f}" for k, v in idle), file=sys.stderr)
    dest = ROOT / "chiprun_out" / "spans"
    dest.mkdir(parents=True, exist_ok=True)
    (dest / f"{args.workload}-{args.seed}-{args.mode}.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
