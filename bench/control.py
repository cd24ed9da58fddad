"""Readings that set a cell's correctness limits, on the card, at the cell's
own size, in one process:

- the program's numbers over ``--seeds`` (short windows at the cell's load),
  which give the lower reading of each limit;
- the control's numbers over the first ``--control-seeds`` of them: the
  plain reference put in the program's place and computed in the nearest
  precision below the configuration's, which give the upper reading.  Each
  control is judged as a run is, its numbers against the cell's limits,
  and has to come out not correct.

    python3 bench/control.py --workload gw-emulate-8192 --seconds 3 \\
        --seeds 11 12 13 ... --control-seeds 3

The controls are those of the configuration's reference module
(``CONTROLS``), read by the cell's driver (``control``), both found by name.
Prints one JSON line per seed and writes them all to ``--out``; exits 1 if
a control came out correct.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402


def control_run(r: harness.Run, name: str) -> harness.Run:
    """``r`` judged with the control ``name`` of its configuration's
    reference in the program's place (after ``r`` ran, its inputs kept)."""
    kwargs = harness.reference(r.config).CONTROLS[name]
    return r.judged(harness.driver(r.traffic).control(r, kwargs))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--controls", nargs="*", default=None,
                    help="controls of the configuration's reference to read (default: "
                         "the configuration's own)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "control.jsonl"))
    args = ap.parse_args()
    import torch

    from bench.drivers import common

    spec = harness.load_spec(ROOT)
    cell, config, mix = harness.cell_files(spec, args.workload, ROOT)
    names = args.controls if args.controls is not None else [config["control"]]
    passed = []
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as out:
        for i, seed in enumerate(args.seeds):
            r = harness.Run(workload=args.workload, cell=cell, config=config, traffic=mix,
                            seed=seed, seconds=args.seconds, trace=False,
                            device=torch.device("cuda", 0), t_process=time.perf_counter())
            harness.driver(mix).run(r)
            line = {"workload": args.workload, "seed": seed, "setup_s": r.setup_s,
                    "metrics": r.metrics, "correct": r.correct,
                    "program": {k: v for k, (v, _) in r.checks.items()},
                    "counters": r.counters}
            if i < args.control_seeds:
                line["control"] = {}
                for name in names:
                    t = time.perf_counter()
                    judged = control_run(r, name)
                    line["control"][name] = {
                        **{k: v for k, (v, _) in judged.checks.items()},
                        "correct": judged.correct, "seconds": time.perf_counter() - t}
                    if judged.correct:
                        passed.append((seed, name))
            r.kept.clear()
            common.free_device_memory()
            print(json.dumps(line), flush=True)
            out.write(json.dumps(line) + "\n")
    if passed:
        print(f"controls that came out correct: {passed}", file=sys.stderr)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
