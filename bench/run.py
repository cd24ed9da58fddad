"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Loads and warms up the cell's configuration,
drives its traffic for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON object as the last line
of standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics read from a traced stretch of the window (``--trace 1``).
Exits non-zero, printing no result, without a card (or fewer than the cell
asks for), without the program beside it, or when the process holds a
module of the JAX package or of JAX after the window.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        print(f"--seed must be >= 0, got {args.seed}", file=sys.stderr)
        return 2
    # every build and kernel cache inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / "cache" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    spec = harness.load_spec(ROOT)
    cell, config, traffic = harness.cell_files(spec, args.workload, ROOT)
    try:
        import torch

        import repro_torch  # noqa: F401
    except ImportError as err:
        print(f"cannot import the program under test: {err}", file=sys.stderr)
        return 4
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = harness.Run(workload=args.workload, cell=cell, config=config, traffic=traffic,
                      seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device=torch.device("cuda", 0), t_process=T_PROCESS)
    run.mark("torch and the program imported")
    harness.driver(traffic).run(run)
    bad = harness.banned_modules()
    if bad:
        print(f"the process holds banned modules after the window: {bad}", file=sys.stderr)
        return 3
    line = harness.result_line(spec, run)
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in run.marks), file=sys.stderr)
    for name, (value, limit) in run.checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
