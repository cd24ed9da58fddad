#!/usr/bin/env python3
"""One phase of ``chip_smoke.py`` alone on one GPU.

    python3 tools/phase.py NAME [--kernels] [--float-run] [--seeds N]

NAME picks ``chip_smoke.phase_<NAME>``, one of ``PHASES``.  Builds every
kernel, runs that phase on the card and writes its results and launch
counts to ``chiprun_out/<NAME>_phase.json``.  ``roofline`` alone has no
earlier phase's device times, so it skips its bound check.

``--kernels`` first runs phase 2's kernel cases at the shapes of that path
(``chip_smoke._<NAME>_kernel_cases``; int8_moe, mla and families have
them).
``--float-run`` (int8_moe) first serves granite-8b under ``float`` as phase
7b does, dense and paged, so that phase 9d has its comparison.  ``--seeds N``
(train) then runs the physics workflow from N more init seeds (1 .. N), to
show how far the AUCs move with the init alone.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("models", "mha", "lut_softmax_path", "mamba", "dense", "serve", "train", "int8_moe",
          "mla", "families", "roofline", "engine", "tp")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("name", choices=PHASES)
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--float-run", action="store_true")
    ap.add_argument("--seeds", type=int, default=0)
    args = ap.parse_args(argv)
    import chip_smoke as cs

    if args.kernels and not hasattr(cs, f"_{args.name}_kernel_cases"):
        ap.error(f"phase {args.name} has no kernel cases of its own")
    if args.float_run and args.name != "int8_moe":
        ap.error("--float-run belongs to int8_moe")
    if args.seeds and args.name != "train":
        ap.error("--seeds belongs to train")
    # phase 8 trains under deterministic algorithms, which need cuBLAS's
    # fixed workspace from the first cuBLAS call (as chip_smoke.main sets it)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from repro_torch import resolve_device
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("phase: no CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"[env] {smi}; torch {torch.__version__}")
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")
    out = {"nvidia_smi": smi}
    if args.kernels:
        out["kernels"] = getattr(cs, f"_{args.name}_kernel_cases")(dev)
        cs._report_cases(out["kernels"])
    extra = ()
    if args.name == "int8_moe":
        out["float_runs"] = (cs._granite_serve_runs(dev, cs.SERVE_LAYOUTS[:2])
                             if args.float_run else None)
        extra = (out["float_runs"],)
    t1 = time.perf_counter()
    out["phase"], out["launches"] = getattr(cs, f"phase_{args.name}")(dev, *extra)
    cs.log(f"[phase] {args.name}: {time.perf_counter() - t1:.1f} s")
    if args.seeds:
        out["seed_spread"] = cs._workflow_seed_spread(dev, args.seeds)
    path = ROOT / "chiprun_out" / f"{args.name}_phase.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    cs.log(f"[done] {time.perf_counter() - t0:.1f} s; {path.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
