#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 8 (training) alone on one GPU, and the spread of
the physics workflow's AUCs over init seeds.

    python3 tools/train_phase.py [--seeds N]

Builds the attention and layernorm kernels, runs ``chip_smoke.phase_train``
(the gradients of the two autograd.Functions, the three kernels that refuse
grad, the physics workflow against the JAX package's values, the
granite-width LM run with its bitwise restart), then, with ``--seeds N``,
the float / PTQ / QAT workflow of each encoder from N more init seeds (1 ..
N), to show how far the AUCs move with the init alone.  Writes
``chiprun_out/train_phase.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, default=0)
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import chip_smoke as cs
    from repro_torch import resolve_device
    from repro_torch.examples import physics_inference as wf
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("train_phase: no CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    free_gb = shutil.disk_usage(build.BUILD_DIR).free / 1e9
    cs.log(f"[env] {smi}; torch {torch.__version__}; {free_gb:.0f} GB free beside build/")
    t0 = time.perf_counter()
    build.build_all(("flash_attention", "layernorm"))
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")
    out = {"nvidia_smi": smi}
    out["phase"], out["launches"] = cs.phase_train(dev)
    spread = {}
    for name in cs.MODELS:
        for policy in (None, "paper_vu13p"):
            rows = []
            for seed in range(1, args.seeds + 1):
                w = wf.workflow(name, policy, device=dev, seed=seed)
                rows.append((w["auc_float"], w["ratio_ptq"], w["ratio_qat"]))
            if rows:
                cols = list(zip(*rows))
                spread[f"{name}/{policy}"] = {
                    "values": rows, "mean": [statistics.fmean(c) for c in cols],
                    "stdev": [statistics.stdev(c) if len(c) > 1 else 0.0 for c in cols]}
                cs.log(f"[seeds] {name:14s} {policy or 'paper-optimal':13s} seeds 1-{args.seeds}: "
                       f"float AUC / PTQ ratio / QAT ratio mean "
                       f"{[round(m, 4) for m in spread[f'{name}/{policy}']['mean']]} stdev "
                       f"{[round(s, 4) for s in spread[f'{name}/{policy}']['stdev']]}")
    out["seed_spread"] = spread
    path = ROOT / "chiprun_out" / "train_phase.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    cs.log(f"[done] {time.perf_counter() - t0:.1f} s; {path.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
