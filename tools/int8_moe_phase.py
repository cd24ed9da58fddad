#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 9 (int8_serve and the MoE family) alone on one
GPU.

    python3 tools/int8_moe_phase.py [--float-run]

Builds the attention and layernorm kernels and runs
``chip_smoke.phase_int8_moe``: (a) the float32 check of granite-8b,
granite-moe-3b-a800m and dbrx-132b under int8_serve; (b) granite-moe-3b-a800m
bf16 at 32 layers through the engine; (c) its ``lm.prefill`` at 1 and 8 x
2048; (d) granite-8b bf16 at 36 layers under int8_serve.  ``--float-run``
first serves granite-8b under ``float`` (phase 7b's dense and paged runs)
so that (d) has its comparison.  Writes ``chiprun_out/int8_moe_phase.json``.
"""

from __future__ import annotations

import argparse
import json
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
    ap.add_argument("--float-run", action="store_true")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import lm

    if not torch.cuda.is_available():
        print("int8_moe_phase: no CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"[env] {smi}; torch {torch.__version__}")
    t0 = time.perf_counter()
    build.build_all(("flash_attention", "layernorm"))
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")
    out = {"nvidia_smi": smi}
    float_runs = None
    if args.float_run:
        base = get_config("granite-8b")
        params = lm.init_params(base, torch.Generator(device=dev).manual_seed(cs.SEED),
                                device=dev)
        float_runs = cs._serve_layouts(base, params, cs._serve_traffic(base),
                                       cs.SERVE_LAYOUTS[:2], dev, "[serve]")
        del params
        torch.cuda.empty_cache()
        out["float_runs"] = float_runs
    t1 = time.perf_counter()
    out["phase"], out["launches"] = cs.phase_int8_moe(dev, float_runs)
    cs.log(f"[phase] int8_moe: {time.perf_counter() - t1:.1f} s")
    path = ROOT / "chiprun_out" / "int8_moe_phase.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    cs.log(f"[done] {time.perf_counter() - t0:.1f} s; {path.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
