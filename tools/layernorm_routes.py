#!/usr/bin/env python3
"""Time each route of the port's layernorm kernel at rows around the
route boundaries, and the wrapper's host cost, on one CUDA device.

    python3 tools/layernorm_routes.py

For each (rows, K, dtype) it runs the kernel under every plan that can hold
the row (a warp per row with NV vectors per lane, a block per row with NV
vectors per thread; ``kernels/layernorm/ops.py:_plan`` picks one of them),
checks each against the plain version, and prints the profiler's device ms
per call beside the bytes bound (x read once, out written once, gamma and
beta read once at 3.35 TB/s).  Then, at mamba2-130m's decode norm (1 x 768
bf16), the host-inclusive ms per call of the wrapper, of the wrapper with
its C entry replaced by a no-op (the Python side alone), of
``torch.empty_like`` and of ``F.rms_norm``.  It also lists the kernel
instances that ptxas reports spilling.  The full table goes to
``chiprun_out/layernorm_routes.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (rows, K, dtype): mamba2-130m's norms (768, 1536) at decode and prefill
# rows, and rows of 6 to 32 KB
SHAPES = [(rows, k, dtype) for dtype in ("float32", "bfloat16") for k in (768, 1536)
          for rows in (1, 8, 512, 2048, 16384)]
SHAPES += [(16384, 2048, "float32"), (4096, 4096, "bfloat16"), (4096, 4096, "float32"),
           (16384, 3072, "bfloat16"), (2048, 8192, "float32")]


def spilling_instances(log: str) -> list[str]:
    """Kernels whose ptxas report (``-Xptxas -v``) shows spills or a stack
    frame, demangled where the toolkit's ``cu++filt`` is at hand."""
    import shutil

    names, fn = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        elif fn and "stack frame" in line and not line.strip().startswith("0 bytes stack frame"):
            names.append(f"{fn}: {line.strip()}")
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    try:
        return [subprocess.run([filt, n.split(":")[0]], capture_output=True, text=True,
                               check=True).stdout.strip() + ":" + n.split(":", 1)[1]
                for n in names]
    except (OSError, subprocess.CalledProcessError):
        return names


def host_costs(ops, layernorm) -> dict:
    """Host-inclusive ms per call at (1, 768) bf16 RMS, back to back."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import time_ms

    x = torch.randn(1, 768, device="cuda", dtype=torch.bfloat16)
    gamma = torch.randn(768, device="cuda", dtype=torch.bfloat16)
    res = {"wrapper": time_ms(lambda: layernorm(x, gamma, rms=True), 2000),
           "rms_norm": time_ms(lambda: F.rms_norm(x, (768,), gamma, 1e-5), 2000),
           "empty_like": time_ms(lambda: torch.empty_like(x), 2000)}
    entry = ops._entry
    ops._entry = lambda device: (lambda *args: 0)
    try:
        res["wrapper_no_launch"] = time_ms(lambda: layernorm(x, gamma, rms=True), 2000)
    finally:
        ops._entry = entry
    return res


def candidates(k: int, itemsize: int) -> list[tuple[int, int, int]]:
    """The 16-byte-vector instances that hold a row of k: the first warp
    instance that fits, and each block instance of 64 to 512 threads."""
    from repro_torch.kernels.layernorm import ops

    vec = 16 // itemsize
    nvec = -(-k // vec)
    plans = [(vec, nv, 32) for nv in ops._WARP_NV if 32 * nv >= nvec][:1]
    for nv in (1, 2, 4, 8, 16):
        threads = 32 * -(-nvec // (32 * nv))
        if 64 <= threads <= ops._MAX_THREADS:
            plans.append((vec, nv, threads))
    return plans


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("layernorm_routes: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import LN_ATOL, PEAK_BYTES, device_ms
    from repro_torch.kernels import build
    from repro_torch.kernels.layernorm import layernorm, layernorm_ref, ops

    spills = spilling_instances(build.build_all(("layernorm",))["layernorm"]["log"])
    for line in spills:
        print(f"[spill] {line}", flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    auto_plan = ops._plan
    rows_out = []
    try:
        for rows, k, dtype in SHAPES:
            tdt = getattr(torch, dtype)
            g = torch.Generator().manual_seed(rows + k)
            x = (torch.randn(rows, k, generator=g) * 3).to("cuda", tdt)
            gamma, beta = (torch.randn(k, generator=g).to("cuda", tdt) for _ in range(2))
            ref = layernorm_ref(x, gamma, beta)
            nbytes = 2 * x.numel() * x.element_size() + 2 * k * x.element_size()
            auto = auto_plan(k, x.element_size(), True, rows <= ops.FEW_ROWS)
            plans = candidates(k, x.element_size())
            for plan in ([] if auto in plans else [auto]) + plans:
                ops._plan = lambda *_, p=plan: p
                ops._flags.cache_clear()
                out = layernorm(x, gamma, beta)
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                ok = err <= LN_ATOL + (0 if dtype == "float32" else 2.0 ** -7 * float(
                    ref.float().abs().max()))
                ms = device_ms(lambda: layernorm(x, gamma, beta))
                r = dict(rows=rows, k=k, dtype=dtype, plan=list(plan), auto=plan == auto,
                         device_ms=ms, bound_ms=nbytes / PEAK_BYTES * 1e3, max_abs_err=err,
                         ok=ok)
                rows_out.append(r)
                timing = ("device ms not measured (empty trace)" if ms is None else
                          f"device ms {ms:.4f} bound {r['bound_ms']:.4f} "
                          f"({r['bound_ms'] / ms:.0%})")
                print(f"[route] ({rows}, {k}) {dtype:8s} VEC {plan[0]} NV {plan[1]:2d} "
                      f"{'warp' if plan[2] == 32 else f'block {plan[2]}':9s}"
                      f"{' (auto)' if r['auto'] else '       '} {timing} err {err:.1e} "
                      f"{'OK' if ok else 'FAIL'}", flush=True)
    finally:
        ops._plan = auto_plan
        ops._flags.cache_clear()
    host = host_costs(ops, layernorm)
    print("[host] ms per call at (1, 768) bf16 RMS: " + ", ".join(
        f"{name} {ms:.4f}" for name, ms in host.items()), flush=True)
    out = ROOT / "chiprun_out" / "layernorm_routes.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": smi, "routes": rows_out, "host_ms": host,
                               "spills": spills}, indent=1))
    print(smi)
    return 0 if all(r["ok"] for r in rows_out) else 1


if __name__ == "__main__":
    sys.exit(main())
