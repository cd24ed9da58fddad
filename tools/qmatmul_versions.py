#!/usr/bin/env python3
"""Time the port's int8 GEMM (``qmatmul_int8``) at the main path's shapes,
for the checkout this script sits in or another one, on one CUDA device.

    python3 tools/qmatmul_versions.py [--root DIR] [--label NAME]

At the streaming MHA's stage 1/4 shapes (the encoders' at batch 8192,
granite-8b's (1024, 4096, 4096)) and at 4096^3, it calls ``qmatmul_int8``
of ``DIR/src/repro_torch`` (the kernel DIR builds into ``DIR/build``) on
seeded random codes, with the K-major weight copy where that version takes
one, holds the result bitwise against the plain version, and prints per
shape the ms per call (CUDA events, back to back), the profiler's device ms
of the qmatmul kernel and of the whole call, the host's us per call (the
wrapper's own cost where the device is quicker, as at batch 1) and
``torch._int_mm``'s device ms (the int32 product alone, a yardstick, where
it takes the shape).  To compare two checkouts on one card, run it for
each in turns (a, b, b, a) in one call.  Each run appends a
JSON line to ``qmatmul_versions.jsonl`` beside ``chip_smoke.py``'s output.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# (M, K, N, R): engine_anomaly, btagging, gw at batch 8192; granite-8b; 4096^3;
# btagging at batch 1
SHAPES = [(409600, 16, 16, 1), (122880, 64, 64, 1), (819200, 32, 32, 1),
          (1024, 4096, 4096, 1), (1024, 4096, 4096, 8), (4096, 4096, 4096, 1),
          (15, 64, 64, 1)]


def device_times(torch, fn, iters=20) -> dict[str, float]:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a trace now and then comes back empty: one more try
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = {e.key: us / iters / 1e3 for e in prof.key_averages()
                 if (us := getattr(e, "self_device_time_total", 0)) > 0}
        if times:
            return times
    return {}


def events_ms(torch, fn, iters=50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, iters=2000) -> float:
    """Host time per call of back-to-back calls, before the device drains."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve() / "src"))
    import torch

    from repro_torch.kernels.qmatmul import qmatmul_int8, qmatmul_ref

    if not torch.cuda.is_available():
        print("qmatmul_versions: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    takes_kmajor = "w_kmajor" in inspect.signature(qmatmul_int8).parameters
    rows = []
    for m, k, n, r in SHAPES:
        g = torch.Generator(device=dev).manual_seed(m + 3 * k + 7 * n)
        x = torch.randint(-128, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        xs = torch.rand(m, 1, generator=g, device=dev) * 0.05 + 1e-3
        ws = torch.rand(1, n, generator=g, device=dev) * 0.05 + 1e-3
        kw = {"w_kmajor": w.t().contiguous()} if takes_kmajor else {}

        def call():
            return qmatmul_int8(x, w, xs, ws, grid_k=r, **kw)

        bitwise = bool(torch.equal(call(), qmatmul_ref(x, w, xs, ws)))
        ms = events_ms(torch, call, 20 if m * n * k > 1e10 else 50)
        times = device_times(torch, call)
        kernel = {key: t for key, t in times.items() if "qmatmul" in key}
        try:
            lib = device_times(torch, lambda: torch._int_mm(x, w))
        except RuntimeError:  # a shape _int_mm does not take (M <= 16)
            lib = {}
        rows.append(dict(shape=[m, k, n], R=r, bitwise=bitwise, ms=ms,
                         host_us=host_us(torch, call),
                         kernel_device_ms=sum(kernel.values()) or None,
                         call_device_ms=sum(times.values()) or None,
                         kernels=sorted(key[:60] for key in kernel),
                         int_mm_device_ms=sum(lib.values()) or None))
    name = torch.cuda.get_device_name(0)
    for row in rows:
        def f(v):
            return "n/a" if v is None else f"{v:.4f}"

        print(f"[{args.label}] {row['shape']} R={row['R']} bitwise={row['bitwise']} ms "
              f"{row['ms']:.4f} host us {row['host_us']:.2f} kernel device ms "
              f"{f(row['kernel_device_ms'])} call "
              f"{f(row['call_device_ms'])} _int_mm {f(row['int_mm_device_ms'])} "
              f"{row['kernels']}")
    sys.path.insert(0, str(HERE))
    from chip_smoke import OUT

    out = OUT.parent / "qmatmul_versions.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as fh:
        fh.write(json.dumps(dict(label=args.label, device=name, rows=rows)) + "\n")
    return 0 if all(row["bitwise"] for row in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
