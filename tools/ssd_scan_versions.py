#!/usr/bin/env python3
"""Time the port's SSD scan kernel at mamba2-130m's prefill shapes, for the
checkout this script sits in or another one, on one CUDA device.

    python3 tools/ssd_scan_versions.py [--root DIR] [--label NAME]

At (b, 2048 steps, 24 heads, P 64, N 128, one group, chunk 64) for b = 1
and 8, in float32 and bfloat16, it calls ``ssd_with_state`` of
``DIR/src/repro_torch`` (the kernel DIR builds into ``DIR/build``), holds y
and the final state against the plain version, and prints per shape the ms
per call (CUDA events, back to back) and the profiler's device ms, summed
and by kernel.  Then the error at (2, 256, 6, 64, 128) with head i's x and
a scaled by i + 1 (|y| over 100), beside max |y|.  To compare two
checkouts on one card, run it for each in turns (a, b, b, a) in one call.
Each run appends a JSON line to ``ssd_scan_versions.jsonl`` beside
``chip_smoke.py``'s output.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SHAPES = [(b, 2048, 24, 64, 128, 1, 64, dtype) for dtype in ("float32", "bfloat16")
          for b in (1, 8)]


def inputs(torch, b, l, h, p, n, groups, seed, dtype, dev):
    g = torch.Generator().manual_seed(seed)
    x = [torch.randn(b, l, h, p, generator=g) * 0.5,
         -torch.randn(b, l, h, generator=g).abs() * 0.3,
         torch.randn(b, l, groups, n, generator=g) * 0.5,
         torch.randn(b, l, groups, n, generator=g) * 0.5]
    return [t.to(dev, getattr(torch, dtype)) for t in x]


def device_times(torch, fn, iters=20) -> dict[str, float]:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times: dict[str, float] = {}
    for e in prof.key_averages():
        if (us := getattr(e, "self_device_time_total", 0)) > 0:
            name = re.sub(r"\(.*", "", e.key.replace("(anonymous namespace)::", ""))
            name = name.split("::")[-1]
            times[name] = times.get(name, 0.0) + us / iters / 1e3
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve() / "src"))
    import torch

    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_with_state

    if not torch.cuda.is_available():
        print("ssd_scan_versions: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")

    def plain(x, q):
        rep = x[0].shape[2] // x[2].shape[2]
        return ssd_chunked(x[0].float(), x[1].float(), x[2].float().repeat_interleave(rep, 2),
                           x[3].float().repeat_interleave(rep, 2), chunk=q)

    rows = []
    for b, l, h, p, n, groups, q, dtype in SHAPES:
        x = inputs(torch, b, l, h, p, n, groups, l + p + n + h, dtype, dev)
        y, s = ssd_with_state(*x, chunk=q)
        y_ref, s_ref = plain(x, q)
        err_y = float((y.float() - y_ref.to(y.dtype).float()).abs().max())
        err_s = float((s - s_ref).abs().max())

        def call():
            return ssd_with_state(*x, chunk=q)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        iters = 20
        start.record()
        for _ in range(iters):
            call()
        end.record()
        torch.cuda.synchronize()
        times = device_times(torch, call)
        rows.append(dict(shape=[b * h, l, p, n], dtype=dtype, ms=start.elapsed_time(end) / iters,
                         device_ms=sum(times.values()), by_kernel=times, err_y=err_y,
                         err_state=err_s))
    # head-scaled inputs: |y| of tens, the 1e-4 absolute tolerance's edge
    x = inputs(torch, 2, 256, 6, 64, 128, 1, 3, "float32", dev)
    scale = torch.arange(1, 7, dtype=torch.float32, device=dev)
    x = [x[0] * scale[:, None], x[1] * scale, x[2], x[3]]
    y, s = ssd_with_state(*x, chunk=64)
    y_ref, s_ref = plain(x, 64)
    scaled = dict(err_y=float((y - y_ref).abs().max()), err_state=float((s - s_ref).abs().max()),
                  max_abs_y=float(y_ref.abs().max()))
    name = torch.cuda.get_device_name(0)
    for r in rows:
        print(f"[{args.label}] {r['shape']} {r['dtype']:8s} ms {r['ms']:.4f} device ms "
              f"{r['device_ms']:.4f} err y {r['err_y']:.2e} state {r['err_state']:.2e} "
              + " ".join(f"{k}={v:.4f}" for k, v in r["by_kernel"].items()))
    print(f"[{args.label}] head-scaled (2,256,6,64,128) f32: {scaled}  ({name})")
    sys.path.insert(0, str(HERE))
    from chip_smoke import OUT

    out = OUT.parent / "ssd_scan_versions.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        f.write(json.dumps(dict(label=args.label, device=name, rows=rows, scaled=scaled)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
