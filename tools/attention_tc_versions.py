#!/usr/bin/env python3
"""Time the port's tensor-core attention (head_dim 64, 96 / 64 and 128) at
the LM paths' shapes, for the checkout this script sits in or another one,
on one CUDA device.

    python3 tools/attention_tc_versions.py [--root DIR] [--label NAME] [--heads-fastest]

It calls ``mha`` of ``DIR/src/repro_torch`` (the kernel DIR builds into
``DIR/build``) on seeded random inputs at minicpm3-4b's prefill attend (q/k
96, V 64; a checkout whose ``mha`` takes no V head_dim of its own gets V
zero-padded to 96 and its output sliced, as its model did), granite-8b's,
granite-moe-3b's, starcoder2-7b's window and the (1, 8, 1024) causal
shapes, holds each result against the plain version, and prints per shape
the profiler's device ms per call (every kernel of the call: a pad copy
too).  ``--heads-fastest`` first rebuilds the kernel from DIR's source with
one head group spanning the grid, i.e. the grid order heads fastest (the
order before the grouped one), and times that.  To compare two checkouts
on one card, run it for each in turns (a, b, b, a) in one call.  Each run
appends a JSON line to ``attention_tc_versions.jsonl`` beside
``chip_smoke.py``'s output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# (b, hq, hkv, l, d, dv, dtype, mode, causal, window)
CASES = [
    (8, 40, 40, 2048, 96, 64, "bfloat16", "safe", True, None),  # minicpm3-4b, float
    (8, 40, 40, 2048, 96, 64, "float32", "lut", True, None),  # minicpm3-4b, int8_serve
    (8, 32, 8, 2048, 128, 128, "bfloat16", "safe", True, None),  # granite-8b
    (8, 24, 8, 2048, 64, 64, "bfloat16", "lut", True, None),  # granite-moe-3b
    (8, 24, 8, 2048, 64, 64, "float32", "lut", True, None),  # granite-moe-3b, int8 KV
    (1, 36, 4, 8192, 128, 128, "bfloat16", "safe", True, 4096),  # starcoder2-7b's window
    (1, 8, 8, 1024, 64, 64, "float32", "safe", True, None),
    (1, 8, 8, 1024, 128, 128, "float32", "safe", True, None),
    (1, 8, 8, 1024, 64, 64, "bfloat16", "safe", True, None),
]
GRID_PATCH = ("    const int heads_per_group =\n",
              "    const int heads_per_group = B * Hq;\n    const int heads_grouped =\n")


def device_ms(torch, fn, iters=10) -> float | None:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a trace now and then comes back empty: one more try
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(t for e in prof.key_averages()
                 if (t := getattr(e, "self_device_time_total", 0)) > 0)
        if us:
            return us / iters / 1e3
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--heads-fastest", action="store_true")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import mha, mha_ref, ops

    if not torch.cuda.is_available():
        print("attention_tc_versions: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    build.build_all(("flash_attention",))
    if args.heads_fastest:  # the same source, one head group over the grid
        src = (build.CSRC / "flash_attention.cu").read_text()
        if GRID_PATCH[0] not in src:
            raise SystemExit("--heads-fastest: the grid-order line is not in this source")
        cu = build.BUILD_DIR / "variant_heads_fastest.cu"
        cu.write_text(src.replace(GRID_PATCH[0], GRID_PATCH[1]))
        lib = build.BUILD_DIR / "variant_heads_fastest.so"
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(lib),
                        str(cu)], check=True, capture_output=True)
        fn = ctypes.CDLL(str(lib)).repro_flash_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ops._lib().argtypes
        ops._lib = lambda: fn
    native_dv = hasattr(ops, "kernel_head_dims")
    rows = []
    for b, hq, hkv, l, d, dv, dtype, mode, causal, window in CASES:
        g = torch.Generator().manual_seed(l * d + hq)
        tdt = getattr(torch, dtype)
        q = torch.randn(b, hq, l, d, generator=g).to(dev, tdt)
        k = torch.randn(b, hkv, l, d, generator=g).to(dev, tdt)
        v = torch.randn(b, hkv, l, dv, generator=g).to(dev, tdt)
        kw = dict(causal=causal, window=window, mode=mode)
        if native_dv or dv == d:
            def call():
                return mha(q, k, v, **kw)
        else:  # V zero-padded to q/k's head_dim, the output sliced
            def call():
                vp = torch.nn.functional.pad(v, (0, d - dv))
                return mha(q, k, vp, **kw)[..., :dv].contiguous()
        out, ref = call(), mha_ref(q, k, v, **kw)
        err = float((out.float() - ref.float()).abs().max())
        row = dict(shape=[b, hq, hkv, l, d, dv], dtype=dtype, mode=mode, causal=causal,
                   window=window, max_abs_err=err, device_ms=device_ms(torch, call))
        rows.append(row)
        dms = "not measured" if row["device_ms"] is None else f"{row['device_ms']:.4f}"
        print(f"[{args.label}] {row['shape']} {dtype:8s} {mode:4s} window={window} device ms {dms}"
              f" err {err:.2e}", flush=True)
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[{args.label}] {smi}")
    sys.path.insert(0, str(HERE))
    from chip_smoke import OUT

    out = OUT.parent / "attention_tc_versions.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as fh:
        fh.write(json.dumps(dict(label=args.label, root=str(root), nvidia_smi=smi,
                                 heads_fastest=args.heads_fastest, rows=rows)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
