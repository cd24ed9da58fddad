#!/usr/bin/env python3
"""Time the int8 GEMM kernel (``csrc/qmatmul.cu``) against patched copies of
its source, on one CUDA device.

    python3 tools/qmatmul_variants.py

Each variant is the source with one ablation: ``no_epilogue`` drops the
wide route's epilogue (the K loop alone), ``no_wgmma`` skips its tensor-core
products (loads, barriers and epilogue alone), ``no_store`` drops the
streaming route's output stores.  Every copy is built by nvcc beside the
port's own libraries (``build/``), and called through its C entries at the
main path's shapes (granite-8b's stage 1/4 GEMM, 4096^3, the encoders' at
batch 8192 and at batch 1); the unpatched kernel's output is held bitwise against the plain
version.  Variants run in turns (a, b, c, c, b, a), and each prints its
profiler device ms per call.  Results go to ``qmatmul_variants.json`` beside
``chip_smoke.py``'s output.  Compare variants only within one run.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(1024, 4096, 4096), (4096, 4096, 4096), (819200, 32, 32), (122880, 64, 64),
          (409600, 16, 16), (100, 32, 32), (15, 64, 64), (50, 16, 16)]  # ... and at batch 1
WGMMA = "wgmma_m64n256k32(acc, sw128_desc(a + 32 * ks), sw128_desc(b + 32 * ks));"
EPILOGUE_START = "            // Epilogue, 32 columns at a time"
EPILOGUE_END = "        if (issuer) bulk_wait_all();"
STORE = "tma_store_2d(&out_map, ot + box * S::BM * 128, 32 * box, m0);"


def patched(src: str, name: str) -> str:
    if name == "kernel":
        return src
    if name == "no_epilogue":  # the sums stay live, or ptxas drops the wgmmas
        start, end = src.index(EPILOGUE_START), src.index(EPILOGUE_END)
        keep = ("            if (acc[0] == 0x7fffffff && acc[127] == 0x7fffffff) "
                "so[threadIdx.x] = 1;\n")
        return src[:start] + keep + "        }\n" + src[end:]
    if name == "no_wgmma":
        assert WGMMA in src
        return src.replace(WGMMA, "if (a == 0xffffffffu) " + WGMMA)
    if name == "no_store":
        assert STORE in src
        return src.replace(STORE, "")
    raise ValueError(name)


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build
    from repro_torch.kernels.qmatmul import qmatmul_ref, route

    if not torch.cuda.is_available():
        print("qmatmul_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    src = (build.CSRC / "qmatmul.cu").read_text()
    names = ["kernel", "no_epilogue", "no_wgmma", "no_store"]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = build.BUILD_DIR / f"qmatmul_variant_{name}.cu"
        cu.write_text(patched(src, name))
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc failed for {name}:\n{out[-3000:]}", file=sys.stderr)
            return 1
        fn = ctypes.CDLL(str(so)).repro_qmatmul
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        libs[name] = fn

    inputs = {}
    for m, k, n in SHAPES:
        g = torch.Generator(device=dev).manual_seed(m + 3 * k + 7 * n)
        x = torch.randint(-128, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        xs = torch.rand(m, 1, generator=g, device=dev) * 0.05 + 1e-3
        ws = torch.rand(1, n, generator=g, device=dev) * 0.05 + 1e-3
        inputs[(m, k, n)] = (x, w, w.t().contiguous(), xs, ws, torch.empty(m, n, device=dev))

    def call(fn, shape):
        m, k, n = shape
        x, w, wt, xs, ws, out = inputs[shape]
        return fn(route(k, n) == "wide", x.data_ptr(), wt.data_ptr(), xs.data_ptr(),
                  ws.data_ptr(), out.data_ptr(), m, n, n, k, 1,
                  torch.cuda.current_stream().cuda_stream)

    def device_ms(fn, shape, iters=20):
        for _ in range(3):
            if call(fn, shape):
                raise RuntimeError(f"launch failed at {shape}")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call(fn, shape)
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                 if "qmatmul" in e.key)
        return us / iters / 1e3

    bitwise = {}
    for shape in SHAPES:
        x, w, _, xs, ws, out = inputs[shape]
        call(libs["kernel"], shape)
        torch.cuda.synchronize()
        bitwise[str(shape)] = bool(torch.equal(out, qmatmul_ref(x, w, xs, ws)))
    rows = []
    for name in names + names[::-1]:
        for shape in SHAPES:
            rows.append(dict(variant=name, shape=list(shape), device_ms=device_ms(libs[name],
                                                                                  shape)))
            print(f"{name:12s} {shape} device ms {rows[-1]['device_ms']:.4f}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"kernel bitwise vs plain: {bitwise}  ({smi})")
    out_path = ROOT / "chiprun_out" / "qmatmul_variants.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(dict(device=smi, bitwise=bitwise, rows=rows), indent=1))
    return 0 if all(bitwise.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
