#!/usr/bin/env python3
"""Time the head_dim 8-32 attention kernel against variants of itself on one
CUDA device, to see where its time goes and to compare design choices.

    python3 tools/attention_small_variants.py

Each variant is ``csrc/flash_attention.cu`` with a few lines replaced (the
replacements are listed below and must match the source), built by nvcc
beside the repository's own build, and swapped in for the kernel behind
``kernels.flash_attention.mha``:

- ``kernel``: the source as it is;
- ``presplit_kv``: float32 K and V split into their TF32 halves once per
  block in shared memory after each copy lands (an extra pass and barrier
  per step, two loads per operand), instead of by each warp as it loads
  its fragments;
- ``veltkamp_kv``: K and V split as P is (Veltkamp, four FP32
  operations) instead of by truncation (two);
- ``no_compute``: the copies, barriers, group bookkeeping and stores, but no
  scores, softmax or P V (outputs are wrong; a breakdown only);
- ``no_copies``: everything but the K/V and query copies (outputs wrong);
- ``skeleton``: neither copies nor compute.

At the physics shapes (batch 8192) it prints the profiler's device ms per
call of each, with the bytes bound, and writes them to
``chiprun_out/attention_small_variants.json``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CASES = [((8192, 4, 100, 8), "float32", "safe"), ((8192, 4, 100, 8), "float32", "lut"),
         ((8192, 2, 50, 8), "float32", "safe"), ((8192, 2, 50, 8), "float32", "lut"),
         ((8192, 8, 15, 8), "float32", "safe"), ((8192, 8, 15, 8), "float32", "lut"),
         ((8192, 4, 100, 8), "bfloat16", "safe"), ((8192, 8, 15, 8), "bfloat16", "safe")]

NO_COMPUTE = ("        if (t0 < hi_w && t0 + kRows > lo_w) {",
              "        if (t0 < hi_w && t0 + kRows > lo_w && lut_mode == 7) {")
NO_COPIES = ("            issue(gp, tile_p, gq_p % kSmStages, st);",
             "            if (lut_mode == 7) issue(gp, tile_p, gq_p % kSmStages, st);")
PRESPLIT = [
    ("        return (lut_mode ? kExpSize * 4 : 0) + kSmStages * (w * kSmRows + slots_for(w) * 2 * rows) *",
     "        return (lut_mode ? kExpSize * 4 : 0) + kSmStages * (w * kSmRows + slots_for(w) * "
     "(sizeof(T) == 4 ? 4 : 2) * rows) *"),
    ("    const int stage_elems = slots * 2 * kRows * S;",
     "    const int half_elems = slots * 2 * kRows * S;\n"
     "    const int stage_elems = C::kBf16 ? half_elems : 2 * half_elems;"),
    ("""        cp_async_wait<1>();
        __syncthreads();""", """        cp_async_wait<1>();
        __syncthreads();
        if constexpr (!C::kBf16) {  // big halves in place, small halves half_elems on
            float* st0 = reinterpret_cast<float*>(ring + (step % kSmStages) * stage_elems);
            for (int i = tid; i < gc.n_slots * 2 * kRows * D; i += kThreads) {
                const int e = (i / D) * S + i % D;
                uint32_t bg, sm;
                split_trunc(st0[e], bg, sm);
                st0[e] = __uint_as_float(bg);
                st0[e + half_elems] = __uint_as_float(sm);
            }
            __syncthreads();
        }"""),
    ("""__device__ __forceinline__ void block_scores(float* c, const QFrag<float, D>& f, const float* sk,
                                             int g, int tig) {""",
     """__device__ __forceinline__ void block_scores(float* c, const QFrag<float, D>& f, const float* sk,
                                             int g, int tig, int half = 0) {"""),
    ("""__device__ __forceinline__ void block_scores(float* c, const QFrag<__nv_bfloat16, D>& f,
                                             const __nv_bfloat16* sk, int g, int tig) {""",
     """__device__ __forceinline__ void block_scores(float* c, const QFrag<__nv_bfloat16, D>& f,
                                             const __nv_bfloat16* sk, int g, int tig, int = 0) {"""),
    ("""__device__ __forceinline__ void block_pv(float* o, const float* p, const float* sv, int g,
                                         int tig) {""",
     """__device__ __forceinline__ void block_pv(float* o, const float* p, const float* sv, int g,
                                         int tig, int half = 0) {"""),
    ("""        split_trunc(kr[8 * ks], bb0, bs0);
        split_trunc(kr[8 * ks + 4], bb1, bs1);""",
     """        bb0 = __float_as_uint(kr[8 * ks]), bs0 = __float_as_uint(kr[8 * ks + half]);
        bb1 = __float_as_uint(kr[8 * ks + 4]), bs1 = __float_as_uint(kr[8 * ks + 4 + half]);"""),
    ("""        split_trunc(vr[8 * nb], bb0, bs0);
        split_trunc(vr[S + 8 * nb], bb1, bs1);""",
     """        bb0 = __float_as_uint(vr[8 * nb]), bs0 = __float_as_uint(vr[8 * nb + half]);
        bb1 = __float_as_uint(vr[S + 8 * nb]), bs1 = __float_as_uint(vr[S + 8 * nb + half]);"""),
    ("block_scores<D>(&s[4 * nb], qf, sk + 8 * nb * S, g, tig);",
     "block_scores<D>(&s[4 * nb], qf, sk + 8 * nb * S, g, tig, half_elems);"),
    ("block_pv<D>(o[nb % kAcc], &s[4 * nb], sv + 8 * nb * S, g, tig);",
     "block_pv<D>(o[nb % kAcc], &s[4 * nb], sv + 8 * nb * S, g, tig, half_elems);"),
]
VELTKAMP_KV = [
    ("""        split_trunc(kr[8 * ks], bb0, bs0);
        split_trunc(kr[8 * ks + 4], bb1, bs1);""", """        split_fast(kr[8 * ks], bb0, bs0);
        split_fast(kr[8 * ks + 4], bb1, bs1);"""),
    ("""        split_trunc(vr[8 * nb], bb0, bs0);
        split_trunc(vr[S + 8 * nb], bb1, bs1);""", """        split_fast(vr[8 * nb], bb0, bs0);
        split_fast(vr[S + 8 * nb], bb1, bs1);"""),
]
VARIANTS = {"kernel": [], "presplit_kv": PRESPLIT, "veltkamp_kv": VELTKAMP_KV,
            "no_compute": [NO_COMPUTE], "no_copies": [NO_COPIES],
            "skeleton": [NO_COMPUTE, NO_COPIES]}


def patched(src: str, patches) -> str:
    for old, new in patches:
        if old not in src:
            raise SystemExit(f"variant patch no longer matches the source: {old[:70]!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops

    dev = resolve_device("cuda")
    src = (build.CSRC / "flash_attention.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in VARIANTS.items():  # one nvcc per variant, all at once
        cu = build.BUILD_DIR / f"variant_{name}.cu"
        cu.write_text(patched(src, patches))
        lib = build.BUILD_DIR / f"variant_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out[-3000:]}")
        fn = ctypes.CDLL(str(lib)).repro_flash_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_float] * 5
                       + [ctypes.c_void_p])
        libs[name] = fn
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rows = []
    for name, fn in libs.items():
        ops._lib = lambda fn=fn: fn
        for shape, dtype, mode in CASES:
            c = chip_smoke._attention_case(dev, shape, mode, dtype=dtype)
            rows.append(dict(variant=name, shape=list(shape), dtype=dtype, mode=mode,
                             ok=c["ok"], device_ms=c["device_ms"], ms=c["ms"],
                             bound_ms=c["bound_ms"]))
            dms = "not measured" if c["device_ms"] is None else f"{c['device_ms']:.4f}"
            print(f"[variant] {name:12s} {str(shape):18s} {dtype:8s} {mode:4s} device ms {dms} "
                  f"ms {c['ms']:.4f} bound {c['bound_ms']:.4f} "
                  f"{'matches plain' if c['ok'] else 'differs (expected for the ablations)'}",
                  flush=True)
    out = ROOT / "chiprun_out" / "attention_small_variants.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                               "rows": rows}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
