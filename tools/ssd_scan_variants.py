#!/usr/bin/env python3
"""Time the SSD scan kernel against variants of itself on one CUDA device,
to see where each pass's time goes and to compare design choices.

    python3 tools/ssd_scan_variants.py [VARIANT ...]

Each variant is ``csrc/ssd_scan.cu`` with a few lines replaced (listed in
VARIANTS below; each must match the source), built by nvcc beside the
repository's own build and swapped in behind
``kernels.ssd_scan.ssd_with_state``.  The ablations compute wrong outputs:
they are breakdowns only.  At mamba2-130m's prefill shapes (b x 2048 steps,
24 heads, P 64, N 128, one group, chunk 64; b = 1 and 8, float32) it prints
the profiler's device ms per call of each variant, by pass, and whether it
matches the plain version, and writes them to ``ssd_scan_variants.json``
beside ``chip_smoke.py``'s output.
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

CASES = [(8, "float32"), (1, "float32")]
NEVER = " && d.q < 0"  # a condition that is always false at run time

TICK = "        tn = clock64(); tl[{k}] += tn - tc; tc = tn;\n"
TIMELINE = [
    ("    const int units = it.nh * slices;\n",
     "    const int units = it.nh * slices;\n    long long tl[8] = {}, tc = clock64(), tn;\n"),
    ("    const int n_wt = qt32 * (W / 16);",
     TICK.format(k=0) + "    const int n_wt = qt32 * (W / 16);"),
    ("        team_sync(team);  // unit u is in\n",
     "        team_sync(team);  // unit u is in\n" + TICK.format(k=1)),
    ("        team_sync(team);  // G is in\n", "        team_sync(team);  // G is in\n" + TICK.format(k=2)),
    ("            // + diag(exp(cs)) C S_in^T over the N state columns",
     TICK.format(k=3) + "            // + diag(exp(cs)) C S_in^T over the N state columns"),
    ("#pragma unroll\n            for (int mi = 0; mi < 2; ++mi)\n#pragma unroll\n"
     "                for (int r = 0; r < 2; ++r) {\n                    const int i = i0",
     TICK.format(k=4) + "#pragma unroll\n            for (int mi = 0; mi < 2; ++mi)\n#pragma unroll\n"
     "                for (int r = 0; r < 2; ++r) {\n                    const int i = i0"),
    ("        team_sync(team);  // the team is done with its stage, a and G\n    }\n}\n",
     "        team_sync(team);  // the team is done with its stage, a and G\n" + TICK.format(k=5)
     + "    }\n    if (lane == 0 && blockIdx.x == d.tiles * d.G)\n"
     "        for (int k = 0; k < 6; ++k)\n"
     "            y[((it.row0 + warp) * d.H + it.h0) * d.P + k] = static_cast<T>(static_cast<float>(tl[k]));\n}\n"),
]
PHASES = ("prologue", "stage+wait", "scan+G", "part1", "part2", "stores+sync")

VARIANTS = {
    "kernel": [],
    # pass 3 without copying S_in (part 2 reads stale shared memory)
    "out_no_s_copy": [("const bool bulk = d.bulk && it.c > 0;", "const bool bulk = false;"),
                      ("if (it.c > 0 && !bulk) stage_tile(sv,",
                       f"if (it.c > 0 && !bulk{NEVER}) stage_tile(sv,")],
    # pass 3 copying S_in by cp.async (16 bytes a thread) instead of one bulk copy
    "out_cp_async": [("const bool bulk = d.bulk && it.c > 0;", "const bool bulk = false;")],
    # pass 3 without the xdt copy
    "out_no_x_copy": [("        stage_tile(xs, SX, xdt", f"        if (d.q < 0) stage_tile(xs, SX, xdt")],
    # pass 3 without (C B^T * L) xdt, without C S_in^T, without both
    "out_no_part1": [("for (int j0 = 0; j0 < j_end; j0 += 8) {",
                      f"for (int j0 = 0; j0 < j_end{NEVER}; j0 += 8) {{")],
    "out_no_part2": [("            if (it.c > 0) {\n                float e[2][2];",
                      f"            if (it.c > 0{NEVER}) {{\n                float e[2][2];")],
    # pass 3 without the G pass's exps
    "out_g_no_exp": [("cb[i * kGS + j] * expf(static_cast<float>(csi - csj))", "cb[i * kGS + j]")],
    "out_copies_only": [("for (int j0 = 0; j0 < j_end; j0 += 8) {",
                         f"for (int j0 = 0; j0 < j_end{NEVER}; j0 += 8) {{"),
                        ("            if (it.c > 0) {\n                float e[2][2];",
                         f"            if (it.c > 0{NEVER}) {{\n                float e[2][2];")],
    # pass 3 with clock64 totals per phase and warp of the block of chunk 1
    # (batch 0, first head tile), written to y[0, q + warp, 0, 0..5]
    # (prologue; copy issue, wait and barrier; scan and G; part 1; part 2;
    # stores and the team's closing barrier)
    "timeline": TIMELINE,
    # pass 1 without its product
    "state_no_mma": [("for (int j0 = 0; j0 < q8; j0 += 8) {",
                      f"for (int j0 = 0; j0 < q8{NEVER}; j0 += 8) {{")],
}


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
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ops, ssd_chunked, ssd_with_state

    names = sys.argv[1:] or list(VARIANTS)
    src = (build.CSRC / "ssd_scan.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:  # one nvcc per variant, all at once
        cu = build.BUILD_DIR / f"ssd_variant_{name}.cu"
        cu.write_text(patched(src, VARIANTS[name]))
        lib = build.BUILD_DIR / f"ssd_variant_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out[-3000:]}")
        if name == "kernel":
            print("\n".join(ln for ln in out.splitlines() if "registers" in ln or "spill" in ln))
        fn = ctypes.CDLL(str(lib)).repro_ssd_scan
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        libs[name] = fn
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    inputs, refs = {}, {}
    for b, dtype in CASES:
        g = torch.Generator().manual_seed(b)
        x = [torch.randn(b, 2048, 24, 64, generator=g) * 0.5,
             -torch.randn(b, 2048, 24, generator=g).abs() * 0.3,
             torch.randn(b, 2048, 1, 128, generator=g) * 0.5,
             torch.randn(b, 2048, 1, 128, generator=g) * 0.5]
        inputs[b, dtype] = [t.to(dev, getattr(torch, dtype)) for t in x]
        f = [t.float() for t in inputs[b, dtype]]
        refs[b, dtype] = ssd_chunked(f[0], f[1], f[2].expand(-1, -1, 24, -1),
                                     f[3].expand(-1, -1, 24, -1), chunk=64)
    rows = []
    for name, fn in libs.items():
        ops._lib = lambda fn=fn: fn
        for b, dtype in CASES:
            x = inputs[b, dtype]
            y, s = ssd_with_state(*x, chunk=64)
            ok = bool((y.float() - refs[b, dtype][0]).abs().max() <= chip_smoke.SSD_ATOL
                      and (s - refs[b, dtype][1]).abs().max() <= chip_smoke.SSD_ATOL)
            times = chip_smoke.device_times(lambda x=x: ssd_with_state(*x, chunk=64)) or {}
            passes = {p: sum(t for k, t in times.items() if p in k)
                      for p in chip_smoke.SSD_PASSES}
            rows.append(dict(variant=name, batch=b, dtype=dtype, ok=ok,
                             device_ms=sum(times.values()), pass_device_ms=passes))
            if name == "timeline":
                cycles = {ph: y[0, 64:80, 0, k].tolist() for k, ph in enumerate(PHASES)}
                rows[-1]["chunk1_block_cycles_by_warp"] = cycles
                for ph, per_warp in cycles.items():
                    print(f"[timeline] b{b} chunk 1's first block, {ph:12s} cycles by warp: "
                          + " ".join(f"{c:8.0f}" for c in per_warp))
            print(f"[variant] {name:16s} b{b} {dtype:8s} device ms {sum(times.values()):.4f} "
                  + " ".join(f"{p.removeprefix('ssd_').removesuffix('_kernel')} {t:.4f}"
                             for p, t in passes.items())
                  + f"  {'matches plain' if ok else 'differs'}", flush=True)
    out = chip_smoke.OUT.parent / "ssd_scan_variants.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                               "rows": rows}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
