#!/usr/bin/env python3
"""Measure the H100's mma.sync rate for the shapes the port's kernels use, on
one CUDA device.

    python3 tools/mma_sync_rate.py

A kernel of 8 warps per block, 1 or 4 blocks per SM, has every warp issue a
long run of mma.sync.m16n8k8 (TF32 in, float32 out) or m16n8k16 (bf16 in)
into CHAINS independent accumulators, from registers only (no memory
traffic).  It prints the TFLOP/s and the cycles per mma per SM
sub-partition (at the card's maximum SM clock) for 1, 2, 4 and 8 chains
per warp: with few warps the chains' latency bounds the rate, with many the
tensor cores do.  3xTF32 work (the float32 attention and SSD routes) runs
at a third of the TF32 rate.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int CHAINS, bool TF32>
__global__ void __launch_bounds__(256) mma_loop(float* out, int iters) {
    float c[CHAINS][4] = {};
    const uint32_t a0 = threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u, a3 = a0 * 7u;
    const uint32_t b0 = a0 ^ 0x3f800000u, b1 = a1 ^ 0x3f800000u;
    for (int k = 0; k < iters; ++k) {
#pragma unroll
        for (int ch = 0; ch < CHAINS; ++ch) {
            if (TF32)
                asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                             "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                             : "+f"(c[ch][0]), "+f"(c[ch][1]), "+f"(c[ch][2]), "+f"(c[ch][3])
                             : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
            else
                asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                             "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                             : "+f"(c[ch][0]), "+f"(c[ch][1]), "+f"(c[ch][2]), "+f"(c[ch][3])
                             : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
        }
    }
    float s = 0.0f;
#pragma unroll
    for (int ch = 0; ch < CHAINS; ++ch) s += c[ch][0] + c[ch][1] + c[ch][2] + c[ch][3];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int CHAINS, bool TF32>
float run(float* out, int blocks, int iters) {
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    mma_loop<CHAINS, TF32><<<blocks, 256>>>(out, iters);  // warm-up
    cudaEventRecord(e0);
    mma_loop<CHAINS, TF32><<<blocks, 256>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.0f;
    cudaEventElapsedTime(&ms, e0, e1);
    cudaEventDestroy(e0);
    cudaEventDestroy(e1);
    return cudaGetLastError() == cudaSuccess ? ms : -1.0f;
}
// ms of `blocks` x 256 threads, `iters` x chains mma each; kind 0 TF32, 1 bf16
extern "C" float mma_rate_ms(int kind, int chains, int blocks, int iters) {
    float* out = nullptr;
    if (cudaMalloc(&out, sizeof(float) * blocks * 256) != cudaSuccess) return -1.0f;
    float ms = -1.0f;
    switch (chains * 2 + kind) {
        case 2: ms = run<1, true>(out, blocks, iters); break;
        case 3: ms = run<1, false>(out, blocks, iters); break;
        case 4: ms = run<2, true>(out, blocks, iters); break;
        case 5: ms = run<2, false>(out, blocks, iters); break;
        case 8: ms = run<4, true>(out, blocks, iters); break;
        case 9: ms = run<4, false>(out, blocks, iters); break;
        case 16: ms = run<8, true>(out, blocks, iters); break;
        case 17: ms = run<8, false>(out, blocks, iters); break;
    }
    cudaFree(out);
    return ms;
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, lib = build.BUILD_DIR / "mma_sync_rate.cu", build.BUILD_DIR / "mma_sync_rate.so"
    cu.write_text(SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib)).mma_rate_ms
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    clock_ghz = float(smi.split(",")[-1].split()[0]) / 1e3
    iters = 4096
    for per_sm in (1, 4):
        blocks = per_sm * sms
        for kind, name, k in ((0, "m16n8k8 tf32", 8), (1, "m16n8k16 bf16", 16)):
            for chains in (1, 2, 4, 8):
                ms = fn(kind, chains, blocks, iters)
                n_mma = blocks * 8 * iters * chains  # 8 warps a block
                tflops = n_mma * 2 * 16 * 8 * k / (ms * 1e-3) / 1e12
                cycles = ms * 1e-3 * clock_ghz * 1e9 * sms * 4 / n_mma
                print(f"[mma] {name:14s} {8 * per_sm:2d} warps/SM, {chains} chains/warp: "
                      f"{ms:.3f} ms, {tflops:.1f} TFLOP/s, {cycles:.2f} cycles per mma per SM "
                      "sub-partition")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
