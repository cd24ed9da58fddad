// The paper's staged LayerNorm / RMSNorm for Hopper (sm_90a), one warp per row.
//
// Replaces: src/repro/kernels/layernorm/layernorm.py:layernorm_pallas (kernel
// body _make_kernel), whose jnp twin is src/repro/core/layernorm.py
// (layernorm_paper, rmsnorm).
//
// Stages per row of K features: (1) mean = sum(x) / K (skipped for RMSNorm),
// (2) dm = x - mean, (3) var = sum(dm^2) / K, (4) inv = rsqrt(var + eps) or
// the 4096-entry log-spaced 1/sqrt LUT (no eps), (5) out = dm * inv * gamma
// (+ beta).
//
// What bounds it on an H100: about 8 FLOP per element against 8 bytes (read
// x, write out), so it is bound by bytes at every shape; at the physics
// shapes (K = 32, 64) a row is one or two 128-byte lines.
//
// Design: a warp owns a row, lanes stride over K (coalesced), the two sums
// are butterfly shuffles so every lane holds the same mean and variance, and
// the LUT is read through the read-only cache (__ldg).  The row is read
// three times; the re-reads hit L1 for the physics widths and L2 for
// K = 4096, so device memory sees x about once.  No shared memory, no
// allocation, the caller's stream; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include "lut.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kTableSize = 4096;

__global__ void __launch_bounds__(kWarps * 32)
layernorm_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const float* __restrict__ tab,
                 float* __restrict__ out, int rows, int k, int rms, int use_lut,
                 float eps, float tab_off, float tab_step) {
    const int row = blockIdx.x * kWarps + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= rows) return;  // uniform across the warp
    const float* xr = x + static_cast<long long>(row) * k;
    float* orow = out + static_cast<long long>(row) * k;
    const float kf = static_cast<float>(k);

    float mean = 0.0f;
    if (!rms) {  // stage 1
        float s = 0.0f;
        for (int i = lane; i < k; i += 32) s += xr[i];
        mean = group_sum<32>(s) / kf;
    }
    float ss = 0.0f;  // stages 2-3
    for (int i = lane; i < k; i += 32) {
        const float dm = xr[i] - mean;
        ss += dm * dm;
    }
    const float var = group_sum<32>(ss) / kf;
    const float inv = use_lut  // stage 4
        ? __ldg(&tab[lut_index_log(var, tab_off, tab_step, kTableSize)])
        : rsqrtf(var + eps);
    for (int i = lane; i < k; i += 32) {  // stage 5
        float o = (xr[i] - mean) * inv * gamma[i];
        if (!rms) o += beta[i];
        orow[i] = o;
    }
}

}  // namespace
}  // namespace repro_torch

// x, out (rows, k) float32 contiguous; gamma, beta (k,); tab (4096,).
extern "C" int repro_layernorm(const float* x, const float* gamma, const float* beta,
                               const float* tab, float* out, int rows, int k, int rms,
                               int use_lut, float eps, float tab_off, float tab_step,
                               void* stream) {
    using namespace repro_torch;
    if (rows <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((rows + kWarps - 1) / kWarps);
    layernorm_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        x, gamma, beta, tab, out, rows, k, rms, use_lut, eps, tab_off, tab_step);
    return static_cast<int>(cudaGetLastError());
}
