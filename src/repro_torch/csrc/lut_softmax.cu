// The paper's 3-stage LUT softmax for Hopper (sm_90a), one lane group per row.
//
//   S_i = exp(z_i) * (sum_j exp(z_j))^-1
//
// Replaces: src/repro/kernels/lut_softmax/lut_softmax.py:lut_softmax_pallas
// (kernel body _lut_softmax_kernel).
//
// Stages per row of K scores: (1) e_i from the 1024-entry linear exp table
// over [-8, 8], with no max subtraction (scores saturate at the table's
// edges, as ap_fixed AP_SAT does); (2) the row sum and its reciprocal from the
// 4096-entry log-spaced 1/x table; (3) e_i * (1/sum).
//
// What bounds it on an H100: a handful of float32 operations per score
// against 8 bytes (read the score, write the output), so it is bound by bytes
// at every shape.
//
// Design: the Pallas kernel reads a table with a one-hot matrix product on
// the MXU; here a table read is an indexed load through the read-only cache
// (__ldg), since the indices diverge across lanes and both tables (20 KB)
// stay cached.  Indices come from lut.cuh with the float32 constants of
// core.lut.index_constants, so they pick the same entries as the plain
// version.  A row is owned by a group of G lanes, G the smallest power of two
// >= K up to a warp (the physics encoders' rows are 15, 50 and 100 wide), so
// neighbouring lanes read neighbouring scores; the row sum is a butterfly
// over the group (group_sum), which leaves every lane of the group the same
// sum.  Up to four scores per lane keep their e in registers between stages
// 1 and 3; longer rows look the table up again in stage 3, which reads the
// row a second time from L1.  The kernel allocates nothing and launches on
// the caller's stream; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include "lut.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 8;
constexpr int kExpSize = 1024;
constexpr int kInvSize = 4096;
constexpr int kHeld = 4;  // scores per lane whose e stays in registers

template <int G>
__global__ void __launch_bounds__(kWarps * 32)
lut_softmax_kernel(const float* __restrict__ x, float* __restrict__ out,
                   const float* __restrict__ exp_tab, const float* __restrict__ inv_tab,
                   long long rows, int k, float exp_off, float exp_step, float inv_off,
                   float inv_step) {
    constexpr int kRowsPerWarp = 32 / G;
    const int lane = threadIdx.x % 32;
    const long long row =
        (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) * kRowsPerWarp +
        lane / G;
    const int sub = lane % G;
    const bool live = row < rows;  // dead lanes still join the group sum
    const float* xr = x + (live ? row : 0) * k;

    float e[kHeld];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {  // stage 1
        const int i = sub + j * G;
        e[j] = (live && i < k)
            ? __ldg(&exp_tab[lut_index_linear(xr[i], exp_off, exp_step, kExpSize)])
            : 0.0f;
        s += e[j];
    }
    if (live) {
        for (int i = sub + kHeld * G; i < k; i += G)
            s += __ldg(&exp_tab[lut_index_linear(xr[i], exp_off, exp_step, kExpSize)]);
    }
    s = group_sum<G>(s);  // stage 2
    if (!live) return;
    const float inv = __ldg(&inv_tab[lut_index_log(s, inv_off, inv_step, kInvSize)]);

    float* orow = out + row * k;  // stage 3
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
        const int i = sub + j * G;
        if (i < k) orow[i] = e[j] * inv;
    }
    for (int i = sub + kHeld * G; i < k; i += G)
        orow[i] = __ldg(&exp_tab[lut_index_linear(xr[i], exp_off, exp_step, kExpSize)]) * inv;
}

template <int G>
cudaError_t launch(const float* x, float* out, const float* exp_tab, const float* inv_tab,
                   long long rows, int k, float exp_off, float exp_step, float inv_off,
                   float inv_step, cudaStream_t stream) {
    constexpr long long kRowsPerBlock = kWarps * (32 / G);
    const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    lut_softmax_kernel<G><<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
        x, out, exp_tab, inv_tab, rows, k, exp_off, exp_step, inv_off, inv_step);
    return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x, out (rows, k) float32 contiguous; exp_tab (1024,), inv_tab (4096,).
extern "C" int repro_lut_softmax(const float* x, float* out, const float* exp_tab,
                                 const float* inv_tab, long long rows, int k, float exp_off,
                                 float exp_step, float inv_off, float inv_step, void* stream) {
    using namespace repro_torch;
    if (rows <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (k <= 4)
        err = launch<4>(x, out, exp_tab, inv_tab, rows, k, exp_off, exp_step, inv_off, inv_step, s);
    else if (k <= 8)
        err = launch<8>(x, out, exp_tab, inv_tab, rows, k, exp_off, exp_step, inv_off, inv_step, s);
    else if (k <= 16)
        err = launch<16>(x, out, exp_tab, inv_tab, rows, k, exp_off, exp_step, inv_off, inv_step, s);
    else
        err = launch<32>(x, out, exp_tab, inv_tab, rows, k, exp_off, exp_step, inv_off, inv_step, s);
    return static_cast<int>(err);
}
