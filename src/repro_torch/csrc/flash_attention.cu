// Fused attention for Hopper (sm_90a): softmax(Q K^T / sqrt(d)) V under a
// padding / causal / sliding-window mask, with the safe (online max/sum)
// softmax or the paper's LUT softmax.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:
//   flash_attention_pallas (kernel body _make_kernel), and the GQA repeat of
//   src/repro/kernels/flash_attention/ops.py:mha.
//
// What bounds it on an H100: the work is 4 L^2 D FLOP per (batch, head)
// against 16 L D bytes of q/k/v/out in fp32, i.e. L/4 FLOP per byte, and the
// fp32 CUDA-core ridge is 67 TFLOP/s / 3.35 TB/s = 20 FLOP per byte.  So the
// physics shapes (head_dim 8; L = 15, 50) are bound by bytes, gw (L = 100)
// sits at the ridge, and the LM-like L = 1024 shapes are bound by operations.
// head_dim 8 is below every tensor-core tile, so this first version runs
// fp32 FMAs on the CUDA cores; wgmma for the LM shapes is later work.
//
// Design: one block per (batch * head, 64-query tile).  A query row is owned
// by TPR threads (1 for D <= 16, D/16 above), each holding D/TPR of the
// row's q and accumulator in registers, dims interleaved so the threads of
// one row read neighbouring shared-memory banks.  K/V tiles of 32 keys are
// staged in shared memory as fp32 (bf16 inputs are widened on load) and
// broadcast to all rows.  Scores of a tile stay in registers; the online
// softmax rescales once per tile.  Masked keys get zero weight directly (no
// -1e30 sentinel), and a block only walks the key range its rows can see
// under the causal / window masks.  GQA maps query head h to key/value head
// h / (Hq / Hkv) by index; K/V are never repeated in memory.
// LUT mode: exp from the 1024-entry linear table, running row sum without
// max subtraction, reciprocal from the 4096-entry log table; tables are read
// through the read-only cache (__ldg), not __constant__, because the indices
// diverge across threads.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "lut.cuh"

namespace repro_torch {
namespace {

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockKV = 32;  // keys per shared-memory tile (one bit each in `valid`)
constexpr int kExpSize = 1024;
constexpr int kInvSize = 4096;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

template <int D>
struct RowSplit {
    static constexpr int kThreads = D >= 32 ? D / 16 : 1;  // threads per query row
    static constexpr int kDims = D / kThreads;             // dims per thread
};

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ * RowSplit<D>::kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       const float* __restrict__ exp_tab,
                       const float* __restrict__ inv_tab, int Hq, int Hkv, int Lq,
                       int Lkv, int kv_len, int causal, int window, int lut_mode,
                       float scale, float exp_off, float exp_step, float inv_off,
                       float inv_step) {
    constexpr int TPR = RowSplit<D>::kThreads;
    constexpr int DP = RowSplit<D>::kDims;
    __shared__ float Ks[kBlockKV][D];
    __shared__ float Vs[kBlockKV][D];

    const int bh = blockIdx.x;
    const int b = bh / Hq;
    const int hk = (bh % Hq) / (Hq / Hkv);
    const int q0 = blockIdx.y * kBlockQ;
    const int part = threadIdx.x % TPR;
    const int qi = q0 + threadIdx.x / TPR;
    const bool row_ok = qi < Lq;

    float qr[DP], acc[DP];
    const T* qp = q + (static_cast<long long>(bh) * Lq + (row_ok ? qi : 0)) * D;
#pragma unroll
    for (int e = 0; e < DP; ++e) {
        qr[e] = row_ok ? to_f32(qp[part + TPR * e]) : 0.0f;
        acc[e] = 0.0f;
    }
    float m = -INFINITY, l = 0.0f;

    const long long kv_base = (static_cast<long long>(b) * Hkv + hk) * Lkv * D;
    const T* kp = k + kv_base;
    const T* vp = v + kv_base;

    // Keys any row of this block can attend to.
    const int q_last = min(q0 + kBlockQ, Lq) - 1;
    int kv_hi = min(kv_len, Lkv);
    if (causal) kv_hi = min(kv_hi, q_last + 1);
    const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;

    for (int t0 = kv_lo; t0 < kv_hi; t0 += kBlockKV) {
        __syncthreads();  // previous tile fully consumed
        for (int i = threadIdx.x; i < kBlockKV * D; i += blockDim.x) {
            const int j = i / D, d = i % D;
            const int kpos = t0 + j;
            const bool in = kpos < kv_hi;
            Ks[j][d] = in ? to_f32(kp[static_cast<long long>(kpos) * D + d]) : 0.0f;
            Vs[j][d] = in ? to_f32(vp[static_cast<long long>(kpos) * D + d]) : 0.0f;
        }
        __syncthreads();

        float s[kBlockKV];
        unsigned valid = 0u;
        float tile_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBlockKV; ++j) {
            float dot = 0.0f;
#pragma unroll
            for (int e = 0; e < DP; ++e) dot = fmaf(qr[e], Ks[j][part + TPR * e], dot);
            dot = group_sum<TPR>(dot);
            s[j] = dot * scale;
            const int kpos = t0 + j;
            const bool ok = row_ok && kpos < kv_hi && (!causal || kpos <= qi) &&
                            (window <= 0 || qi - kpos < window);
            if (ok) {
                valid |= 1u << j;
                tile_max = fmaxf(tile_max, s[j]);
            }
        }
        if (valid == 0u) continue;

        if (!lut_mode) {
            const float m_new = fmaxf(m, tile_max);
            const float alpha = expf(m - m_new);  // 0 on the first visible tile
            l *= alpha;
#pragma unroll
            for (int e = 0; e < DP; ++e) acc[e] *= alpha;
            m = m_new;
#pragma unroll
            for (int j = 0; j < kBlockKV; ++j) {
                if (valid >> j & 1u) {
                    const float p = expf(s[j] - m);
                    l += p;
#pragma unroll
                    for (int e = 0; e < DP; ++e) acc[e] = fmaf(p, Vs[j][part + TPR * e], acc[e]);
                }
            }
        } else {
#pragma unroll
            for (int j = 0; j < kBlockKV; ++j) {
                if (valid >> j & 1u) {
                    const float p =
                        __ldg(&exp_tab[lut_index_linear(s[j], exp_off, exp_step, kExpSize)]);
                    l += p;
#pragma unroll
                    for (int e = 0; e < DP; ++e) acc[e] = fmaf(p, Vs[j][part + TPR * e], acc[e]);
                }
            }
        }
    }

    if (!row_ok) return;
    float inv = 0.0f;
    if (l > 0.0f) {
        inv = lut_mode ? __ldg(&inv_tab[lut_index_log(l, inv_off, inv_step, kInvSize)])
                       : 1.0f / l;
    }
    T* op = out + (static_cast<long long>(bh) * Lq + qi) * D;
#pragma unroll
    for (int e = 0; e < DP; ++e) op[part + TPR * e] = from_f32<T>(acc[e] * inv);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const float* exp_tab, const float* inv_tab, int B, int Hq, int Hkv,
                   int Lq, int Lkv, int kv_len, int causal, int window, int lut_mode,
                   float scale, float exp_off, float exp_step, float inv_off,
                   float inv_step, cudaStream_t stream) {
    const dim3 grid(B * Hq, (Lq + kBlockQ - 1) / kBlockQ);
    const dim3 block(kBlockQ * RowSplit<D>::kThreads);
    flash_attention_kernel<T, D><<<grid, block, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), exp_tab, inv_tab, Hq, Hkv, Lq, Lkv, kv_len, causal,
        window, lut_mode, scale, exp_off, exp_step, inv_off, inv_step);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
                       const float* exp_tab, const float* inv_tab, int B, int Hq,
                       int Hkv, int Lq, int Lkv, int kv_len, int causal, int window,
                       int lut_mode, float scale, float exp_off, float exp_step,
                       float inv_off, float inv_step, cudaStream_t stream) {
#define REPRO_FA_CASE(DIM)                                                              \
    case DIM:                                                                           \
        return launch<T, DIM>(q, k, v, out, exp_tab, inv_tab, B, Hq, Hkv, Lq, Lkv,      \
                              kv_len, causal, window, lut_mode, scale, exp_off,         \
                              exp_step, inv_off, inv_step, stream);
    switch (D) {
        REPRO_FA_CASE(8)
        REPRO_FA_CASE(16)
        REPRO_FA_CASE(32)
        REPRO_FA_CASE(64)
        REPRO_FA_CASE(128)
        default:
            return cudaErrorInvalidValue;
    }
#undef REPRO_FA_CASE
}

}  // namespace
}  // namespace repro_torch

// q (B, Hq, Lq, D), k/v (B, Hkv, Lkv, D), out (B, Hq, Lq, D), all contiguous,
// dtype 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, const float* exp_tab,
                                     const float* inv_tab, int B, int Hq, int Hkv,
                                     int Lq, int Lkv, int D, int kv_len, int causal,
                                     int window, int lut_mode, int dtype, float scale,
                                     float exp_off, float exp_step, float inv_off,
                                     float inv_step, void* stream) {
    using namespace repro_torch;
    if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Lq <= 0 || Lkv <= 0 ||
        kv_len <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == 0) {
        err = dispatch_d<float>(D, q, k, v, out, exp_tab, inv_tab, B, Hq, Hkv, Lq, Lkv,
                                kv_len, causal, window, lut_mode, scale, exp_off,
                                exp_step, inv_off, inv_step, s);
    } else if (dtype == 1) {
        err = dispatch_d<__nv_bfloat16>(D, q, k, v, out, exp_tab, inv_tab, B, Hq, Hkv,
                                        Lq, Lkv, kv_len, causal, window, lut_mode, scale,
                                        exp_off, exp_step, inv_off, inv_step, s);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
