// The paper's staged LayerNorm / RMSNorm for Hopper (sm_90a): rows held in
// registers, 16-byte loads, float32, bfloat16 or float16 in and out.
//
// Replaces: src/repro/kernels/layernorm/layernorm.py:layernorm_pallas (kernel
// body _make_kernel), whose jnp twin is src/repro/core/layernorm.py
// (layernorm_paper, rmsnorm).
//
// Stages per row of K features, all in float32: (1) mean = sum(x) / K
// (skipped for RMSNorm), (2) dm = x - mean, (3) var = sum(dm^2) / K, (4) inv =
// rsqrt(var + eps) or the 4096-entry log-spaced 1/sqrt LUT (no eps), (5) out =
// dm * inv * gamma (+ beta), rounded once to the output type.
//
// What bounds it on an H100: about 8 operations per element against
// 2 * sizeof(T) bytes (x read once, out written once), so it is bound by
// bytes at every shape.  The design moves each byte once and keeps enough of
// them in flight:
// - a "team" of lanes owns a row and holds it in registers as NV vectors of
//   VEC elements per lane (VEC * sizeof(T) = 16 bytes, one 128-bit load);
//   the mean and the variance are two passes over those registers (the
//   reference's two-pass arithmetic, not Welford), so x is read from device
//   memory once and out written once;
// - the team is LANES adjacent lanes of a warp for rows of up to 32 vectors
//   (the physics widths: K = 32 float32 is 8 lanes, 4 rows per warp), a whole
//   warp for rows of up to 6 vectors per lane (mamba2's 768), or a whole
//   block (LANES == 0) beyond, whose warps add their partial sums through
//   shared memory; a call of a few rows (decode) spreads each row over a
//   block at 8 elements per thread, so its latency is one load's.  The
//   wrapper's plan (kernels/layernorm/ops.py:_plan) picks the route; its
//   thresholds were timed on an H100 with tools/layernorm_routes.py;
// - the grid is sized to the SMs at the kernel's occupancy and strides over
//   rows, so each lane loads its slice of gamma and beta once (when the slice
//   is small enough to stay in registers) and, where the row fits in few
//   registers, loads the next row before it reduces the current one.
// A row whose K is not a multiple of VEC, or any pointer that is not 16-byte
// aligned, takes the VEC = 1 instances of the same kernel.
// No allocation, the caller's stream; the C entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "lut.cuh"

namespace repro_torch {
namespace {

constexpr int kTableSize = 4096;
constexpr int kRowThreads = 256;    // block size of the lane- and warp-team instances
constexpr int kMaxThreads = 512;    // block size cap of the block-team instances (128 registers)
constexpr int kHoldElems = 16;      // gamma / beta stay in registers up to this many per lane
constexpr int kPrefetchBytes = 64;  // the next row is loaded early up to this many per lane

struct Args {
    const void* x;
    const void* gamma;
    const void* beta;  // null for RMSNorm
    const float* tab;
    void* out;
    long long rows;
    int k;
    int rms;
    int use_lut;
    int params_f32;  // gamma / beta are float32 (else the type of x)
    float eps;
    float tab_off;
    float tab_step;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// n elements of T from p to dst: 16-byte accesses when n * sizeof(T) is a
// multiple of 16 (the caller guarantees the alignment), else one by one.
template <typename T, int n>
__device__ __forceinline__ void load_n(const T* __restrict__ p, T* dst) {
    if constexpr ((n * sizeof(T)) % 16 == 0) {
#pragma unroll
        for (int c = 0; c < int(n * sizeof(T) / 16); ++c) {
            reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(p)[c];
        }
    } else {
#pragma unroll
        for (int j = 0; j < n; ++j) dst[j] = p[j];
    }
}

template <typename T, int n>
__device__ __forceinline__ void store_n(T* __restrict__ p, const T* src) {
    if constexpr ((n * sizeof(T)) % 16 == 0) {
#pragma unroll
        for (int c = 0; c < int(n * sizeof(T) / 16); ++c) {
            reinterpret_cast<uint4*>(p)[c] = reinterpret_cast<const uint4*>(src)[c];
        }
    } else {
#pragma unroll
        for (int j = 0; j < n; ++j) p[j] = src[j];
    }
}

// VEC parameters (gamma or beta) at element offset `at`, as float32.
template <typename T, int VEC>
__device__ __forceinline__ void load_params(const void* base, int at, bool f32, float* dst) {
    if (f32) {
        alignas(16) float v[VEC];
        load_n<float, VEC>(static_cast<const float*>(base) + at, v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) dst[j] = v[j];
    } else {
        alignas(16) T v[VEC];
        load_n<T, VEC>(static_cast<const T*>(base) + at, v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) dst[j] = to_f(v[j]);
    }
}

// Sum over the team.  Lane teams: a butterfly over LANES adjacent lanes.
// Block teams: a butterfly per warp, then every thread adds the warps'
// partial sums from shared memory in the same order, so every thread of the
// team holds the bitwise-same sum.  The mean and the variance use separate
// halves of `red`, so one sync per sum suffices within a row.
template <int LANES>
__device__ __forceinline__ float team_sum(float v, float* red) {
    if constexpr (LANES > 0) {
        return group_sum<LANES>(v);
    } else {
        v = group_sum<32>(v);
        if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
        __syncthreads();
        float s = 0.0f;
        for (int w = 0; w < int(blockDim.x / 32); ++w) s += red[w];
        return s;
    }
}

template <typename T, int VEC, int NV, int LANES>
__global__ void __launch_bounds__(LANES > 0 ? kRowThreads : kMaxThreads)
layernorm_kernel(const Args a) {
    constexpr int E = NV * VEC;  // elements of a row per lane
    constexpr bool kHold = E <= kHoldElems;
    constexpr bool kPrefetch = E * int(sizeof(T)) <= kPrefetchBytes;
    __shared__ float red[2][kMaxThreads / 32];  // block teams: per-warp partial sums

    const int lanes = LANES > 0 ? LANES : int(blockDim.x);
    const int lane = LANES > 0 ? int(threadIdx.x) % LANES : int(threadIdx.x);
    // Lane teams step a whole warp's rows together, so every lane of a warp
    // runs the same iterations (the shuffles need all 32 lanes); a lane past
    // the last row computes on zeros and stores nothing.
    long long start, stride;
    int sub = 0;
    if constexpr (LANES > 0) {
        constexpr int kRowsPerWarp = 32 / LANES;
        const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
        start = warp * kRowsPerWarp;
        stride = static_cast<long long>(gridDim.x) * (blockDim.x / 32) * kRowsPerWarp;
        sub = int(threadIdx.x % 32) / LANES;
    } else {
        start = blockIdx.x;
        stride = gridDim.x;
    }
    const int k = a.k;
    const float kf = static_cast<float>(k);
    const bool f32p = a.params_f32 != 0;

    bool inb[NV];  // does this lane's vector v lie inside the row?
#pragma unroll
    for (int v = 0; v < NV; ++v) inb[v] = (v * lanes + lane) * VEC < k;

    float gam[kHold ? E : 1], bet[kHold ? E : 1];
    if constexpr (kHold) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
            const int at = (v * lanes + lane) * VEC;
#pragma unroll
            for (int j = 0; j < VEC; ++j) gam[v * VEC + j] = bet[v * VEC + j] = 0.0f;
            if (inb[v]) {
                load_params<T, VEC>(a.gamma, at, f32p, &gam[v * VEC]);
                if (!a.rms) load_params<T, VEC>(a.beta, at, f32p, &bet[v * VEC]);
            }
        }
    }

    const T* __restrict__ x = static_cast<const T*>(a.x);
    T* __restrict__ out = static_cast<T*>(a.out);
    auto load_row = [&](long long row, T* dst) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
            if (row < a.rows && inb[v]) {
                load_n<T, VEC>(x + row * k + (v * lanes + lane) * VEC, &dst[v * VEC]);
            } else {
#pragma unroll
                for (int j = 0; j < VEC; ++j) dst[v * VEC + j] = from_f<T>(0.0f);
            }
        }
    };

    alignas(16) T cur[E];
    if constexpr (kPrefetch) load_row(start + sub, cur);
    for (long long base = start; base < a.rows; base += stride) {
        const long long row = base + sub;
        alignas(16) T nxt[kPrefetch ? E : 1];
        if constexpr (kPrefetch) {
            load_row(row + stride, nxt);  // in flight while this row is reduced
        } else {
            load_row(row, cur);
        }

        float mean = 0.0f;
        if (!a.rms) {  // stage 1
            float s = 0.0f;
#pragma unroll
            for (int e = 0; e < E; ++e) s += to_f(cur[e]);
            mean = team_sum<LANES>(s, red[0]) / kf;
        }
        float ss = 0.0f;  // stages 2-3: padding lanes hold dm = 0
#pragma unroll
        for (int v = 0; v < NV; ++v) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
                const float dm = inb[v] ? to_f(cur[v * VEC + j]) - mean : 0.0f;
                ss += dm * dm;
            }
        }
        const float var = team_sum<LANES>(ss, red[1]) / kf;
        const float inv = a.use_lut  // stage 4
            ? __ldg(&a.tab[lut_index_log(var, a.tab_off, a.tab_step, kTableSize)])
            : rsqrtf(var + a.eps);

        if (row < a.rows) {  // stage 5
#pragma unroll
            for (int v = 0; v < NV; ++v) {
                if (!inb[v]) continue;
                const int at = (v * lanes + lane) * VEC;
                float g[VEC], b[VEC];
                if constexpr (kHold) {
#pragma unroll
                    for (int j = 0; j < VEC; ++j) {
                        g[j] = gam[v * VEC + j];
                        b[j] = bet[v * VEC + j];
                    }
                } else {
                    load_params<T, VEC>(a.gamma, at, f32p, g);
                    if (!a.rms) load_params<T, VEC>(a.beta, at, f32p, b);
                }
                alignas(16) T o[VEC];
#pragma unroll
                for (int j = 0; j < VEC; ++j) {
                    float r = (to_f(cur[v * VEC + j]) - mean) * inv * g[j];
                    if (!a.rms) r += b[j];
                    o[j] = from_f<T>(r);
                }
                store_n<T, VEC>(out + row * k + at, o);
            }
        }
        if constexpr (kPrefetch) {
#pragma unroll
            for (int e = 0; e < E; ++e) cur[e] = nxt[e];
        }
        // Block teams: every thread has read this row's sums before the next
        // row writes them (RMSNorm reuses red[1] with no sync in between).
        if constexpr (LANES == 0) __syncthreads();
    }
}

constexpr int kMaxDevices = 64;

// Per device: SM count (looked up at the first launch) and the 1/sqrt table
// with its index constants (set once by repro_layernorm_set_table).
struct DeviceState {
    int sms = 0;
    const float* tab = nullptr;
    float tab_off = 0.0f;
    float tab_step = 1.0f;
};
DeviceState g_devices[kMaxDevices];

// Launch one instance: a grid of at most (SMs x resident blocks) that
// strides over the rows.
template <typename T, int VEC, int NV, int LANES>
int launch(const Args& a, int threads, int sms, cudaStream_t stream) {
    auto kernel = layernorm_kernel<T, VEC, NV, LANES>;
    static int resident = 0;  // blocks per SM at this block size (one size per instance in use)
    static int resident_threads = 0;
    if (resident_threads != threads) {
        if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads, 0)
                != cudaSuccess || resident < 1) {
            resident = 1;
        }
        resident_threads = threads;
    }
    const long long rows_per_block = LANES > 0 ? (threads / 32) * (32 / LANES) : 1;
    const long long need = (a.rows + rows_per_block - 1) / rows_per_block;
    const long long cap = static_cast<long long>(sms) * resident;
    const int grid = static_cast<int>(need < cap ? need : cap);
    kernel<<<grid, threads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// The instances, by (VEC, NV, team).  The wrapper's plan
// (kernels/layernorm/ops.py:_plan) picks among exactly these.
template <typename T>
int dispatch(const Args& a, int vec, int nv, int lanes, int sms, cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    const int team = lanes > 32 ? 0 : lanes;
    const int threads = lanes > 32 ? lanes : kRowThreads;
#define REPRO_LN_CASE(VEC_, NV_, LANES_) \
    if (vec == VEC_ && nv == NV_ && team == LANES_) return launch<T, VEC_, NV_, LANES_>(a, threads, sms, s);
    REPRO_LN_CASE(V, 1, 1) REPRO_LN_CASE(V, 1, 2) REPRO_LN_CASE(V, 1, 4)
    REPRO_LN_CASE(V, 1, 8) REPRO_LN_CASE(V, 1, 16) REPRO_LN_CASE(V, 1, 32)
    REPRO_LN_CASE(V, 2, 32) REPRO_LN_CASE(V, 3, 32) REPRO_LN_CASE(V, 4, 32)
    REPRO_LN_CASE(V, 6, 32)
    REPRO_LN_CASE(V, 1, 0) REPRO_LN_CASE(V, 2, 0) REPRO_LN_CASE(V, 4, 0)
    REPRO_LN_CASE(V, 8, 0) REPRO_LN_CASE(V, 16, 0)
    REPRO_LN_CASE(1, 1, 32) REPRO_LN_CASE(1, 2, 32) REPRO_LN_CASE(1, 4, 32)
    REPRO_LN_CASE(1, 8, 32) REPRO_LN_CASE(1, 16, 32)
    REPRO_LN_CASE(1, 8, 0) REPRO_LN_CASE(1, 16, 0) REPRO_LN_CASE(1, 32, 0)
    REPRO_LN_CASE(1, 64, 0)
#undef REPRO_LN_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// The 1/sqrt table (4096 float32 entries) and its float32 index constants
// on device `device`, set once before its first launch.
extern "C" int repro_layernorm_set_table(int device, const float* tab, float tab_off,
                                         float tab_step) {
    using namespace repro_torch;
    if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    g_devices[device].tab = tab;
    g_devices[device].tab_off = tab_off;
    g_devices[device].tab_step = tab_step;
    return 0;
}

// x, out (rows, k) contiguous; gamma, beta (k,), beta null for RMSNorm.
// `flags` packs, from bit 0: the dtype of x and out (2 bits: 0 float32,
// 1 bfloat16, 2 float16), gamma / beta float32 (else x's dtype), RMSNorm,
// the LUT, then the plan: VEC elements per load (5 bits: 16 bytes' worth,
// or 1), NV vectors per lane (7 bits), and lanes per row (10 bits: 1..32,
// or above 32 the block size of a block per row).  The launch runs on the
// current device, whose table must have been set.
extern "C" int repro_layernorm(const void* x, const void* gamma, const void* beta, void* out,
                               long long rows, int k, int flags, float eps, void* stream) {
    using namespace repro_torch;
    const int dtype = flags & 3, vec = (flags >> 5) & 31, nv = (flags >> 10) & 127,
              lanes = (flags >> 17) & 1023;
    int dev = 0;
    cudaGetDevice(&dev);
    DeviceState& d = g_devices[dev < kMaxDevices ? dev : 0];
    if (d.sms == 0) cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (rows <= 0 || k <= 0 || lanes < 1 || lanes > kMaxThreads || (lanes > 32 && lanes % 32) ||
        d.tab == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Args a{x, gamma, beta, d.tab, out, rows, k, (flags >> 3) & 1, (flags >> 4) & 1,
                 (flags >> 2) & 1, eps, d.tab_off, d.tab_step};
    const auto s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return dispatch<float>(a, vec, nv, lanes, d.sms, s);
        case 1: return dispatch<__nv_bfloat16>(a, vec, nv, lanes, d.sms, s);
        case 2: return dispatch<__half>(a, vec, nv, lanes, d.sms, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
