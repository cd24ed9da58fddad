// Mamba2 SSD chunked scan for Hopper (sm_90a) (arXiv:2405.21060).
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py:ssd_scan_pallas (kernel
// body _ssd_chunk_kernel), whose jnp twin is src/repro/models/ssm.py
// (ssd_chunked).
//
// Per (batch, head) the sequence is walked in chunks of q steps, carrying the
// state S (P x N, float32, zero at the start).  Within a chunk, with cs the
// inclusive prefix sum of the log-decay a:
//   y_i = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) xdt_j + exp(cs_i) (C_i . S)
//   S  <- exp(cs_{q-1}) S + sum_j exp(cs_{q-1} - cs_j) xdt_j (x) B_j
// and the final S is written out too (the Pallas kernel drops it; ssd_chunked
// returns it).
//
// What bounds it on an H100: q(q+1)N + q(q+1)P + 4qPN float32 operations per
// chunk and head (the lower triangles of C B^T and G xdt, C S and the state
// update: 2.90 MFLOP at q 64, P 64, N 128) against q(2P + 2N + 1) float32
// values moved, about 16 operations per byte: bound by operations on the CUDA
// cores (TF32 tensor cores would break the 1e-4 tolerance).
//
// Design: a block owns one (batch, head) and a slice of kRows = 16 rows of P
// (the rows of S are independent), so batch 1 still gives 24 x 4 blocks, and
// walks the chunks in order (the sequential grid axis of the Pallas kernel
// becomes a loop).  Each block recomputes the chunk's q x q score tile
// G = (C B^T) * L; per chunk:
//   1. load a, B and C (by group index head / (H/G), never the per-head
//      copies), and the xdt slice into shared memory, B and C transposed
//      (N x q, row stride 68 floats: a 4-row x 8-column load of a warp hits
//      32 distinct banks), 8 loads per thread in flight before their stores;
//   2. warp 0 scans a into cs, in float64 (a difference cs_i - cs_j of two
//      large float32 sums keeps only ~|cs| 2^-24 of its digits: under strong
//      decay that moved y by 2.8e-4), and forms exp(cs_i), exp(cs_{q-1} - cs_j);
//   3. the lower-triangular 4x4 tiles of G, one per thread, float4 reads of
//      C^T and B^T; the decay exp(cs_i - cs_j) is formed only where j <= i
//      (the upper triangle would overflow, and inf * 0 is NaN), the rest of a
//      diagonal tile is written as 0;
//   4. y for 4 rows x 1 column of P per thread, from G^T and the carried S;
//      the new S stays in registers (8 entries per thread) and goes to
//      shared memory for the next chunk after a barrier.
// All arithmetic is float32 FMA on the CUDA cores.  bf16 inputs are upcast
// on load and y is rounded back to the input type; S is always float32.
// Padded rows of a chunk (q not a multiple of 4) hold zeros.  No allocation,
// the caller's stream; the C entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 64;   // most steps per chunk
constexpr int kMaxN = 128;  // most state columns
constexpr int kMaxP = 128;  // most head rows
constexpr int kQS = 68;     // row stride of B^T, C^T and G^T in shared memory
// Head rows of P per block.  Every block recomputes the chunk's score tile,
// so wider blocks do fewer operations: 16 rows beat 8 at batch 1 and 8 of
// mamba2-130m on an H100.  At most kThreads / (kMaxQ / 4), so that every
// 4-row group of a chunk has a thread per column in the y step.
constexpr int kRows = 16;
static_assert(kThreads / kRows >= kMaxQ / 4, "the y step needs a thread per row group");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Shared-memory floats for state width n.
__host__ __device__ constexpr int smem_floats(int n) {
    return 2 * kMaxQ        // a -> cs (float64)
           + 2 * n * kQS    // B^T, C^T
           + kMaxQ * kQS    // G^T
           + kMaxQ * kRows  // xdt slice
           + n * kRows      // carried S (n-major)
           + 2 * kMaxQ + 4; // exp(cs), exp(cs_last - cs), exp(cs_last)
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ xdt, const T* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y, float* __restrict__ final_state,
                int L, int H, int P, int G, int N, int q) {
    constexpr int kNG = kThreads / kRows;        // state column groups
    constexpr int kKN = kMaxN / kNG;             // state columns per thread
    extern __shared__ __align__(16) float smem[];
    double* cs = reinterpret_cast<double*>(smem);  // [kMaxQ]
    float* bt = smem + 2 * kMaxQ;                // [N][kQS]  B^T
    float* ct = bt + N * kQS;                    // [N][kQS]  C^T
    float* gt = ct + N * kQS;                    // [kMaxQ][kQS]  G^T: gt[j][i]
    float* xs = gt + kMaxQ * kQS;                // [kMaxQ][kRows]
    float* st = xs + kMaxQ * kRows;              // [N][kRows]   carried S
    float* ecs = st + N * kRows;                 // exp(cs_i)
    float* wend = ecs + kMaxQ;                   // exp(cs_{q-1} - cs_j), 0 past q
    float* elast = wend + kMaxQ;                 // exp(cs_{q-1})

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int bh = blockIdx.x;
    const int b = bh / H, h = bh % H;
    const int grp = h / (H / G);
    const int p0 = blockIdx.y * kRows;
    const int q4 = (q + 3) / 4;                  // 4-row groups of a chunk
    const int n_chunks = L / q;

    // this thread's role in the y step (4 rows ig*4.., column pp) ...
    const int pp = tid % kRows, ig = tid / kRows;
    const bool p_ok = p0 + pp < P;
    // ... and in the state step (column pp, state columns ng + kNG * k)
    const int ng = tid / kRows;
    float s_reg[kKN];
#pragma unroll
    for (int k = 0; k < kKN; ++k) s_reg[k] = 0.0f;
    for (int i = tid; i < N * kRows; i += kThreads) st[i] = 0.0f;

    for (int c = 0; c < n_chunks; ++c) {
        const long long row0 = static_cast<long long>(b) * L + static_cast<long long>(c) * q;
        // 1. loads (the barrier at the end of the previous chunk freed the tiles)
        if (tid < kMaxQ) cs[tid] = tid < q ? to_float(a[(row0 + tid) * H + h]) : 0.0;
#pragma unroll
        for (int idx = tid; idx < kMaxQ * kRows; idx += kThreads) {
            const int j = idx / kRows, col = idx % kRows;
            xs[idx] = (j < q && p0 + col < P)
                ? to_float(xdt[((row0 + j) * H + h) * P + p0 + col]) : 0.0f;
        }
        {
            // each warp has kLoads of its 4-row x 8-column tiles of B and C in
            // flight before their stores: a chunk waits on memory 4 times, not 32
            constexpr int kWarps = kThreads / 32, kLoads = 8;
            const int n8 = (N + 7) / 8, tiles = q4 * n8;
            for (int tile0 = warp; tile0 < tiles; tile0 += kLoads * kWarps) {
                float vb[kLoads], vc[kLoads];
#pragma unroll
                for (int u = 0; u < kLoads; ++u) {
                    const int tile = tile0 + u * kWarps;
                    const int t = (tile / n8) * 4 + (lane & 3);
                    const int n = (tile % n8) * 8 + (lane >> 2);
                    const bool ok = tile < tiles && n < N && t < q;
                    const long long off = ((row0 + t) * G + grp) * N + n;
                    vb[u] = ok ? to_float(bm[off]) : 0.0f;
                    vc[u] = ok ? to_float(cm[off]) : 0.0f;
                }
#pragma unroll
                for (int u = 0; u < kLoads; ++u) {
                    const int tile = tile0 + u * kWarps;
                    const int t = (tile / n8) * 4 + (lane & 3);
                    const int n = (tile % n8) * 8 + (lane >> 2);
                    if (tile < tiles && n < N) {
                        bt[n * kQS + t] = vb[u];
                        ct[n * kQS + t] = vc[u];
                    }
                }
            }
        }
        __syncthreads();

        // 2. inclusive prefix sum of a (warp 0, two steps per lane)
        if (warp == 0) {
            const double v0 = cs[2 * lane], v1 = cs[2 * lane + 1];
            double s = v0 + v1;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const double o = __shfl_up_sync(0xffffffffu, s, off);
                if (lane >= off) s += o;
            }
            const double before = s - (v0 + v1);
            cs[2 * lane] = before + v0;
            cs[2 * lane + 1] = before + v0 + v1;
            __syncwarp();
            const double last = cs[q - 1];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int i = 2 * lane + r;
                ecs[i] = expf(static_cast<float>(cs[i]));
                wend[i] = i < q ? expf(static_cast<float>(last - cs[i])) : 0.0f;
            }
            if (lane == 0) elast[0] = expf(static_cast<float>(last));
        }
        __syncthreads();

        // 3. lower-triangular 4x4 tiles of G^T
        {
            const int n_tiles = q4 * (q4 + 1) / 2;
            const int k = tid;
            if (k < n_tiles) {
                int ti = static_cast<int>((sqrtf(8.0f * k + 1.0f) - 1.0f) * 0.5f);
                while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
                while (ti * (ti + 1) / 2 > k) --ti;
                const int tj = k - ti * (ti + 1) / 2;
                const int i0 = 4 * ti, j0 = 4 * tj;
                float acc[4][4] = {};
                for (int n = 0; n < N; ++n) {
                    const float4 cv = *reinterpret_cast<const float4*>(&ct[n * kQS + i0]);
                    const float4 bv = *reinterpret_cast<const float4*>(&bt[n * kQS + j0]);
                    const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
                    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(cr[r], br[cc], acc[r][cc]);
                }
#pragma unroll
                for (int cc = 0; cc < 4; ++cc) {
                    const int j = j0 + cc;
                    float out[4];
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        const int i = i0 + r;
                        out[r] = (j <= i && i < q)
                            ? acc[r][cc] * expf(static_cast<float>(cs[i] - cs[j])) : 0.0f;
                    }
                    *reinterpret_cast<float4*>(&gt[j * kQS + i0]) =
                        make_float4(out[0], out[1], out[2], out[3]);
                }
            }
        }
        __syncthreads();

        // 4a. y = G xdt + exp(cs) (C S), 4 rows x 1 column per thread
        if (ig < q4 && p_ok) {
            const int i0 = 4 * ig;
            float acc[4] = {}, off[4] = {};
            for (int j = 0; j <= i0 + 3; ++j) {
                const float4 g = *reinterpret_cast<const float4*>(&gt[j * kQS + i0]);
                const float xv = xs[j * kRows + pp];
                acc[0] = fmaf(g.x, xv, acc[0]);
                acc[1] = fmaf(g.y, xv, acc[1]);
                acc[2] = fmaf(g.z, xv, acc[2]);
                acc[3] = fmaf(g.w, xv, acc[3]);
            }
            for (int n = 0; n < N; ++n) {
                const float4 cv = *reinterpret_cast<const float4*>(&ct[n * kQS + i0]);
                const float sv = st[n * kRows + pp];
                off[0] = fmaf(cv.x, sv, off[0]);
                off[1] = fmaf(cv.y, sv, off[1]);
                off[2] = fmaf(cv.z, sv, off[2]);
                off[3] = fmaf(cv.w, sv, off[3]);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = i0 + r;
                if (i < q) store(&y[((row0 + i) * H + h) * P + p0 + pp], acc[r] + ecs[i] * off[r]);
            }
        }
        // 4b. S <- exp(cs_last) S + sum_j exp(cs_last - cs_j) xdt_j B_j, in registers
        {
            const float el = elast[0];
#pragma unroll
            for (int k = 0; k < kKN; ++k) s_reg[k] *= el;
            for (int j = 0; j < 4 * q4; j += 4) {
                float xw[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) xw[r] = xs[(j + r) * kRows + pp] * wend[j + r];
#pragma unroll
                for (int k = 0; k < kKN; ++k) {
                    const int n = ng + kNG * k;
                    if (n < N) {
                        const float4 bv = *reinterpret_cast<const float4*>(&bt[n * kQS + j]);
                        float s = s_reg[k];
                        s = fmaf(xw[0], bv.x, s);
                        s = fmaf(xw[1], bv.y, s);
                        s = fmaf(xw[2], bv.z, s);
                        s = fmaf(xw[3], bv.w, s);
                        s_reg[k] = s;
                    }
                }
            }
        }
        __syncthreads();  // every read of S, G and the tiles of this chunk is done
#pragma unroll
        for (int k = 0; k < kKN; ++k) {
            const int n = ng + kNG * k;
            if (n < N) st[n * kRows + pp] = s_reg[k];
        }
    }
    if (p_ok) {
        float* fs = final_state + (static_cast<long long>(bh) * P + p0 + pp) * N;
#pragma unroll
        for (int k = 0; k < kKN; ++k) {
            const int n = ng + kNG * k;
            if (n < N) fs[n] = s_reg[k];
        }
    }
}

template <typename T>
cudaError_t launch(const T* xdt, const T* a, const T* bm, const T* cm, T* y, float* fs,
                   int B, int L, int H, int P, int G, int N, int q, cudaStream_t stream) {
    const size_t bytes = sizeof(float) * smem_floats(N);
    cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (P + kRows - 1) / kRows);
    ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(xdt, a, bm, cm, y, fs, L, H, P, G,
                                                           N, q);
    return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// xdt, y (B, L, H, P); a (B, L, H); bm, cm (B, L, G, N), all contiguous and of
// one type (dtype 0: float32, 1: bfloat16); final_state (B, H, P, N) float32.
// q is the chunk (L % q == 0, 1 <= q <= 64); P, N <= 128; H % G == 0.
extern "C" int repro_ssd_scan(const void* xdt, const void* a, const void* bm, const void* cm,
                              void* y, float* final_state, int B, int L, int H, int P, int G,
                              int N, int q, int dtype, void* stream) {
    using namespace repro_torch;
    if (B <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || P > kMaxP || N <= 0 ||
        N > kMaxN || q <= 0 || q > kMaxQ || L % q || static_cast<long long>(B) * H > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return static_cast<int>(launch(
            static_cast<const float*>(xdt), static_cast<const float*>(a),
            static_cast<const float*>(bm), static_cast<const float*>(cm),
            static_cast<float*>(y), final_state, B, L, H, P, G, N, q, s));
    if (dtype == 1)
        return static_cast<int>(launch(
            static_cast<const __nv_bfloat16*>(xdt), static_cast<const __nv_bfloat16*>(a),
            static_cast<const __nv_bfloat16*>(bm), static_cast<const __nv_bfloat16*>(cm),
            static_cast<__nv_bfloat16*>(y), final_state, B, L, H, P, G, N, q, s));
    return static_cast<int>(cudaErrorInvalidValue);
}
