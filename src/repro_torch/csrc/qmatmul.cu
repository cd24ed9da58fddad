// int8 x int8 -> int32 GEMM with the dequantizing epilogue, for Hopper (sm_90a).
//
//   out[m, n] = float(sum_k x[m, k] * w[k, n]) * (x_scale[m] * w_scale[n])
//
// Replaces: src/repro/kernels/qmatmul/qmatmul.py:qmatmul_pallas (kernel body
// _qmatmul_kernel).  It carries stages 1 and 4 of the paper's streaming MHA
// (src/repro/core/streaming_mha.py) and the qmatmul entry point.
//
// The paper's reuse factor R is the Pallas kernel's sequential grid_k
// dimension: K is walked in R chunks while the int32 accumulator of one
// output tile carries across them.  Here a block owns one output tile and
// walks the R chunks in a loop; blocks carry nothing between them.  Integer
// sums are exact, so the result is the same for every R.
//
// What bounds it on an H100: 2 M N K operations against M K + K N bytes of
// codes and 4 M N bytes of float32 output.  At the physics encoders' widths
// (K = N = 16 .. 64, M ~ 10^5 .. 10^6 tokens) that is at most 32 operations
// per output byte against an int8 ridge of 1979 TOP/s / 3.35 TB/s ~ 590, so
// it is bound by bytes, the float32 output above all.  At 4096^3 it is bound
// by int8 tensor-core operations.
//
// Design: mma.sync m16n8k32 s8.s8.s32 tensor-core tiles (wgmma and TMA are
// later work).  A block of 8 warps owns a BM x BN output tile, picked by N
// so that narrow outputs do not waste the tile; it stages 64-byte K slices
// of x (row-major, as given) and of w (transposed on the way in, with a 4x4
// byte transpose in registers, so that both operands' fragments are single
// 32-bit shared-memory loads) into two shared-memory buffers, and prefetches
// the next slice into registers while the tensor cores work on the current
// one.  Rows are padded to 80 bytes, which makes every fragment load
// conflict-free.  The epilogue converts the sum with __int2float_rn and
// multiplies by __fmul_rn(xs, ws) (no FMA contraction), which matches the
// plain version's acc.float() * (x_scale * w_scale) bit for bit.
//
// Contract with the wrapper (kernels/qmatmul/ops.py): x is (M, Kp) and w is
// (Kp, Np) int8, contiguous, 16-byte aligned, Kp and Np multiples of 16,
// zero-padded beyond the true K and N; out is (M, N) float32.  The kernel
// allocates nothing and launches on the caller's stream; the C entry returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;       // 8 warps
constexpr int kBK = 64;             // K bytes per shared-memory slice
constexpr int kRowBytes = kBK + 16;  // 20 words: rows fall on distinct bank quads

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_>
struct Tile {
    static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
    static_assert(WARPS_M * WARPS_N * 32 == kThreads, "8 warps per block");
    static constexpr int WTM = BM / WARPS_M;  // warp tile
    static constexpr int WTN = BN / WARPS_N;
    static constexpr int MI = WTM / 16;  // m16 fragments per warp
    static constexpr int NI = WTN / 8;   // n8 fragments per warp
    static constexpr int A_CHUNKS = BM * kBK / 16;  // 16-byte chunks per x slice
    static constexpr int A_PER_THREAD = A_CHUNKS / kThreads;
    static constexpr int B_UNITS = (kBK / 4) * (BN / 4);  // 4x4-byte blocks per w slice
    static constexpr int B_PER_THREAD = (B_UNITS + kThreads - 1) / kThreads;
    static_assert(A_CHUNKS % kThreads == 0, "x slice splits evenly");
    static_assert(MI >= 1 && NI >= 1, "warp tile at least 16 x 8");

    // Block u of a w slice covers rows kq*4 .. +3, columns nq*4 .. +3.  Up to 8
    // neighbouring lanes take neighbouring column quads (one 32-byte sector of
    // a row), the next lanes the next row quads: global reads use whole
    // sectors, and the transposed shared-memory stores conflict at most 4 ways.
    static constexpr int NQ = BN / 4;
    static constexpr int NQ_LO = NQ < 8 ? NQ : 8;
    __device__ static void unit(int u, int& kq, int& nq) {
        const int rest = u / NQ_LO;
        kq = rest % (kBK / 4);
        nq = (rest / (kBK / 4)) * NQ_LO + u % NQ_LO;
    }
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// r[j] holds bytes w[k + j][n .. n + 3]; returns c[i] = bytes w[k .. k + 3][n + i].
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&c)[4]) {
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    c[0] = __byte_perm(t0, t2, 0x5410);
    c[1] = __byte_perm(t0, t2, 0x7632);
    c[2] = __byte_perm(t1, t3, 0x5410);
    c[3] = __byte_perm(t1, t3, 0x7632);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
qmatmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ xs, const float* __restrict__ ws,
               float* __restrict__ out, int M, int N, int Kp, int Np, int grid_k) {
    __shared__ __align__(16) uint8_t As[2][T::BM][kRowBytes];
    __shared__ __align__(16) uint8_t Bs[2][T::BN][kRowBytes];  // [n][k]: w transposed

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
    const int wm = (warp / T::WARPS_N) * T::WTM;
    const int wn = (warp % T::WARPS_N) * T::WTN;
    const int m0 = blockIdx.x * T::BM;
    const int n0 = blockIdx.y * T::BN;

    int acc[T::MI][T::NI][4];
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
        for (int j = 0; j < T::NI; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

    int4 a_reg[T::A_PER_THREAD];
    uint32_t b_reg[T::B_PER_THREAD][4];

    auto load_global = [&](int k0) {
#pragma unroll
        for (int i = 0; i < T::A_PER_THREAD; ++i) {
            const int c = tid + i * kThreads;
            const int row = c / (kBK / 16), col = (c % (kBK / 16)) * 16;
            const int m = m0 + row, k = k0 + col;
            a_reg[i] = (m < M && k < Kp)
                ? *reinterpret_cast<const int4*>(x + static_cast<size_t>(m) * Kp + k)
                : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int i = 0; i < T::B_PER_THREAD; ++i) {
            const int u = tid + i * kThreads;
            int kq, nq;
            T::unit(u, kq, nq);
            const int k = k0 + kq * 4, n = n0 + nq * 4;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                b_reg[i][j] = (u < T::B_UNITS && k + j < Kp && n < Np)
                    ? *reinterpret_cast<const uint32_t*>(w + static_cast<size_t>(k + j) * Np + n)
                    : 0u;
            }
        }
    };
    auto store_shared = [&](int buf) {
#pragma unroll
        for (int i = 0; i < T::A_PER_THREAD; ++i) {
            const int c = tid + i * kThreads;
            const int row = c / (kBK / 16), col = (c % (kBK / 16)) * 16;
            *reinterpret_cast<int4*>(&As[buf][row][col]) = a_reg[i];
        }
#pragma unroll
        for (int i = 0; i < T::B_PER_THREAD; ++i) {
            const int u = tid + i * kThreads;
            if (u >= T::B_UNITS) continue;
            int kq, nq;
            T::unit(u, kq, nq);
            uint32_t cols[4];
            transpose4x4(b_reg[i], cols);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                *reinterpret_cast<uint32_t*>(&Bs[buf][nq * 4 + j][kq * 4]) = cols[j];
        }
    };
    auto compute = [&](int buf, int k0) {
#pragma unroll
        for (int ks = 0; ks < kBK; ks += 32) {
            if (k0 + ks >= Kp) break;  // all-zero half slice (K = 16 or 48 mod 64)
            uint32_t a[T::MI][4], b[T::NI][2];
#pragma unroll
            for (int i = 0; i < T::MI; ++i) {
                const int r = wm + i * 16 + g;
                a[i][0] = *reinterpret_cast<const uint32_t*>(&As[buf][r][ks + tig * 4]);
                a[i][1] = *reinterpret_cast<const uint32_t*>(&As[buf][r + 8][ks + tig * 4]);
                a[i][2] = *reinterpret_cast<const uint32_t*>(&As[buf][r][ks + 16 + tig * 4]);
                a[i][3] = *reinterpret_cast<const uint32_t*>(&As[buf][r + 8][ks + 16 + tig * 4]);
            }
#pragma unroll
            for (int j = 0; j < T::NI; ++j) {
                const int cn = wn + j * 8 + g;
                b[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[buf][cn][ks + tig * 4]);
                b[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[buf][cn][ks + 16 + tig * 4]);
            }
#pragma unroll
            for (int i = 0; i < T::MI; ++i)
#pragma unroll
                for (int j = 0; j < T::NI; ++j) mma_s8(acc[i][j], a[i], b[j]);
        }
    };

    // K in grid_k sequential chunks of whole slices (the reuse factor R); the
    // pipeline runs straight across chunk boundaries, since the next slice
    // after the last of a chunk is the first of the next.
    const int n_slices = (Kp + kBK - 1) / kBK;
    const int per_chunk = (n_slices + grid_k - 1) / grid_k;
    if (n_slices > 0) {
        load_global(0);
        store_shared(0);
        __syncthreads();
    }
    for (int r = 0; r < grid_k; ++r) {
        const int s_end = min(n_slices, (r + 1) * per_chunk);
        for (int s = r * per_chunk; s < s_end; ++s) {
            const bool more = s + 1 < n_slices;
            if (more) load_global((s + 1) * kBK);
            compute(s & 1, s * kBK);
            if (more) store_shared((s + 1) & 1);
            __syncthreads();
        }
    }

    // Epilogue: dequantize with the per-row x scale and per-column w scale.
    const bool pairs = (N % 2) == 0;  // then (m, n even) is 8-byte aligned
#pragma unroll
    for (int i = 0; i < T::MI; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm + i * 16 + g + h * 8;
            if (m >= M) continue;
            const float xm = __ldg(&xs[m]);
            float* orow = out + static_cast<size_t>(m) * N;
#pragma unroll
            for (int j = 0; j < T::NI; ++j) {
                const int n = n0 + wn + j * 8 + tig * 2;
                if (n >= N) continue;
                const float v0 = __fmul_rn(__int2float_rn(acc[i][j][2 * h]),
                                           __fmul_rn(xm, __ldg(&ws[n])));
                if (n + 1 < N) {
                    const float v1 = __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]),
                                               __fmul_rn(xm, __ldg(&ws[n + 1])));
                    if (pairs) {
                        *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
                    } else {
                        orow[n] = v0;
                        orow[n + 1] = v1;
                    }
                } else {
                    orow[n] = v0;
                }
            }
        }
    }
}

template <class T>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* xs, const float* ws,
                   float* out, int M, int N, int Kp, int Np, int grid_k,
                   cudaStream_t stream) {
    const dim3 grid((M + T::BM - 1) / T::BM, (N + T::BN - 1) / T::BN);
    qmatmul_kernel<T><<<grid, kThreads, 0, stream>>>(x, w, xs, ws, out, M, N, Kp, Np, grid_k);
    return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x (M, Kp), w (Kp, Np) int8; xs (M,), ws (N,) float32; out (M, N) float32.
extern "C" int repro_qmatmul(const int8_t* x, const int8_t* w, const float* xs,
                             const float* ws, float* out, int M, int N, int Kp, int Np,
                             int grid_k, void* stream) {
    using namespace repro_torch;
    if (M <= 0 || N <= 0 || Kp < 0 || Kp % 16 || Np % 16 || Np < N || grid_k < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (N <= 16)
        err = launch<Tile<256, 16, 8, 1>>(x, w, xs, ws, out, M, N, Kp, Np, grid_k, s);
    else if (N <= 32)
        err = launch<Tile<256, 32, 8, 1>>(x, w, xs, ws, out, M, N, Kp, Np, grid_k, s);
    else if (N <= 64)
        err = launch<Tile<128, 64, 4, 2>>(x, w, xs, ws, out, M, N, Kp, Np, grid_k, s);
    else
        err = launch<Tile<128, 128, 2, 4>>(x, w, xs, ws, out, M, N, Kp, Np, grid_k, s);
    return static_cast<int>(err);
}
