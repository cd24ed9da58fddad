// Mamba2 SSD chunked scan for Hopper (sm_90a) (arXiv:2405.21060).
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py:ssd_scan_pallas (kernel
// body _ssd_chunk_kernel), whose jnp twin is src/repro/models/ssm.py
// (ssd_chunked).
//
// Per (batch, head) the sequence is cut into chunks of q steps.  With cs the
// inclusive prefix sum of the log-decay a within a chunk and S_in[c] the
// state (P x N, float32) entering chunk c (S_in[0] = 0):
//   y_i      = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) xdt_j + exp(cs_i) (C_i . S_in[c])
//   S_c      = sum_j exp(cs_{q-1} - cs_j) xdt_j (x) B_j         (the chunk's own state)
//   S_in[c+1] = exp(cs_{q-1}) S_in[c] + S_c
// and the final state S_in[n_chunks] is written out too (the Pallas kernel
// drops it; ssd_chunked returns it).
//
// What bounds it on an H100: b (l/q) [g q(q+1)N + h (q(q+1)P + 4qPN)]
// operations (C B^T once per group, the lower triangle of G xdt, C S_in and
// the chunk state per head) against the inputs read and y written once:
// ~20 operations per byte in float32.  One TF32 product keeps 10 mantissa
// bits and moves y by 4e-3 to 1e-2 at small shapes of mamba2-130m's widths,
// 40 to 100 times the 1e-4 tolerance; three TF32 products (small*big +
// big*small + big*big, "3xTF32") stay within 8e-6 (both emulated with this
// kernel's operand split in tests/test_torch_ssd_scan.py).
// So every product runs as 3xTF32 on mma.sync.m16n8k8, and the bound is
// float32 work at 495 / 3 TFLOP/s (mma.sync itself peaks at about two
// thirds of the TF32 rate: tools/mma_sync_rate.py).  bf16 inputs are exact
// in TF32, so a product with a bf16 operand skips the terms of its zero
// small half.  The design has a floor of its own: the chunk states go
// through device memory (written once, read and rewritten once, read once),
// 201 MB at mamba2-130m's batch 8.
//
// Design: three kernels, each parallel over chunks, launched back to back on
// the caller's stream (the reference's steps 2, 3 and 1 + 4):
//   1. ssd_chunk_state_kernel: a block owns (batch, chunk, group, a tile of
//      that group's heads), two blocks per SM.  B (q x N) is staged once for
//      the tile; per head, xdt (q x P) comes through a two-stage cp.async
//      ring, so the next head's copy overlaps this head's product.  Each warp
//      scans a in float64 itself (a difference cs_i - cs_j of two large
//      float32 sums keeps only ~|cs| 2^-24 of its digits: under strong decay
//      that moved y by 2.8e-4), forms w_j = exp(cs_{q-1} - cs_j), and
//      computes 32 x 32 tiles of S_c = (xdt * w)^T B into shared memory; S_c
//      goes to the float32 scratch `states` as one TMA bulk store, and
//      exp(cs_{q-1}) to `decay` (b, h, n_chunks).
//   2. ssd_state_pass_kernel: a thread owns 4 entries of one (batch, head)
//      state and walks the chunks, S_in[c+1] = decay_c S_in[c] + S_c,
//      overwriting slot c with S_in[c] (c >= 1) and writing the final state.
//      Elementwise and bound by bytes; 8 chunks' loads in flight per thread.
//   3. ssd_output_kernel: a block owns (batch, chunk, group, a tile of
//      heads) and is two teams of 8 warps.  It stages C and B, computes C B^T
//      (q x q) once for the tile and splits C into its TF32 halves.  The
//      teams then take alternate (head, slice of <= 64 columns of P) units,
//      each with its own buffers and named barrier, team 1 starting half a
//      unit late, so that one team's copies, barriers and exps overlap the
//      other's products (one team of 8 warps left the SM idle between its
//      phases: tools/ssd_scan_variants.py).  Per unit: xdt by cp.async and
//      the S_in slice by one TMA bulk copy; the head's G = C B^T * L, with
//      L = exp(cs_i - cs_j) formed only where j <= i (the upper triangle
//      would overflow, and inf * 0 is NaN); then each warp's 32 x 16 tile
//      of y = G xdt + diag(exp(cs)) C S_in^T.  Chunk 0 has S_in = 0 and
//      skips that product and its copy.
// The scratch rows are padded to state_row(N) floats, as the output kernel's
// shared memory holds them, so a slice of rows is one contiguous copy.  The
// host picks the head tile per kernel from the grid and the occupancy
// (fewest waves of blocks, then fewest tiles).  Operands are split into
// their TF32 halves by Veltkamp's method as they are read (or once per
// block, C), rows padded so that every fragment read is free of bank
// conflicts; a product runs in parts of 4 k-steps added in float32.  Tiles
// are zero-padded in shared memory to 64 steps, N and P to multiples of 32:
// q < 64, N 24 or P 8 never read out of bounds.  bf16 inputs are converted
// as they are read; y is rounded back to the input type; states are
// float32.  No allocation: the wrapper passes y, the final state and both
// scratches; the C entry returns the first launch error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 64;    // most steps per chunk (rows of every staged tile)
constexpr int kMaxN = 128;   // most state columns
constexpr int kMaxP = 128;   // most head rows
constexpr int kSlice = 64;   // columns of P per output unit
constexpr int kGS = kMaxQ + 4;  // row stride of C B^T in shared memory

__host__ __device__ constexpr int round32(int x) { return (x + 31) / 32 * 32; }
// Row strides (elements) of a staged tile of width w, so that a warp's
// fragment reads hit 32 distinct banks: by_t when the fragment's row is the
// lane's t = lane % 4 (stride = 8 mod 32 words), by_g when it is g = lane / 4
// (4 mod 32 words).  bf16 rows of w + 8 elements are 4 mod 16 words, which
// serves both.  Every row is a multiple of 16 bytes (cp.async).
template <typename T>
__host__ __device__ constexpr int stride_by_t(int w) { return w + 8; }
template <typename T>
__host__ __device__ constexpr int stride_by_g(int w) { return sizeof(T) == 4 ? w + 4 : w + 8; }
__host__ __device__ constexpr int slice_width(int p) { return p <= 32 ? 32 : kSlice; }
// Row stride (floats) of a chunk state in the scratch, the same as in the
// output kernel's shared memory: N zero-padded to a multiple of 32, then 4
// floats unused (by_g), so that a slice of rows is copied as one block.
__host__ __device__ constexpr int state_row(int n) { return round32(n) + 4; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
    }
}
// bytes (a multiple of 16, both addresses 16-byte aligned) global -> shared
// by the TMA unit, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) shared -> global
// by the TMA unit, in the thread's bulk group; the writes to shared memory
// before it need fence.proxy.async.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 "cp.async.bulk.commit_group;\n" ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
                 : "memory");
}
// Waits until the thread's bulk stores have read their source (READ) or are
// complete.
template <bool READ>
__device__ __forceinline__ void bulk_store_wait() {
    if constexpr (READ)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    else
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Stages rows x cols elements (row r at src + r * ld) at dst (row stride
// sld), zero-filling up to rows_pad x cols_pad; cols_pad * sizeof(T) is a
// multiple of 16 and at most 512 bytes; threads tid of nthreads share it.  A
// thread keeps one 16-byte column chunk and walks the rows: 16-byte copies
// where the source allows, else element by element through registers.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int sld, const T* src, long long ld,
                                           int rows, int cols, int rows_pad, int cols_pad,
                                           int tid, int nthreads) {
    constexpr int E = 16 / sizeof(T);
    const int chunks = cols_pad / E, step = nthreads / chunks;
    const int r0 = tid / chunks, e0 = (tid - r0 * chunks) * E;
    if (r0 >= step) return;
    const bool fast = e0 + E <= cols &&
                      ((reinterpret_cast<uintptr_t>(src + e0) | (ld * sizeof(T))) & 15) == 0;
    for (int r = r0; r < rows_pad; r += step) {
        T* d = dst + r * sld + e0;
        const T* s = src + r * ld + e0;
        if (r >= rows || e0 >= cols) {
            cp_async16(d, src, 0);
        } else if (fast) {
            cp_async16(d, s, 16);
        } else {
#pragma unroll
            for (int e = 0; e < E; ++e) d[e] = e0 + e < cols ? s[e] : T(0.0f);
        }
    }
}

// x = big + small: big rounded to the nearest TF32 value (11 significant
// bits, Veltkamp's split by 2^13 + 1), small = x - big exactly, which the
// tensor cores read truncated to TF32 (2^-22 |x| at most).  Four FP32
// operations: cvt.rna.tf32 runs on the conversion pipe, at a fraction of the
// FP32 rate, and two of them per operand held the products back.  Without
// SPLIT, x is a bf16 value, exact in TF32, and small is 0.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
    if constexpr (SPLIT) {
        const float s = __fmul_rn(x, 8193.0f);
        const float b = __fsub_rn(s, __fsub_rn(s, x));
        big = __float_as_uint(b);
        small = __float_as_uint(__fsub_rn(x, b));
    } else {
        big = __float_as_uint(x);
        small = 0u;
    }
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in float32 accuracy, a = ab + as and b = bb + bs: small terms
// first, then big * big; a term whose small half is known to be 0 is skipped.
template <bool SA, bool SB>
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
    if constexpr (SA) mma_tf32(c, as, bb[0], bb[1]);
    if constexpr (SB) mma_tf32(c, ab, bs[0], bs[1]);
    mma_tf32(c, ab, bb[0], bb[1]);
}

// The tensor cores add into the accumulator with truncation, about an ulp of
// the running sum per mma: over a chain of 48 (C S_in at N 128) that moved y
// by 4e-6 of its size.  So a product runs in parts of 4 k-steps of 8, each
// into a zeroed accumulator, and the parts are added in float32; kPart marks
// the k offset (mod 32) that closes a part.
constexpr int kPart = 24;
template <int M>
__device__ __forceinline__ void add_part(float (&acc)[M][4], float (&part)[M][4]) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            acc[m][r] += part[m][r];
            part[m][r] = 0.0f;
        }
}

// acc += diag(e) part for two m16 x two n8 tiles ([2 * mi + ni]; e[mi][r]
// scales rows g + 8 r of m-tile mi), then part = 0.
__device__ __forceinline__ void add_part_scaled(float (&acc)[4][4], float (&part)[4][4],
                                                const float (&e)[2][2]) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            acc[m][r] = fmaf(e[m >> 1][r >> 1], part[m][r], acc[m][r]);
            part[m][r] = 0.0f;
        }
}

// Inclusive prefix sums in float64 of v[0..63] (v = 0 past q): lane l gets
// cs[l] in lo and cs[l + 32] in hi.
__device__ __forceinline__ void scan64(const float* v, int lane, double& lo, double& hi) {
    lo = v[lane];
    hi = v[lane + 32];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const double o = __shfl_up_sync(0xffffffffu, lo, off);
        const double p = __shfl_up_sync(0xffffffffu, hi, off);
        if (lane >= off) {
            lo += o;
            hi += p;
        }
    }
    hi += __shfl_sync(0xffffffffu, lo, 31);
}

struct Dims {
    int B, L, H, P, G, N, q, nc;  // nc = L / q chunks
    int ht, tiles;                // heads per block, head tiles per group
    int bulk;                     // pass 3 copies S_in slices by TMA (whole slices)
};

// The block's (batch, chunk, group, first head, heads) from blockIdx.x,
// head tiles fastest (the tiles of one chunk share its B and C in L2).
struct Item {
    int b, c, grp, h0, nh;
    long long row0;  // b * L + c * q
};
__device__ __forceinline__ Item block_item(const Dims& d) {
    int k = blockIdx.x;
    Item it;
    const int tile = k % d.tiles;
    k /= d.tiles;
    it.grp = k % d.G;
    k /= d.G;
    it.c = k % d.nc;
    it.b = k / d.nc;
    const int hg = d.H / d.G;
    it.h0 = it.grp * hg + tile * d.ht;
    it.nh = min(d.ht, hg - tile * d.ht);
    it.row0 = static_cast<long long>(it.b) * d.L + static_cast<long long>(it.c) * d.q;
    return it;
}

// a of step j (0 past q) of the block's chunk, head h
template <typename T>
__device__ __forceinline__ float load_a(const T* a, const Dims& d, const Item& it, int h, int j) {
    return j < d.q ? to_float(a[(it.row0 + j) * d.H + h]) : 0.0f;
}

// ---------------------------------------------------------------- pass 1 --

template <typename T>
__host__ __device__ constexpr size_t chunk_state_smem(int P, int N) {
    return sizeof(T) * kMaxQ * (stride_by_t<T>(round32(N)) + 2 * stride_by_t<T>(round32(P))) +
           sizeof(float) * (2 * kMaxQ + kWarps * kMaxQ + P * state_row(N));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_state_kernel(const T* __restrict__ xdt, const T* __restrict__ a,
                       const T* __restrict__ bm, float* __restrict__ states,
                       float* __restrict__ decay, Dims d) {
    constexpr bool kF32 = sizeof(T) == 4;
    const int Np = round32(d.N), Pp = round32(d.P);
    const int SB = stride_by_t<T>(Np), SX = stride_by_t<T>(Pp);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* bs = reinterpret_cast<T*>(smem_raw);                // [kMaxQ][SB]  B
    T* xs = bs + kMaxQ * SB;                               // [2][kMaxQ][SX]  xdt ring
    float* as = reinterpret_cast<float*>(xs + 2 * kMaxQ * SX);  // [2][kMaxQ]  a ring
    float* ws = as + 2 * kMaxQ;                            // [kWarps][kMaxQ]  w per warp
    float* so = ws + kWarps * kMaxQ;                       // [P][state_row(N)]  S_c, as stored

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const Item it = block_item(d);
    const int q8 = (d.q + 7) & ~7;

    stage_tile(bs, SB, bm + (it.row0 * d.G + it.grp) * d.N, static_cast<long long>(d.G) * d.N,
               d.q, d.N, kMaxQ, Np, threadIdx.x, kThreads);
    auto stage = [&](int u) {
        stage_tile(xs + (u & 1) * kMaxQ * SX, SX, xdt + (it.row0 * d.H + it.h0 + u) * d.P,
                   static_cast<long long>(d.H) * d.P, d.q, d.P, kMaxQ, Pp, threadIdx.x, kThreads);
        cp_async_commit();
    };
    stage(0);
    if (threadIdx.x < kMaxQ) as[threadIdx.x] = load_a(a, d, it, it.h0, threadIdx.x);

    const int n_wt = (Pp / 32) * (Np / 32);
    for (int u = 0; u < it.nh; ++u) {
        cp_async_wait_all();
        __syncthreads();  // stage u is in; every warp is done with stage u - 1
        float a_next = 0.0f;
        if (u + 1 < it.nh) {
            stage(u + 1);
            if (threadIdx.x < kMaxQ) a_next = load_a(a, d, it, it.h0 + u + 1, threadIdx.x);
        }
        const int h = it.h0 + u;
        double lo, hi;
        scan64(as + (u & 1) * kMaxQ, lane, lo, hi);
        const double last = __shfl_sync(0xffffffffu, d.q - 1 < 32 ? lo : hi, (d.q - 1) & 31);
        float* w = ws + warp * kMaxQ;
        w[lane] = lane < d.q ? expf(static_cast<float>(last - lo)) : 0.0f;
        w[lane + 32] = lane + 32 < d.q ? expf(static_cast<float>(last - hi)) : 0.0f;
        __syncwarp();
        if (threadIdx.x == 0) {
            decay[(static_cast<long long>(it.b) * d.H + h) * d.nc + it.c] =
                expf(static_cast<float>(last));
            bulk_store_wait<true>();  // the previous head's store has read `so`
        }
        __syncthreads();

        const T* x = xs + (u & 1) * kMaxQ * SX;
        for (int wt = warp; wt < n_wt; wt += kWarps) {
            const int pw = (wt / (Np / 32)) * 32, nw = (wt % (Np / 32)) * 32;
            float acc[8][4] = {}, part[8][4] = {};  // [4 * mi + ni]
            for (int j0 = 0; j0 < q8; j0 += 8) {
                const int ja = j0 + t, jb = ja + 4;
                const float wa = w[ja], wb = w[jb];
                uint32_t ab[2][4], asm_[2][4];
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                    const int p = pw + 16 * mi + g;
                    split<true>(to_float(x[ja * SX + p]) * wa, ab[mi][0], asm_[mi][0]);
                    split<true>(to_float(x[ja * SX + p + 8]) * wa, ab[mi][1], asm_[mi][1]);
                    split<true>(to_float(x[jb * SX + p]) * wb, ab[mi][2], asm_[mi][2]);
                    split<true>(to_float(x[jb * SX + p + 8]) * wb, ab[mi][3], asm_[mi][3]);
                }
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) {
                    const int n = nw + 8 * ni + g;
                    uint32_t bb[2], bsm[2];
                    split<kF32>(to_float(bs[ja * SB + n]), bb[0], bsm[0]);
                    split<kF32>(to_float(bs[jb * SB + n]), bb[1], bsm[1]);
#pragma unroll
                    for (int mi = 0; mi < 2; ++mi)
                        mma_3xtf32<true, kF32>(part[4 * mi + ni], ab[mi], asm_[mi], bb, bsm);
                }
                if ((j0 & kPart) == kPart || j0 + 8 >= q8) add_part(acc, part);
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const int p = pw + 16 * mi + g + 8 * r;
                    if (p >= d.P) continue;
#pragma unroll
                    for (int ni = 0; ni < 4; ++ni)  // columns N..Np hold zeros (B's padding)
                        store2(so + p * state_row(d.N) + nw + 8 * ni + 2 * t,
                               acc[4 * mi + ni][2 * r], acc[4 * mi + ni][2 * r + 1]);
                }
        }
        // S_c of head h, rows of state_row(N), to the scratch as one TMA bulk store
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (threadIdx.x == 0)
            bulk_store(states + ((static_cast<long long>(it.b) * d.nc + it.c) * d.H + h) *
                                    static_cast<long long>(d.P) * state_row(d.N),
                       so, 4u * d.P * state_row(d.N));
        if (u + 1 < it.nh && threadIdx.x < kMaxQ) as[((u + 1) & 1) * kMaxQ + threadIdx.x] = a_next;
    }
    if (threadIdx.x == 0) bulk_store_wait<false>();
}

// ---------------------------------------------------------------- pass 2 --

__device__ __forceinline__ float4 fma4(float d, float4 s, float4 v) {
    return make_float4(fmaf(d, s.x, v.x), fmaf(d, s.y, v.y), fmaf(d, s.z, v.z), fmaf(d, s.w, v.w));
}

__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                      float* __restrict__ final_state, Dims d) {
    constexpr int kDepth = 8;  // chunks whose loads are in flight at once
    const int SR = state_row(d.N);
    const int bh = blockIdx.x, b = bh / d.H, h = bh % d.H;
    const int e = (blockIdx.y * kThreads + threadIdx.x) * 4, p = e / SR, n = e - p * SR;
    if (p >= d.P || n >= round32(d.N)) return;  // a row's last 4 floats are unused
    const long long slab = static_cast<long long>(d.P) * SR, cstride = d.H * slab;
    float4* base = reinterpret_cast<float4*>(
        states + (static_cast<long long>(b) * d.nc * d.H + h) * slab + e);
    const float* dec = decay + static_cast<long long>(bh) * d.nc;
    float4 s = base[0];  // S_in[1] = S_0
    for (int c0 = 1; c0 < d.nc; c0 += kDepth) {
        float4 v[kDepth];
#pragma unroll
        for (int k = 0; k < kDepth; ++k)
            if (c0 + k < d.nc) v[k] = base[(c0 + k) * cstride / 4];
#pragma unroll
        for (int k = 0; k < kDepth; ++k) {
            const int c = c0 + k;
            if (c < d.nc) {
                base[c * cstride / 4] = s;  // slot c <- S_in[c]
                s = fma4(dec[c], s, v[k]);  // S_in[c+1] = decay_c S_in[c] + S_c
            }
        }
    }
    float* fs = final_state + (static_cast<long long>(bh) * d.P + p) * d.N + n;
    const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (n + k < d.N) fs[k] = v[k];
}

// ---------------------------------------------------------------- pass 3 --

// The output kernel's block is kTeams teams of kWarps warps; a team works
// every kTeams-th (head, slice) unit of the block with its own buffers and
// named barrier, so one team's copies, barriers and exps overlap the other's
// products.
constexpr int kTeams = 2;
constexpr int kOutThreads = kTeams * kThreads;

__device__ __forceinline__ void team_sync(int team) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "n"(kThreads) : "memory");
}

// Bytes of a team's stage: an xdt slice (T) and an S_in slice (float32), or
// B (T), which team 1's stage holds until C B^T is formed.
template <typename T>
__host__ __device__ constexpr int out_stage_bytes(int P, int N) {
    return static_cast<int>(sizeof(T)) * kMaxQ * stride_by_t<T>(slice_width(P)) +
                       4 * slice_width(P) * state_row(N) >
                   static_cast<int>(sizeof(T)) * kMaxQ * stride_by_g<T>(round32(N))
               ? static_cast<int>(sizeof(T)) * kMaxQ * stride_by_t<T>(slice_width(P)) +
                     4 * slice_width(P) * state_row(N)
               : static_cast<int>(sizeof(T)) * kMaxQ * stride_by_g<T>(round32(N));
}
// C as the products read it: float32 as its TF32 halves (two uint32 arrays),
// bf16 as it came (exact in TF32).
template <typename T>
__host__ __device__ constexpr int out_c_bytes(int N) {
    return (sizeof(T) == 4 ? 8 : 2) * kMaxQ * stride_by_g<T>(round32(N));
}
template <typename T>
__host__ __device__ constexpr size_t output_smem(int P, int N) {
    return sizeof(float) * ((1 + kTeams) * kMaxQ * kGS + kTeams * kMaxQ) + out_c_bytes<T>(N) +
           kTeams * out_stage_bytes<T>(P, N) + 8 * kTeams;
}

// The A fragment value of C at idx: its TF32 halves.
template <typename T>
__device__ __forceinline__ void load_c(const uint32_t* cbig, const uint32_t* csml, int idx,
                                       uint32_t& big, uint32_t& small) {
    if constexpr (sizeof(T) == 4) {
        big = cbig[idx];
        small = csml[idx];
    } else {
        big = __float_as_uint(to_float(reinterpret_cast<const T*>(cbig)[idx]));
        small = 0u;
    }
}

template <typename T>
__global__ void __launch_bounds__(kOutThreads, 1)
ssd_output_kernel(const T* __restrict__ xdt, const T* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, const float* __restrict__ states, T* __restrict__ y,
                  Dims d) {
    constexpr bool kF32 = sizeof(T) == 4;
    const int Np = round32(d.N), W = slice_width(d.P);
    const int SC = stride_by_g<T>(Np), SX = stride_by_t<T>(W), SS = state_row(d.N);
    const int slices = (d.P + W - 1) / W, stage_bytes = out_stage_bytes<T>(d.P, d.N);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* cb = reinterpret_cast<float*>(smem_raw);        // [kMaxQ][kGS]  C B^T
    float* gss = cb + kMaxQ * kGS;                         // [kTeams][kMaxQ][kGS]  G = C B^T * L
    float* ass = gss + kTeams * kMaxQ * kGS;               // [kTeams][kMaxQ]  a
    uint32_t* cbig = reinterpret_cast<uint32_t*>(ass + kTeams * kMaxQ);  // [kMaxQ][SC]  C (big)
    uint32_t* csml = cbig + kMaxQ * SC;                    // [kMaxQ][SC]  C (small, float32)
    T* ct = reinterpret_cast<T*>(cbig);                    // [kMaxQ][SC]  C as staged
    unsigned char* ring = reinterpret_cast<unsigned char*>(cbig) + out_c_bytes<T>(d.N);
    uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kTeams * stage_bytes);  // S_in per team
    T* bt = reinterpret_cast<T*>(ring + stage_bytes);     // [kMaxQ][SC]  B, until C B^T is formed

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int team = warp / kWarps, tw = warp % kWarps, ttid = threadIdx.x % kThreads;
    const Item it = block_item(d);
    const int q8 = (d.q + 7) & ~7, qt16 = (d.q + 15) / 16, qt32 = (d.q + 31) / 32;
    const int units = it.nh * slices;
    const bool bulk = d.bulk && it.c > 0;

    const long long bc_off = (it.row0 * d.G + it.grp) * d.N;
    const long long bc_ld = static_cast<long long>(d.G) * d.N;
    if (bulk && threadIdx.x == 0) {
        for (int k = 0; k < kTeams; ++k) mbar_init(&bars[k], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    stage_tile(ct, SC, cm + bc_off, bc_ld, d.q, d.N, kMaxQ, Np, threadIdx.x, kOutThreads);
    stage_tile(bt, SC, bm + bc_off, bc_ld, d.q, d.N, kMaxQ, Np, threadIdx.x, kOutThreads);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // C B^T for the tile's heads: 16 x 32 tiles, K = N
    for (int wt = warp; wt < qt16 * qt32; wt += kTeams * kWarps) {
        const int i0 = (wt % qt16) * 16, j0 = (wt / qt16) * 32;
        float acc[4][4] = {}, part[4][4] = {};
#pragma unroll 2
        for (int k0 = 0; k0 < Np; k0 += 8) {
            uint32_t ab[4], asm_[4];
            split<kF32>(to_float(ct[(i0 + g) * SC + k0 + t]), ab[0], asm_[0]);
            split<kF32>(to_float(ct[(i0 + g + 8) * SC + k0 + t]), ab[1], asm_[1]);
            split<kF32>(to_float(ct[(i0 + g) * SC + k0 + t + 4]), ab[2], asm_[2]);
            split<kF32>(to_float(ct[(i0 + g + 8) * SC + k0 + t + 4]), ab[3], asm_[3]);
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const int j = j0 + 8 * ni + g;
                uint32_t bb[2], bsm[2];
                split<kF32>(to_float(bt[j * SC + k0 + t]), bb[0], bsm[0]);
                split<kF32>(to_float(bt[j * SC + k0 + t + 4]), bb[1], bsm[1]);
                mma_3xtf32<kF32, kF32>(part[ni], ab, asm_, bb, bsm);
            }
            if ((k0 & kPart) == kPart) add_part(acc, part);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int j = j0 + 8 * ni + 2 * t;
            *reinterpret_cast<float2*>(&cb[(i0 + g) * kGS + j]) = make_float2(acc[ni][0], acc[ni][1]);
            *reinterpret_cast<float2*>(&cb[(i0 + g + 8) * kGS + j]) =
                make_float2(acc[ni][2], acc[ni][3]);
        }
    }
    if constexpr (kF32) {  // C into its TF32 halves, once for the tile's heads
        __syncthreads();
        for (int k = threadIdx.x; k < kMaxQ * SC; k += kOutThreads)
            split<true>(__uint_as_float(cbig[k]), cbig[k], csml[k]);
    }
    __syncthreads();  // C B^T and C's halves are in; B's stage is free

    // the team's units: 32 rows x 16 columns of y per warp, two m16 x two n8
    T* xs = reinterpret_cast<T*>(ring + team * stage_bytes);  // [kMaxQ][SX]  xdt slice
    float* sv = reinterpret_cast<float*>(ring + team * stage_bytes + sizeof(T) * kMaxQ * SX);
    float* gs = gss + team * kMaxQ * kGS;
    float* as = ass + team * kMaxQ;
    const float* s_base = states + (static_cast<long long>(it.b) * d.nc + it.c) * d.H *
                                       static_cast<long long>(d.P) * SS;
    const int n_wt = qt32 * (W / 16);  // <= kWarps
    const bool vec2 = (d.P & 1) == 0;
    // team 1 starts once team 0 has its first unit in and its G formed, so the
    // teams' copies alternate rather than coincide
    if (team == 1) asm volatile("bar.sync 3, %0;\n" ::"n"(kOutThreads) : "memory");
    for (int k = 0, u = team; u < units; ++k, u += kTeams) {
        // stage unit u: xdt by cp.async; past chunk 0 the S_in slice, as one TMA
        // bulk copy when slices are whole
        const int h = it.h0 + u / slices, p0 = (u % slices) * W, pw = min(W, d.P - p0);
        const float* ssrc = s_base + (static_cast<long long>(h) * d.P + p0) * SS;
        if (bulk && ttid == 0) {
            mbar_expect_tx(&bars[team], 4u * W * SS);
            bulk_copy(sv, ssrc, 4u * W * SS, &bars[team]);
        }
        stage_tile(xs, SX, xdt + (it.row0 * d.H + h) * d.P + p0,
                   static_cast<long long>(d.H) * d.P, d.q, pw, kMaxQ, W, ttid, kThreads);
        if (it.c > 0 && !bulk) stage_tile(sv, SS, ssrc, SS, pw, Np, W, Np, ttid, kThreads);
        cp_async_commit();
        const float av = ttid < kMaxQ ? load_a(a, d, it, h, ttid) : 0.0f;
        cp_async_wait_all();
        if (bulk) mbar_wait(&bars[team], k & 1);
        if (ttid < kMaxQ) as[ttid] = av;
        team_sync(team);  // unit u is in
        // cs of head h in registers: lane l holds cs[l] (lo) and cs[l + 32] (hi)
        double lo, hi;
        scan64(as, lane, lo, hi);
        {  // G of head h
            const int j = lane + 32 * (tw & 1);
            const double csj = (tw & 1) ? hi : lo;
#pragma unroll
            for (int r = 0; r < kMaxQ / (kWarps / 2); ++r) {
                const int i = (tw >> 1) + (kWarps / 2) * r;  // the same in every lane
                const double csi = __shfl_sync(0xffffffffu, i < 32 ? lo : hi, i & 31);
                if (i < d.q) {
                    float v = 0.0f;
                    if (j <= i) v = cb[i * kGS + j] * expf(static_cast<float>(csi - csj));
                    gs[i * kGS + j] = v;
                }
            }
        }
        team_sync(team);  // G is in
        if (team == 0 && k == 0) asm volatile("bar.arrive 3, %0;\n" ::"n"(kOutThreads) : "memory");
        if (tw < n_wt) {
            const int i0 = (tw % qt32) * 32, pw = (tw / qt32) * 16;
            float acc[4][4] = {}, part[4][4] = {};  // [2 * mi + ni]
            // (C B^T * L) xdt over the steps j < i0 + 32 (G is 0 above the diagonal)
            const int j_end = min(i0 + 32, q8);
#pragma unroll 2
            for (int j0 = 0; j0 < j_end; j0 += 8) {
                const int ja = j0 + t, jb = ja + 4;
                uint32_t ab[2][4], asm_[2][4];
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                    const float* gr = gs + (i0 + 16 * mi + g) * kGS;
                    split<true>(gr[ja], ab[mi][0], asm_[mi][0]);
                    split<true>(gr[8 * kGS + ja], ab[mi][1], asm_[mi][1]);
                    split<true>(gr[jb], ab[mi][2], asm_[mi][2]);
                    split<true>(gr[8 * kGS + jb], ab[mi][3], asm_[mi][3]);
                }
#pragma unroll
                for (int ni = 0; ni < 2; ++ni) {
                    const int p = pw + 8 * ni + g;
                    uint32_t bb[2], bsm[2];
                    split<kF32>(to_float(xs[ja * SX + p]), bb[0], bsm[0]);
                    split<kF32>(to_float(xs[jb * SX + p]), bb[1], bsm[1]);
#pragma unroll
                    for (int mi = 0; mi < 2; ++mi)
                        mma_3xtf32<true, kF32>(part[2 * mi + ni], ab[mi], asm_[mi], bb, bsm);
                }
                if ((j0 & kPart) == kPart || j0 + 8 >= j_end) add_part(acc, part);
            }
            // + diag(exp(cs)) C S_in^T over the N state columns, each part of 4
            // k-steps scaled by exp(cs_i) as it is added
            if (it.c > 0) {
                float e[2][2];
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        const int i = i0 + 16 * mi + g + 8 * r;
                        const double lo_i = __shfl_sync(0xffffffffu, lo, i & 31);
                        const double hi_i = __shfl_sync(0xffffffffu, hi, i & 31);
                        e[mi][r] = expf(static_cast<float>(i < 32 ? lo_i : hi_i));
                    }
#pragma unroll 2
                for (int k0 = 0; k0 < Np; k0 += 8) {
                    uint32_t ab[2][4], asm_[2][4];
#pragma unroll
                    for (int mi = 0; mi < 2; ++mi) {
                        const int r = (i0 + 16 * mi + g) * SC + k0 + t;
                        load_c<T>(cbig, csml, r, ab[mi][0], asm_[mi][0]);
                        load_c<T>(cbig, csml, r + 8 * SC, ab[mi][1], asm_[mi][1]);
                        load_c<T>(cbig, csml, r + 4, ab[mi][2], asm_[mi][2]);
                        load_c<T>(cbig, csml, r + 8 * SC + 4, ab[mi][3], asm_[mi][3]);
                    }
#pragma unroll
                    for (int ni = 0; ni < 2; ++ni) {
                        const float* srow = sv + (pw + 8 * ni + g) * SS + k0;
                        uint32_t bb[2], bsm[2];
                        split<true>(srow[t], bb[0], bsm[0]);
                        split<true>(srow[t + 4], bb[1], bsm[1]);
#pragma unroll
                        for (int mi = 0; mi < 2; ++mi)
                            mma_3xtf32<kF32, true>(part[2 * mi + ni], ab[mi], asm_[mi], bb, bsm);
                    }
                    if ((k0 & kPart) == kPart) add_part_scaled(acc, part, e);
                }
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const int i = i0 + 16 * mi + g + 8 * r;
                    if (i >= d.q) continue;
                    T* yr = y + ((it.row0 + i) * d.H + h) * d.P;
#pragma unroll
                    for (int ni = 0; ni < 2; ++ni) {
                        const int p = p0 + pw + 8 * ni + 2 * t;
                        const float v0 = acc[2 * mi + ni][2 * r], v1 = acc[2 * mi + ni][2 * r + 1];
                        if (vec2 && p + 1 < d.P) {
                            store2(yr + p, v0, v1);
                        } else {
                            if (p < d.P) store1(yr + p, v0);
                            if (p + 1 < d.P) store1(yr + p + 1, v1);
                        }
                    }
                }
        }
        team_sync(team);  // the team is done with its stage, a and G
    }
}

// ------------------------------------------------------------------ host --

// Blocks of `kernel` resident per SM at `smem` bytes (cached for the last size).
template <typename K>
int blocks_per_sm(K kernel, int threads, size_t smem, size_t& cached_smem, int& cached) {
    if (cached_smem != smem) {
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
        int n = 0;
        if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) !=
                cudaSuccess ||
            n < 1)
            n = 1;
        cached = n;
        cached_smem = smem;
    }
    return cached;
}

// Head tile for `hg` heads per group over `items` (batch, chunk, group)
// items: the fewest waves x (the units a team of the block works + 1 for the
// tile's shared staging), then the fewest tiles.
void pick_tile(Dims& d, long long items, int units_per_head, int teams, int slots) {
    const int hg = d.H / d.G;
    long long best = -1;
    for (int tiles = 1; tiles <= hg; ++tiles) {
        const int ht = (hg + tiles - 1) / tiles;
        if ((hg + ht - 1) / ht != tiles) continue;  // the same tiling as a smaller count
        const long long waves = (items * tiles + slots - 1) / slots;
        const long long cost =
            waves * ((static_cast<long long>(ht) * units_per_head + teams - 1) / teams + 1);
        if (best < 0 || cost < best) {
            best = cost;
            d.ht = ht;
            d.tiles = tiles;
        }
    }
}

template <typename T>
cudaError_t launch(const T* xdt, const T* a, const T* bm, const T* cm, T* y, float* fs,
                   float* states, float* decay, int B, int L, int H, int P, int G, int N, int q,
                   cudaStream_t stream) {
    static size_t smem1_cached = 0, smem3_cached = 0;
    static int occ1 = 1, occ3 = 1;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;

    Dims d{B, L, H, P, G, N, q, L / q, 1, 1, 0};
    const long long items = static_cast<long long>(B) * d.nc * G;
    const size_t smem1 = chunk_state_smem<T>(P, N), smem3 = output_smem<T>(P, N);
    const int per_sm1 =
        blocks_per_sm(ssd_chunk_state_kernel<T>, kThreads, smem1, smem1_cached, occ1);
    const int per_sm3 =
        blocks_per_sm(ssd_output_kernel<T>, kOutThreads, smem3, smem3_cached, occ3);

    Dims d1 = d;
    pick_tile(d1, items, 1, 1, sms * per_sm1);
    ssd_chunk_state_kernel<T><<<static_cast<unsigned>(items * d1.tiles), kThreads, smem1,
                                stream>>>(xdt, a, bm, states, decay, d1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    const dim3 grid2(B * H, (P * state_row(N) / 4 + kThreads - 1) / kThreads);
    ssd_state_pass_kernel<<<grid2, kThreads, 0, stream>>>(states, decay, fs, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    Dims d3 = d;
    pick_tile(d3, items, (P + slice_width(P) - 1) / slice_width(P), kTeams, sms * per_sm3);
    d3.bulk = P % slice_width(P) == 0 && (reinterpret_cast<uintptr_t>(states) & 15) == 0;
    ssd_output_kernel<T><<<static_cast<unsigned>(items * d3.tiles), kOutThreads, smem3,
                           stream>>>(
        xdt, a, bm, cm, states, y, d3);
    return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Floats of the chunk-state scratch for these sizes: (B, L / q, H, P) rows of
// state_row(N).
extern "C" long long repro_ssd_scan_states_floats(int B, int L, int H, int P, int N, int q) {
    using namespace repro_torch;
    return static_cast<long long>(B) * (L / q) * H * P * state_row(N);
}

// xdt, y (B, L, H, P); a (B, L, H); bm, cm (B, L, G, N), all contiguous and of
// one type (dtype 0: float32, 1: bfloat16); final_state (B, H, P, N) float32;
// scratch: states (repro_ssd_scan_states_floats floats, 16-byte aligned) and
// decay (B, H, L / q) float32.  q is the chunk (L % q == 0, 1 <= q <= 64);
// P, N <= 128; H % G == 0.
extern "C" int repro_ssd_scan(const void* xdt, const void* a, const void* bm, const void* cm,
                              void* y, float* final_state, float* states, float* decay, int B,
                              int L, int H, int P, int G, int N, int q, int dtype, void* stream) {
    using namespace repro_torch;
    if (B <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || P > kMaxP || N <= 0 ||
        N > kMaxN || q <= 0 || q > kMaxQ || L % q ||
        static_cast<long long>(B) * H > 0x7fffffffLL ||
        static_cast<long long>(B) * (L / q) * H > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return static_cast<int>(launch(
            static_cast<const float*>(xdt), static_cast<const float*>(a),
            static_cast<const float*>(bm), static_cast<const float*>(cm),
            static_cast<float*>(y), final_state, states, decay, B, L, H, P, G, N, q, s));
    if (dtype == 1)
        return static_cast<int>(launch(
            static_cast<const __nv_bfloat16*>(xdt), static_cast<const __nv_bfloat16*>(a),
            static_cast<const __nv_bfloat16*>(bm), static_cast<const __nv_bfloat16*>(cm),
            static_cast<__nv_bfloat16*>(y), final_state, states, decay, B, L, H, P, G, N, q, s));
    return static_cast<int>(cudaErrorInvalidValue);
}
