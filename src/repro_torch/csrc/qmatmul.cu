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
// output tile carries across them.  Here the wide route's tile walks its R
// chunks of 128-byte K slices in a loop; the streaming route's K (<= 64) is
// one slice.  Integer sums are exact, so the result is the same for every R.
// The epilogue converts the sum with __int2float_rn and multiplies by
// __fmul_rn(xs, ws) (no FMA contraction): the plain version's
// acc.float() * (x_scale * w_scale), bit for bit.
//
// What bounds it on an H100: 2 M N K operations against M K + K N bytes of
// codes and 4 M N bytes of float32 output.  Two routes, picked by the
// wrapper (kernels/qmatmul/ops.py:route) from the shape alone; both store
// the output through shared memory with TMA tensor stores (128-byte
// swizzle, so the float2 writes into shared memory are free of bank
// conflicts; clipped at the M and N edges; rows ldo floats apart, ldo a
// multiple of 4, which TMA's 16-byte row strides need):
//
// 1. wide (K or N > 64; granite-8b's (1024, 4096, 4096), 4096^3): bound by
//    the int8 tensor cores, 1979 TOP/s, which only wgmma reaches.  For 8-bit
//    types wgmma takes both operands K-major from shared memory, so w comes
//    as its K-major copy (N, K), made once with the weights by
//    core/streaming_mha.StreamingMHAParams (the float entry point makes it
//    per call).  A persistent block (one per SM) owns 128 x 256 output
//    tiles in turn: one producer thread keeps a 4-stage ring of (128 rows
//    of x, 256 rows of w) x 128-byte K slices in flight by TMA (128-byte
//    swizzle, zeros past M, N and K, so a K of 48 or 130 stays exact), and
//    two consumer warpgroups (64 rows each, 232 registers by setmaxnreg) run
//    wgmma m64n256k32 s8 on the slices as they land and release each stage
//    one slice later.  The K loop alone takes 1.2x the operations bound at
//    (1024, 4096, 4096) (the no_epilogue ablation of
//    tools/qmatmul_variants.py), so the epilogue decides the rest: float
//    pairs stored from registers, each column scale loaded behind a branch,
//    take about as long as the loop.  The scale loads are unconditional
//    (indices clamped), and each warpgroup writes 32 columns at a time into
//    one of two 8 KB shared-memory tiles that one of its threads stores by
//    TMA, while the producer already loads the next tile's slices.  At
//    (1024, 4096, 4096) the 128 tiles are one wave on 132 SMs.  Sharing the
//    w tile between the two blocks of a cluster by TMA multicast (a third
//    less read from L2) measured no faster: L2 does not bound the loop.
// 2. streaming (K <= 64 and N <= 64; the physics encoders' stage 1/4 GEMMs
//    at M ~ 10^5 .. 10^6): at most 32 operations per output byte, bound by
//    the bytes, 80 % of them the float32 output.  A few persistent blocks
//    per SM load w's fragments from the same K-major copy (<= 4 KB, one
//    aligned word each: gathering each fragment's 4 bytes from the (K, N)
//    codes dominated the small calls), hold them and the column scales in
//    registers, and stream 128-row tiles of x through a 4-stage ring of 2-D
//    TMA loads (a tile spans all of K; swizzled 32 or 64 bytes, so that the
//    ldmatrix fragment loads are free of bank conflicts).  mma.sync
//    m16n8k16 s8 computes the tile (well under 1 us at every shape), the
//    epilogue writes it into one of two shared-memory tiles, and one thread
//    stores it by TMA, which overlaps the next tiles' loads and compute.
//
// Contract with the wrapper: x is (M, Kp) and w_kmajor (N, Kp) int8, Kp a
// multiple of 16, zero-padded past the true K; x, w_kmajor and out 16-byte
// aligned and contiguous (out's rows ldo floats apart); xs (M,), ws (N,)
// float32.  The kernels allocate nothing and launch on the caller's stream;
// the C entry returns a CUDA error code.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace repro_torch {
namespace {

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------- helpers --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

// Makes the initialised barriers visible to the TMA unit.
__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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

// One box of a 2-D tensor map (coordinates innermost first) into shared memory.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}

// One box from shared memory to the tensor (clipped at its edges), in the
// issuing thread's bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
    asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
                 ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
                 : "memory");
}
__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of the thread's bulk groups have not read their source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Barrier `id` (1 .. 15) among `threads` threads of the block.
__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// Orders this thread's generic shared-memory writes before later TMA reads.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float dequant(int acc, float xm, float wn) {
    return __fmul_rn(__int2float_rn(acc), __fmul_rn(xm, wn));
}

// ------------------------------------------------------------ wide route --

constexpr int kWideBM = 128, kWideBN = 256, kWideBK = 128;  // tile rows, columns, K bytes
constexpr int kWideStages = 4;
constexpr int kWideThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kWideABytes = kWideBM * kWideBK;  // 16 KB
constexpr int kWideBBytes = kWideBN * kWideBK;  // 32 KB
constexpr int kWideOutBytes = 64 * 128;  // a warpgroup's 64 rows x 32 float32 columns
constexpr int kWideSmem =
    kWideStages * (kWideABytes + kWideBBytes) + 4 * kWideOutBytes + 16 * kWideStages + 1024;

// wgmma shared-memory matrix descriptor of a K-major tile with 128-byte
// rows in the 128-byte swizzle: 1024 bytes between 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // wait until at most N committed groups are in flight
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins the registers an asynchronous wgmma writes in place.
__device__ __forceinline__ void fence_regs(int (&d)[128]) {
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 256, int32) += A (64 x 32 int8) B (32 x 256 int8): both K-major in
// shared memory.
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
        "%125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
          "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
          "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
          "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
          "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
          "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
          "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
          "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]),
          "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]),
          "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]),
          "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
          "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
          "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]),
          "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]),
          "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]),
          "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
          "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]),
          "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]),
          "+r"(d[127])
        : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(kWideThreads, 1)
qmatmul_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap out_map, const float* __restrict__ xs,
                     const float* __restrict__ ws, int M, int N, int Kp, int grid_k) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* sa = align1024(smem_raw);                // [stage][128 rows][128 bytes]
    uint8_t* sb = sa + kWideStages * kWideABytes;     // [stage][256 rows][128 bytes]
    uint8_t* so = sb + kWideStages * kWideBBytes;     // [warpgroup][2][64 rows][128 bytes]
    uint64_t* full = reinterpret_cast<uint64_t*>(so + 4 * kWideOutBytes);
    uint64_t* empty = full + kWideStages;

    const int tiles_m = cdiv(M, kWideBM);
    const int tiles = tiles_m * cdiv(N, kWideBN);
    const int n_slices = cdiv(Kp, kWideBK);
    const int per_chunk = cdiv(n_slices, grid_k);  // K slices per reuse-factor chunk
    if (threadIdx.x == 0) {
        for (int s = 0; s < kWideStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
        }
        fence_barrier_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {  // producer: one thread issues every load
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == 0) {
            int stage = 0;
            uint32_t phase = 0;
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int m0 = (t % tiles_m) * kWideBM, n0 = (t / tiles_m) * kWideBN;
                for (int chunk = 0; chunk < grid_k; ++chunk) {  // the reuse factor's K chunks
                    const int end = min(n_slices, (chunk + 1) * per_chunk);
                    for (int s = chunk * per_chunk; s < end; ++s) {
                        mbar_wait(&empty[stage], phase ^ 1);
                        mbar_expect_tx(&full[stage], kWideABytes + kWideBBytes);
                        tma_load_2d(sa + stage * kWideABytes, &x_map, s * kWideBK, m0,
                                    &full[stage]);
                        tma_load_2d(sb + stage * kWideBBytes, &w_map, s * kWideBK, n0,
                                    &full[stage]);
                        if (++stage == kWideStages) { stage = 0; phase ^= 1; }
                    }
                }
            }
        }
    } else {  // consumers: warpgroup cw computes rows 64 cw .. 64 cw + 63 of the tile
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int cw = wg - 1;
        const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
        const bool issuer = threadIdx.x % 128 == 0;  // issues the warpgroup's output stores
        int stage = 0;
        uint32_t phase = 0;
        int acc[128];
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
            const int m0 = (t % tiles_m) * kWideBM, n0 = (t / tiles_m) * kWideBN;
#pragma unroll
            for (int i = 0; i < 128; ++i) acc[i] = 0;
            int held = -1;  // the stage the last committed wgmma group reads
            for (int chunk = 0; chunk < grid_k; ++chunk) {  // the reuse factor's K chunks
                const int end = min(n_slices, (chunk + 1) * per_chunk);
                for (int s = chunk * per_chunk; s < end; ++s) {
                    mbar_wait(&full[stage], phase);
                    const uint32_t a = smem_u32(sa + stage * kWideABytes + cw * 64 * kWideBK);
                    const uint32_t b = smem_u32(sb + stage * kWideBBytes);
                    fence_regs(acc);
                    wgmma_fence();
#pragma unroll
                    for (int ks = 0; ks < kWideBK / 32; ++ks)  // 32 bytes of K per step
                        wgmma_m64n256k32(acc, sw128_desc(a + 32 * ks), sw128_desc(b + 32 * ks));
                    wgmma_commit();
                    wgmma_wait<1>();  // the previous slice's products are done: release it
                    fence_regs(acc);
                    if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
                    held = stage;
                    if (++stage == kWideStages) { stage = 0; phase ^= 1; }
                }
            }
            wgmma_wait<0>();
            fence_regs(acc);
            if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);

            // Epilogue, 32 columns at a time: each thread writes its float pairs
            // (rows rw and rw + 8 of the warpgroup's 64, columns 2 (lane % 4) +
            // {0, 1} of each 8) into one of the warpgroup's two shared-memory
            // tiles in TMA's 128-byte swizzle, and one thread stores the tile by
            // a TMA tensor store, clipped at the M and N edges.  The scale loads
            // are unconditional (indices clamped), so they issue together.
            const int rw = warp * 16 + lane / 4;
            const int mrow = m0 + cw * 64;
            const int nl = n0 + 2 * (lane % 4);
            float xm[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) xm[h] = __ldg(&xs[min(mrow + rw + 8 * h, M - 1)]);
#pragma unroll
            for (int c = 0; c < kWideBN / 32; ++c) {
                uint8_t* st = so + (2 * cw + c % 2) * kWideOutBytes;
                if (issuer) bulk_wait_read<1>();  // the store from this tile two chunks ago
                named_sync(1 + cw, 128);
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    const int j = 4 * c + jj, n = nl + 8 * j, col = 8 * jj + 2 * (lane % 4);
                    const float w0 = __ldg(&ws[min(n, N - 1)]), w1 = __ldg(&ws[min(n + 1, N - 1)]);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int row = rw + 8 * h;
                        *reinterpret_cast<float2*>(
                            st + row * 128 + ((((col / 4) % 8) ^ (row % 8)) << 4) + (col % 4) * 4) =
                            make_float2(dequant(acc[4 * j + 2 * h], xm[h], w0),
                                        dequant(acc[4 * j + 2 * h + 1], xm[h], w1));
                    }
                }
                fence_proxy_async();
                named_sync(1 + cw, 128);
                if (issuer) {
                    if (n0 + 32 * c < N && mrow < M) tma_store_2d(&out_map, st, n0 + 32 * c, mrow);
                    bulk_commit();
                }
            }
        }
        if (issuer) bulk_wait_all();
    }
}

// ------------------------------------------------------- streaming route --

// KB: bytes of K per x row in shared memory (Kp rounded up to 16, 32 or 64;
// TMA zero-fills past Kp); NB: output columns computed (N rounded up to 16,
// 32 or 64).
template <int KB, int NB>
struct Stream {
    static constexpr int BM = 128;  // rows per tile
    static constexpr int kThreads = 128;  // 4 warps of 32 rows
    static constexpr int kStages = 4;
    static constexpr int KS = KB / 16;  // k16 steps
    static constexpr int NI = NB / 8;   // n8 blocks
    static constexpr int kBoxes = cdiv(NB, 32);  // 32-float (128-byte) output boxes
    static constexpr int kXBytes = BM * KB;
    static constexpr int kOutBytes = kBoxes * BM * 128;
    static constexpr int kSmem = kStages * kXBytes + 2 * kOutBytes + 8 * kStages + 1024;
    static_assert(kXBytes % 1024 == 0 && kOutBytes % 1024 == 0, "1024-byte aligned buffers");

    // Byte offset of (row, 16-byte chunk c) of an x tile in TMA's swizzle:
    // 64-byte rows swizzle 64 (address bits 7-8 into 4-5), 32-byte rows
    // swizzle 32 (bit 7 into 4); 16-byte rows are not swizzled.
    __device__ static int x_offset(int row, int c) {
        if constexpr (KB == 64) return row * 64 + ((c ^ ((row >> 1) & 3)) << 4);
        else if constexpr (KB == 32) return row * 32 + ((c ^ ((row >> 2) & 1)) << 4);
        else return row * 16;
    }
};

__device__ __forceinline__ void mma_k16(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(b));
}

template <int KB, int NB>
__global__ void __launch_bounds__(128)
qmatmul_stream_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap out_map,
                      const int8_t* __restrict__ w_kmajor, const float* __restrict__ xs,
                      const float* __restrict__ ws, int M, int N, int Kp) {
    using S = Stream<KB, NB>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* sx = align1024(smem_raw);            // [stage][128 rows][KB bytes], swizzled
    uint8_t* so = sx + S::kStages * S::kXBytes;   // [2][box][128 rows][128 bytes], swizzled
    uint64_t* full = reinterpret_cast<uint64_t*>(so + 2 * S::kOutBytes);

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
    const int tiles = cdiv(M, S::BM);

    // w's fragments, one aligned word each from the K-major copy (column
    // 8 j + g, K bytes 16 kk + 4 tig .. + 3), and the scales of columns
    // 8 j + 2 tig + {0, 1}; zeros past N and Kp.  The loads are in flight
    // while the block sets up its ring.
    uint32_t b[S::NI][S::KS];
#pragma unroll
    for (int j = 0; j < S::NI; ++j)
#pragma unroll
        for (int kk = 0; kk < S::KS; ++kk) {
            const int n = 8 * j + g, k = 16 * kk + 4 * tig;
            b[j][kk] = n < N && k < Kp ? __ldg(reinterpret_cast<const uint32_t*>(
                                             w_kmajor + static_cast<size_t>(n) * Kp + k))
                                       : 0u;
        }
    float wsc[S::NI][2];
#pragma unroll
    for (int j = 0; j < S::NI; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int n = 8 * j + 2 * tig + e;
            wsc[j][e] = n < N ? __ldg(&ws[n]) : 0.0f;
        }
    if (tid == 0) {
        for (int s = 0; s < S::kStages; ++s) mbar_init(&full[s], 1);
        fence_barrier_init();
        for (int s = 0; s < S::kStages; ++s) {  // the first tiles of this block
            const int t = blockIdx.x + s * gridDim.x;
            if (t >= tiles) break;
            mbar_expect_tx(&full[s], S::kXBytes);
            tma_load_2d(sx + s * S::kXBytes, &x_map, 0, t * S::BM, &full[s]);
        }
    }
    __syncthreads();

    int i = 0;  // this block's tile count
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        const int stage = i % S::kStages, buf = i & 1;
        const int m0 = t * S::BM;
        float xsc[2][2];  // rows 32 warp + 16 mi + g + 8 h
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = m0 + 32 * warp + 16 * mi + g + 8 * h;
                xsc[mi][h] = m < M ? __ldg(&xs[m]) : 0.0f;
            }
        mbar_wait(&full[stage], (i / S::kStages) & 1);

        // A fragments by ldmatrix: matrix q = lane / 8 covers rows + 8 (q & 1),
        // K chunk + (q >> 1); x4 loads two k16 steps.
        uint32_t a[2][S::KS][2];
        const uint8_t* xt = sx + stage * S::kXBytes;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
            const int row = 32 * warp + 16 * mi + (lane % 8) + 8 * ((lane / 8) & 1);
            if constexpr (S::KS == 1) {
                asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                             : "=r"(a[mi][0][0]), "=r"(a[mi][0][1])
                             : "r"(smem_u32(xt + S::x_offset(row, 0))));
            } else {
#pragma unroll
                for (int kk = 0; kk < S::KS; kk += 2) {
                    const int c = kk + (lane / 16);
                    asm volatile(
                        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                        : "=r"(a[mi][kk][0]), "=r"(a[mi][kk][1]), "=r"(a[mi][kk + 1][0]),
                          "=r"(a[mi][kk + 1][1])
                        : "r"(smem_u32(xt + S::x_offset(row, c))));
                }
            }
        }
        int acc[2][S::NI][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int j = 0; j < S::NI; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0;
#pragma unroll
                for (int kk = 0; kk < S::KS; ++kk)
                    mma_k16(acc[mi][j], a[mi][kk][0], a[mi][kk][1], b[j][kk]);
            }

        if (tid == 0) bulk_wait_read<1>();  // tile i - 2's store has read out[buf]
        __syncthreads();  // every warp is done with this x stage; out[buf] is free
        if (tid == 0) {   // refill the stage with this block's tile i + kStages
            const int tn = t + S::kStages * gridDim.x;
            if (tn < tiles) {
                mbar_expect_tx(&full[stage], S::kXBytes);
                tma_load_2d(sx + stage * S::kXBytes, &x_map, 0, tn * S::BM, &full[stage]);
            }
        }

        // Epilogue into out[buf]: box c / 32, row r, 16-byte chunk (c / 4) % 8
        // XOR r % 8 (TMA's 128-byte swizzle); a warp's float2 stores take two
        // wavefronts, the least for 256 bytes.
        uint8_t* ot = so + buf * S::kOutBytes;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = 32 * warp + 16 * mi + g + 8 * h;
#pragma unroll
                for (int j = 0; j < S::NI; ++j) {
                    const int c = 8 * j + 2 * tig;
                    const float2 v = make_float2(dequant(acc[mi][j][2 * h], xsc[mi][h], wsc[j][0]),
                                                 dequant(acc[mi][j][2 * h + 1], xsc[mi][h],
                                                         wsc[j][1]));
                    const int off = (c / 32) * (S::BM * 128) + r * 128 +
                                    ((((c / 4) % 8) ^ (r % 8)) << 4) + (c % 4) * 4;
                    *reinterpret_cast<float2*>(ot + off) = v;
                }
            }
        fence_proxy_async();
        __syncthreads();
        if (tid == 0) {
#pragma unroll
            for (int box = 0; box < S::kBoxes; ++box)
                tma_store_2d(&out_map, ot + box * S::BM * 128, 32 * box, m0);
            bulk_commit();
        }
    }
    if (tid == 0) bulk_wait_all();
}

// ------------------------------------------------------------------- host --

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
    static const EncodeTiledFn fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult status;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) !=
                cudaSuccess ||
            status != cudaDriverEntryPointSuccess) {
            p = nullptr;
        }
        return reinterpret_cast<EncodeTiledFn>(p);
    }();
    return fn;
}

// Map of a row-major (rows, cols) matrix of elem-byte elements, ld elements
// between rows, boxes of box_cols x box_rows, zeros past every edge on loads
// (stores are clipped).
bool encode_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
               int cols, int rows, int ld, int box_cols, int box_rows,
               CUtensorMapSwizzle swizzle) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                               static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t step[2] = {1, 1};
    return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

int sm_count(int dev) {
    static int count[kMaxDevices] = {};
    if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
    return count[dev];
}

// The kernel's dynamic shared-memory opt-in, once per device.
template <class Kernel>
cudaError_t opt_in(Kernel kernel, int smem, int dev, int (&done)[kMaxDevices]) {
    if (done[dev]) return cudaSuccess;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) done[dev] = 1;
    return err;
}

template <int KB, int NB>
cudaError_t launch_stream(int dev, const int8_t* x, const int8_t* w_kmajor, const float* xs,
                          const float* ws, float* out, int M, int N, int ldo, int Kp,
                          cudaStream_t stream) {
    using S = Stream<KB, NB>;
    const auto kernel = qmatmul_stream_kernel<KB, NB>;
    static int opted[kMaxDevices] = {};
    static int per_sm[kMaxDevices] = {};
    cudaError_t err = opt_in(kernel, S::kSmem, dev, opted);
    if (err != cudaSuccess) return err;
    if (per_sm[dev] == 0) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], kernel, S::kThreads,
                                                            S::kSmem);
        if (err != cudaSuccess) return err;
        per_sm[dev] = std::max(1, per_sm[dev]);
    }
    CUtensorMap x_map, out_map;
    const CUtensorMapSwizzle xsw = KB == 64   ? CU_TENSOR_MAP_SWIZZLE_64B
                                   : KB == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                              : CU_TENSOR_MAP_SWIZZLE_NONE;
    if (!encode_2d(&x_map, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Kp, M, Kp, KB, S::BM, xsw) ||
        !encode_2d(&out_map, out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, M, ldo, 32, S::BM,
                   CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorInvalidValue;
    const int grid = std::min(cdiv(M, S::BM), per_sm[dev] * sm_count(dev));
    kernel<<<grid, S::kThreads, S::kSmem, stream>>>(x_map, out_map, w_kmajor, xs, ws, M, N, Kp);
    return cudaGetLastError();
}

template <int KB>
cudaError_t launch_stream_n(int dev, const int8_t* x, const int8_t* w, const float* xs,
                            const float* ws, float* out, int M, int N, int ldo, int Kp,
                            cudaStream_t s) {
    if (N <= 16) return launch_stream<KB, 16>(dev, x, w, xs, ws, out, M, N, ldo, Kp, s);
    if (N <= 32) return launch_stream<KB, 32>(dev, x, w, xs, ws, out, M, N, ldo, Kp, s);
    return launch_stream<KB, 64>(dev, x, w, xs, ws, out, M, N, ldo, Kp, s);
}

int device_index(int* dev) {
    const cudaError_t err = cudaGetDevice(dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    return *dev < kMaxDevices ? 0 : static_cast<int>(cudaErrorInvalidDevice);
}

}  // namespace
}  // namespace repro_torch

// Both routes: x (M, Kp), w_kmajor (N, Kp) int8, Kp a multiple of 16; xs
// (M,), ws (N,) float32; out (M, N) float32 with ldo (a multiple of 4, >= N)
// floats between rows; x, w_kmajor and out 16-byte aligned.  The wide
// route walks K in grid_k chunks; the streaming route takes Kp <= 64 and
// N <= 64.
extern "C" int repro_qmatmul(int route_wide, const int8_t* x, const int8_t* w_kmajor,
                             const float* xs, const float* ws, float* out, int M, int N, int ldo,
                             int Kp, int grid_k, void* stream) {
    using namespace repro_torch;
    if (M <= 0 || N <= 0 || ldo < N || ldo % 4 || Kp <= 0 || Kp % 16 || grid_k < 1 ||
        (!route_wide && (Kp > 64 || N > 64)))
        return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0;
    int err = device_index(&dev);
    if (err) return err;
    auto s = static_cast<cudaStream_t>(stream);
    const int8_t* w = w_kmajor;
    if (!route_wide) {
        if (Kp <= 16) return launch_stream_n<16>(dev, x, w, xs, ws, out, M, N, ldo, Kp, s);
        if (Kp <= 32) return launch_stream_n<32>(dev, x, w, xs, ws, out, M, N, ldo, Kp, s);
        return launch_stream_n<64>(dev, x, w, xs, ws, out, M, N, ldo, Kp, s);
    }
    static int opted[kMaxDevices] = {};
    err = opt_in(qmatmul_wgmma_kernel, kWideSmem, dev, opted);
    if (err) return err;
    CUtensorMap x_map, w_map, out_map;
    if (!encode_2d(&x_map, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Kp, M, Kp, kWideBK, kWideBM,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode_2d(&w_map, w_kmajor, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Kp, N, Kp, kWideBK,
                   kWideBN, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode_2d(&out_map, out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, M, ldo, 32, 64,
                   CU_TENSOR_MAP_SWIZZLE_128B))
        return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = cdiv(M, kWideBM) * cdiv(N, kWideBN);
    const int grid = std::min(tiles, sm_count(dev));  // persistent: one block per SM
    qmatmul_wgmma_kernel<<<grid, kWideThreads, kWideSmem, s>>>(x_map, w_map, out_map, xs, ws, M,
                                                               N, Kp, grid_k);
    return static_cast<int>(cudaGetLastError());
}
