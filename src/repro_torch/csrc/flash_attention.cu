// Fused attention for Hopper (sm_90a): softmax(Q K^T / sqrt(d)) V under a
// padding / causal / sliding-window mask, with the safe (online max/sum)
// softmax or the paper's LUT softmax.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:
//   flash_attention_pallas (kernel body _make_kernel), and the GQA repeat of
//   src/repro/kernels/flash_attention/ops.py:mha.
//
// What bounds it on an H100: the work is 4 Lq Lkv D FLOP per (batch, head)
// (half that under a causal mask) against 4 L D bytes per element of
// q/k/v/out, i.e. about L/4 FLOP per byte in float32 and L/2 in bf16.  The
// physics shapes (head_dim 8; L = 15, 50, 100) are bound by bytes once the
// arithmetic is on the tensor cores (at gw, 10.5 GFLOP of float32 work is
// 0.157 ms on the CUDA cores' 67 TFLOP/s, above the 0.125 ms bytes bound;
// 0.064 ms as three TF32 products at 495 / 3 = 165 TFLOP/s).  The LM-like
// shapes (D = 64, 128; L = 1024, 2048) are bound by operations: 989 TFLOP/s
// in bf16, 165 TFLOP/s of float32 work done as 3xTF32.  Both kernels keep
// every score and output element in the m16n8 accumulator fragment layout
// of mma (thread lane: rows lane/4 and lane/4 + 8, columns 2 (lane % 4) +
// {0, 1} of each 8-wide block), and run float32 as 3xTF32 on
// mma.sync.m16n8k8.tf32: each operand is split into big, its nearest TF32
// value, and small, the TF32 rest (kernel 2: cvt.rna.tf32 twice; kernel 1:
// Veltkamp's split), and the float32 accumulator takes small*big +
// big*small + big*big.  One TF32 product keeps 10 mantissa bits
// (1e-3 off against the 2e-5 tolerance at every shape tried); three keep
// float32's accuracy.  In the P V product the k order of an 8-key step is
// permuted (k index t <-> key 2t, t + 4 <-> key 2t + 1) so the score
// fragment is the A fragment with no shuffle.  Two kernels, by head_dim:
//
// 1. D = 8, 16, 32 (the physics encoders; head_dims 12 and 14 padded to
//    16): small_attention_kernel.  A work item is (batch * head, 16 query
//    rows), one m16 tile, and a warp owns one item; a group is W = 4 or 8
//    consecutive items, so heads are packed: at L = 15 a group serves 8
//    heads, at L = 100 the 7 tiles of a head (straddling two heads).  The
//    only idle rows are those past Lq in a head's last tile.  Blocks are
//    persistent (as many as fit on the SMs) and walk their groups' key tiles
//    as one stream of steps through a two-stage shared-memory ring: K and V
//    of each key/value head a group uses, staged once for the group, in
//    tiles of 8 NB keys (NB = 2 at L <= 16, 7 at L = 50 and 100 in
//    float32, else 8), and the group's query rows, all by 16-byte
//    cp.async copies that zero-fill past the keys and past Lq (4- or 2-byte
//    copies through registers when a pointer is not 16-byte aligned).  The
//    next step's copies are in flight while this one is computed, across
//    groups.  Rows are padded so every fragment load is free of bank
//    conflicts.  float32: S = Q K^T takes four TF32 products (small * small
//    too, so that the paper's fixed-point scores are exact) and P V three;
//    no conversion instruction splits an operand: Q (once per item) and P
//    by Veltkamp's method, four FP32 operations, K and V by truncation, an
//    AND and a subtraction, per warp as it loads them (splitting K and V
//    once per block in shared memory measured slower:
//    tools/attention_small_variants.py).
//    bf16: S on m16n8k8 (D = 8) or m16n8k16, P rounded to bf16 and O += P V
//    on m16n8k16 with V's fragments by ldmatrix.trans; float32
//    accumulators.  The online softmax runs on the fragments: a row's max
//    over its 4 lanes with two shuffles, its sum once at the end; safe mode
//    as ex2 with log2(e) folded into the scale.  Every 8-key block of a tile
//    is computed without a branch (so the compiler interleaves the blocks'
//    mma chains); a warp skips the tiles its rows cannot see, and element
//    masks are evaluated only on tiles that cross the diagonal, the window
//    edge or kv_len.  LUT mode: the table index without a division or a
//    conversion (lut.cuh: lut_index_linear_fast), the table in shared
//    memory.  Integer division by runtime sizes goes through a
//    multiply-high (FastDiv).
//
// 2. D = 64, 128 (LM heads; the streaming MHA at granite-8b's width):
//    tc_attention_kernel.  A block owns 64 query rows and holds one or two
//    consumer warpgroups (4 warps, 128 threads each); warp w of a warpgroup
//    owns rows 16w .. 16w + 15:
//    - bf16: S = Q K^T is wgmma.mma_async m64n64k16 with Q and K both read
//      from shared memory, K-major (D contiguous), 128-byte swizzled.  The
//      online softmax runs on the accumulator fragments (a row's max is
//      combined over the 4 threads that share it with two shuffles; its sum
//      only once, at the end).  P is rounded to bf16 in registers and is
//      the register A operand of P V (m64nDk16); the V tile (keys x D, D
//      contiguous) is the shared-memory B operand with the transpose bit.
//      S of the next tile and P V of this one are issued back to back, and
//      the next tile's softmax runs while P V is on the tensor cores.
//    - float32: 3xTF32 on mma.sync for Q K^T and P V, not on wgmma: TF32 wgmma takes only K-major operands, so V
//      would have to be written back transposed into shared memory each
//      tile, and the split operands would have to be stored there too;
//      mma.sync takes its fragments from registers, split on the way in.
//      This route is bound by the splits and fragment loads on the CUDA
//      cores (about 4 instructions per mma), not by the tensor cores.
//    K/V tiles (64 keys in bf16, 32 in float32) come through a ring of two
//    stages per warpgroup in dynamic shared memory, filled by TMA
//    (cp.async.bulk.tensor, 3-D maps over (D, L, batch * heads), 128-byte
//    swizzle) and tracked by mbarriers: the copy of a warpgroup's next tile
//    is in flight while it computes this one.  Reads past L are TMA's zero
//    fill, so no length need be a multiple of a tile.  The swizzle also
//    makes the float32 fragment loads free of bank conflicts.  A block walks
//    only the key tiles its rows can see; element masks are evaluated only
//    on tiles that cross the diagonal, the window edge or the end of
//    kv_len.  Grid balance: the grid is 1-D with the longest causal query
//    tiles first, and under a causal mask a call takes as long as its
//    longest block.  At (1, 8, 1024, D) the 128 blocks (8 heads x 16 query
//    tiles) leave 4 of 132 SMs idle and the last tile walks all 16 key
//    tiles of 64, so a block there takes two warpgroups that split its key
//    tiles (tile j to warpgroup j % 2) and merge their rows' (max, sum,
//    output) through shared memory at the end: the longest walk halves.  A
//    bf16 grid with more blocks than SMs takes one warpgroup, whose smaller
//    ring fits two blocks per SM; float32 always takes two.
//
// Both kernels: GQA maps query head h to key/value head h / (Hq / Hkv) by
// index; K/V are never repeated in memory.  LUT mode: exp from the
// 1024-entry linear table in shared memory (its gathers diverge), indexed
// on the float32 score itself, running row sum without max subtraction,
// reciprocal from the 4096-entry log table at the end.
//
// The kernels allocate nothing and launch on the caller's stream; the C
// entry returns cudaGetLastError() (or cudaErrorInvalidValue when a tensor
// map cannot be encoded: at D = 64 / 128 a pointer that is not 16-byte
// aligned).

#include <algorithm>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lut.cuh"

namespace repro_torch {
namespace {

constexpr int kExpSize = 1024;
constexpr int kInvSize = 4096;

// ------------------------------------------------------------------------
// Tensor-core path, D = 64 and 128.

constexpr int kTcRows = 64;  // query rows per block
constexpr float kLog2e = 1.4426950408889634f;

// G consumer warpgroups per block share its 64 query rows and split the key
// tiles between them (tile j to warpgroup j % G); two ring stages each.
template <typename T, int D, int G>
struct TcTile {
    static constexpr int kThreads = 128 * G;
    static constexpr int kStages = 2 * G;  // the bf16 loop waits for tile j + G before it
                                           // releases tile j: two stages per warpgroup
    static constexpr bool kBf16 = sizeof(T) == 2;
    static constexpr int kBN = kBf16 ? 64 : 32;       // keys per K/V tile
    static constexpr int kNB = kBN / 8;               // 8-key blocks per tile
    static constexpr int kBoxCols = 128 / sizeof(T);  // columns of one 128-byte swizzled box
    static constexpr int kBoxes = D / kBoxCols;
    static constexpr int kQBytes = kTcRows * D * sizeof(T);
    static constexpr int kKVBytes = kBN * D * sizeof(T);  // one K (or V) tile
    static constexpr int kExpBytes = kExpSize * 4;
    static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes + kExpBytes;
    static_assert((D / 2 + 4) * 128 * 4 <= 2 * kStages * kKVBytes, "merge fits in the ring");
    // + 1024 for aligning the base to the 1024-byte swizzle period
    static constexpr int kSmemBytes = kBarOffset + 8 * (1 + kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// One box of a 3-D tensor map (coordinates innermost first) into shared memory.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle, 1024 bytes (8 rows
// of 128 bytes) between 8-row groups.  K-major tiles leave lbo unused;
// MN-major (the V tile as the B operand of P V): lbo = distance between
// 64-column boxes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
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
// Pins registers that an asynchronous wgmma reads or writes in place.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

// D (64 x 64, float32) += A B: A (64 x 16) and B (16 x 64, K-major) from shared memory.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N) += A B: A (64 x 16 bf16) from registers, B (16 x N) from shared
// memory, transposed (N contiguous).
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
    return *reinterpret_cast<const uint32_t*>(&v);
}

// big = rna(x) and small = rna(x - big) in TF32 (10 mantissa bits).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
    const float rest = x - __uint_as_float(big);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in float32 accuracy: small terms first, then big * big.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
    mma_tf32(c, as, bb0, bb1);
    mma_tf32(c, ab, bs0, bs1);
    mma_tf32(c, ab, bb0, bb1);
}

// Float index of (row, col) in a float32 tile of ROWS rows stored as boxes of
// 32 columns (128 bytes), each 128-byte row's 16-byte chunks XOR-swizzled by
// row % 8 (TMA's 128-byte swizzle).
template <int ROWS>
__device__ __forceinline__ int swz_f32(int row, int col) {
    return (col >> 5) * (ROWS * 32) + row * 32 + ((((col >> 2) & 7) ^ (row & 7)) << 2) + (col & 3);
}

// Issues S (64 x 64 keys) = Q K^T on wgmma into s (accumulator fragment layout).
template <int D>
__device__ __forceinline__ void issue_scores_bf16(float (&s)[32], uint32_t q_addr,
                                                  uint32_t k_addr) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {  // 4 k16 steps per 128-byte box
        const uint32_t box = ks / 4, within = (ks % 4) * 32;
        wgmma_ss_m64n64(s, sw128_desc(q_addr + box * (kTcRows * 128) + within, 0),
                        sw128_desc(k_addr + box * (64 * 128) + within, 0), ks > 0);
    }
}

template <int D>
__device__ __forceinline__ void scores_bf16(float (&s)[32], uint32_t q_addr, uint32_t k_addr) {
    fence_regs(s);
    wgmma_fence();
    issue_scores_bf16<D>(s, q_addr, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
}

// P (bf16) as the register A operand of P V: k16 step kk covers the 8-key
// blocks 2 kk and 2 kk + 1, i.e. p[8 kk .. 8 kk + 7].
__device__ __forceinline__ void pack_p(uint32_t (&a)[4][4], const float (&p)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
    }
}

// Issues O (64 x D) += P V on wgmma: P from registers, V (keys x D, D
// contiguous) from shared memory as the transposed B operand.
template <int D>
__device__ __forceinline__ void issue_pv_bf16(float (&o)[D / 2], const uint32_t (&a)[4][4],
                                              uint32_t v_addr) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys = 16 rows of 128 bytes per step
        const uint64_t desc = sw128_desc(v_addr + kk * 16 * 128, 64 * 128);
        if constexpr (D == 128) {
            wgmma_rs_m64n128(o, a[kk], desc);
        } else {
            wgmma_rs_m64n64(o, a[kk], desc);
        }
    }
}

// S (64 x 32 keys) = Q K^T in 3xTF32; warp rows r0 and r0 + 8.  Even and
// odd 8-column steps go to two accumulators (8 independent mma chains, not
// 4).  The step loop is unrolled fully at D = 64 and by 2 at D = 128, which
// keeps that path under 255 registers without spills.
template <int D>
__device__ __forceinline__ void scores_f32(float (&s)[16], const float* sq, const float* sk,
                                           int r0, int g, int tig) {
    constexpr int kUnroll = D <= 64 ? D / 16 : 2;
    float s1[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = s1[i] = 0.0f;
#pragma unroll kUnroll
    for (int kp = 0; kp < D / 16; ++kp) {
        __syncwarp();  // bounds how far the loads of later steps are hoisted
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            float* acc = half ? s1 : s;
            const int c0 = 16 * kp + 8 * half + tig, c1 = c0 + 4;
            uint32_t ab[4], as[4];
            split_tf32(sq[swz_f32<kTcRows>(r0, c0)], ab[0], as[0]);
            split_tf32(sq[swz_f32<kTcRows>(r0 + 8, c0)], ab[1], as[1]);
            split_tf32(sq[swz_f32<kTcRows>(r0, c1)], ab[2], as[2]);
            split_tf32(sq[swz_f32<kTcRows>(r0 + 8, c1)], ab[3], as[3]);
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) {
                uint32_t bb0, bs0, bb1, bs1;
                split_tf32(sk[swz_f32<32>(8 * nb + g, c0)], bb0, bs0);
                split_tf32(sk[swz_f32<32>(8 * nb + g, c1)], bb1, bs1);
                mma_3xtf32(&acc[4 * nb], ab, as, bb0, bb1, bs0, bs1);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] += s1[i];
}

// O (64 x D) += P V in 3xTF32.  The k index t of an 8-key step is key 2t
// for t < 4 and key 2(t - 4) + 1 above, so P's fragment is the A operand.
template <int D>
__device__ __forceinline__ void pv_f32(float (&o)[D / 2], const float (&p)[16], const float* sv,
                                       int g, int tig) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        uint32_t ab[4], as[4];
        split_tf32(p[4 * kk + 0], ab[0], as[0]);
        split_tf32(p[4 * kk + 2], ab[1], as[1]);
        split_tf32(p[4 * kk + 1], ab[2], as[2]);
        split_tf32(p[4 * kk + 3], ab[3], as[3]);
#pragma unroll
        for (int nb = 0; nb < D / 8; ++nb) {
            uint32_t bb0, bs0, bb1, bs1;
            split_tf32(sv[swz_f32<32>(8 * kk + 2 * tig, 8 * nb + g)], bb0, bs0);
            split_tf32(sv[swz_f32<32>(8 * kk + 2 * tig + 1, 8 * nb + g)], bb1, bs1);
            mma_3xtf32(&o[4 * nb], ab, as, bb0, bb1, bs0, bs1);
        }
    }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------------------
// Small-head path, D = 8, 16 and 32.

constexpr int kSmRows = 16;  // query rows per warp: one m16 tile
constexpr int kSmMaxNB = 8;  // 8-key blocks per staged K/V tile, at most
constexpr int kSmStages = 2;  // the copy ring: one step copied while one is computed

template <typename T, int D>
struct SmTile {
    // Row stride of a staged K/V tile, in elements.  float32: D + 4 words, so
    // the 8 key rows of a fragment load start in 8 different 4-bank groups.
    // bf16: an odd number of 16-byte units, so ldmatrix's 8 rows fall in 8
    // different bank groups (and the 32-bit K loads are conflict-free too).
    static constexpr bool kBf16 = sizeof(T) == 2;
    static constexpr int kStride = kBf16 ? 8 * ((D / 8) | 1) : D + 4;
    static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
};

// The A fragments of a warp's 16 query rows, loaded once per item.
// float32: per 8-dim step, big and small TF32 halves.  bf16: per 16-dim
// step (D = 8: registers 0 and 1 only, for m16n8k8).
template <typename T, int D>
struct QFrag;
template <int D>
struct QFrag<float, D> {
    uint32_t big[D / 8][4], small[D / 8][4];
};
template <int D>
struct QFrag<__nv_bfloat16, D> {
    uint32_t a[(D + 15) / 16][4];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // wait until at most N committed groups are in flight
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(b0), "=r"(b1)
                 : "r"(smem_u32(p))
                 : "memory");
}

__device__ __forceinline__ void mma_bf16_k16(float* c, const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16_k8(float* c, uint32_t a0, uint32_t a1, uint32_t b0) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(b0));
}

// x = big + small: big rounded to the nearest TF32 value (11 significant
// bits, Veltkamp's split by 2^13 + 1), small = x - big exactly.  The
// tensor cores read the top 19 bits of a TF32 register, so small is used
// truncated to 11 bits: 2^-23 |x| at most.  Four FP32 operations.
__device__ __forceinline__ void split_fast(float x, uint32_t& big, uint32_t& small) {
    const float t = __fmul_rn(x, 8193.0f);
    const float b = __fsub_rn(t, __fsub_rn(t, x));
    big = __float_as_uint(b);
    small = __float_as_uint(__fsub_rn(x, b));
}

// x = big + small with big = x truncated to TF32 (one AND) and small the
// exact rest, read truncated to 11 bits: 2^-22 |x| at most, and exact for
// x of at most 22 significant bits.  For K and V, loaded once per block of
// 8 keys; P, whose products set the output's last bits, takes split_fast.
__device__ __forceinline__ void split_trunc(float x, uint32_t& big, uint32_t& small) {
    big = __float_as_uint(x) & 0xffffe000u;
    small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));
}

// The A fragments of rows g and g + 8 of a warp's 16 query rows, staged
// at sq with row stride kStride.
template <int D>
__device__ __forceinline__ void load_q(QFrag<float, D>& f, const float* sq, int g, int tig) {
    constexpr int S = SmTile<float, D>::kStride;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
        const int c = 8 * ks + tig;
        const float x[4] = {sq[g * S + c], sq[(g + 8) * S + c], sq[g * S + c + 4],
                            sq[(g + 8) * S + c + 4]};
#pragma unroll
        for (int r = 0; r < 4; ++r) split_fast(x[r], f.big[ks][r], f.small[ks][r]);
    }
}

template <int D>
__device__ __forceinline__ void load_q(QFrag<__nv_bfloat16, D>& f, const __nv_bfloat16* sq, int g,
                                       int tig) {
    constexpr int S = SmTile<__nv_bfloat16, D>::kStride;
    auto pair = [&](int row, int col) {
        return *reinterpret_cast<const uint32_t*>(sq + row * S + col);
    };
#pragma unroll
    for (int ks = 0; ks < (D + 15) / 16; ++ks) {
        const int c = 16 * ks + 2 * tig;
        f.a[ks][0] = pair(g, c);
        f.a[ks][1] = pair(g + 8, c);
        if constexpr (D >= 16) {
            f.a[ks][2] = pair(g, c + 8);
            f.a[ks][3] = pair(g + 8, c + 8);
        }
    }
}

// c (16 rows x 8 keys) = Q K^T for the 8 keys whose rows start at sk.
// float32: four TF32 products, small * small too, so that each product of
// operands of at most 22 significant bits (the paper's ap_fixed<12, 6>
// activations have 12) is formed exactly, as in the plain version: three
// products miss up to 2^-12 of a score there, which moves LUT indices.
template <int D>
__device__ __forceinline__ void block_scores(float* c, const QFrag<float, D>& f, const float* sk,
                                             int g, int tig) {
    constexpr int S = SmTile<float, D>::kStride;
    c[0] = c[1] = c[2] = c[3] = 0.0f;
    const float* kr = sk + g * S + tig;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
        uint32_t bb0, bs0, bb1, bs1;
        split_trunc(kr[8 * ks], bb0, bs0);
        split_trunc(kr[8 * ks + 4], bb1, bs1);
        mma_tf32(c, f.small[ks], bs0, bs1);
        mma_tf32(c, f.small[ks], bb0, bb1);
        mma_tf32(c, f.big[ks], bs0, bs1);
        mma_tf32(c, f.big[ks], bb0, bb1);
    }
}

template <int D>
__device__ __forceinline__ void block_scores(float* c, const QFrag<__nv_bfloat16, D>& f,
                                             const __nv_bfloat16* sk, int g, int tig) {
    constexpr int S = SmTile<__nv_bfloat16, D>::kStride;
    c[0] = c[1] = c[2] = c[3] = 0.0f;
    const __nv_bfloat16* kr = sk + g * S + 2 * tig;
    if constexpr (D == 8) {
        mma_bf16_k8(c, f.a[0][0], f.a[0][1], *reinterpret_cast<const uint32_t*>(kr));
    } else {
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
            mma_bf16_k16(c, f.a[ks], *reinterpret_cast<const uint32_t*>(kr + 16 * ks),
                         *reinterpret_cast<const uint32_t*>(kr + 16 * ks + 8));
        }
    }
}

// o (16 rows x D) += P V for the 8 keys (float32) whose rows start at sv;
// p: their 4 weights in this thread's fragment.
template <int D>
__device__ __forceinline__ void block_pv(float* o, const float* p, const float* sv, int g,
                                         int tig) {
    constexpr int S = SmTile<float, D>::kStride;
    uint32_t ab[4], as[4];
    split_fast(p[0], ab[0], as[0]);
    split_fast(p[2], ab[1], as[1]);
    split_fast(p[1], ab[2], as[2]);
    split_fast(p[3], ab[3], as[3]);
    const float* vr = sv + 2 * tig * S + g;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
        uint32_t bb0, bs0, bb1, bs1;
        split_trunc(vr[8 * nb], bb0, bs0);
        split_trunc(vr[S + 8 * nb], bb1, bs1);
        mma_3xtf32(&o[4 * nb], ab, as, bb0, bb1, bs0, bs1);
    }
}

// o += P V for the 16 keys (bf16) whose rows start at sv; p: the 8 weights
// of their two 8-key blocks, rounded to bf16 as the A operand.
template <int D>
__device__ __forceinline__ void pair_pv(float* o, const float* p, const __nv_bfloat16* sv,
                                        int lane) {
    constexpr int S = SmTile<__nv_bfloat16, D>::kStride;
    const uint32_t a[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]), pack_bf16(p[4], p[5]),
                           pack_bf16(p[6], p[7])};
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, sv + (lane & 15) * S + 8 * nb);
        mma_bf16_k16(&o[4 * nb], a, b0, b1);
    }
}

__device__ __forceinline__ float ex2_approx(float x) {  // 2^x; 0 for -inf
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (Granlund and
// Montgomery), d >= 1 fixed per kernel: a runtime integer division is some
// 20 instructions.
struct FastDiv {
    uint32_t mul, shift;
    __device__ explicit FastDiv(uint32_t d) : shift(0) {
        while ((1u << shift) < d) ++shift;
        mul = static_cast<uint32_t>(((1ull << 32) * ((1ull << shift) - d)) / d + 1);
    }
    __device__ __forceinline__ int operator()(int n) const {
        return static_cast<int>((__umulhi(static_cast<uint32_t>(n), mul) + n) >> shift);
    }
};

// A group: W consecutive items, one per warp, and the keys any of them
// sees.  Lane i of every warp also holds item it0 + i's fields (i < n).
struct SmGroup {
    int it0, n;         // items [it0, it0 + n)
    int lo, hi;         // keys [lo, hi): the union of the items' ranges
    int n_tiles;        // key tiles, at least 1
    int hkv0, n_slots;  // first key/value head, and how many the items use
    int bh, q0, ilo, ihi, hkv;  // lane i's item: head, first row, keys, key/value head
};

// Persistent blocks of W warps; block b takes groups b, b + gridDim.x, ...
// and walks their key tiles as one stream of steps through a ring of two
// shared-memory stages: step s + 1 (K and V of every slot for one tile and,
// on a group's first tile, its 16 query rows per warp) is copied by
// cp.async while step s is computed, across group boundaries.  Every 8-key
// block of a tile is computed without a branch, so the compiler interleaves
// the blocks' mma chains; P V goes to two accumulators for the same reason.
// Dynamic shared memory: the exp table (LUT mode), two query buffers, two
// K/V stages of `slots` x (K, V) x 8 NB keys.
template <typename T, int D, int NB, int W, bool ALIGNED>
__global__ void __launch_bounds__(32 * W, 16 / W)
small_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       const float* __restrict__ exp_tab, const float* __restrict__ inv_tab,
                       int BHq, int Hq, int Hkv, int Lq, int Lkv, int kv_len, int causal,
                       int window, int lut_mode, float scale, float exp_off, float exp_step,
                       float inv_off, float inv_step, int slots) {
    using C = SmTile<T, D>;
    static_assert(!C::kBf16 || NB % 2 == 0, "bf16 P V takes 16 keys per step");
    constexpr int S = C::kStride;
    constexpr int kRows = 8 * NB;  // keys per staged tile
    constexpr int kThreads = 32 * W;
    constexpr int kQElems = W * kSmRows * S;  // one query buffer
    constexpr int kPerRow = ALIGNED ? D / C::kVec : D;  // copies per row
    constexpr int kCopy = ALIGNED ? C::kVec : 1;        // elements per copy
    extern __shared__ float4 sm_raw[];  // 16-byte aligned
    float* s_exp = reinterpret_cast<float*>(sm_raw);
    T* qbuf = reinterpret_cast<T*>(s_exp + (lut_mode ? kExpSize : 0));
    T* ring = qbuf + kSmStages * kQElems;
    const int stage_elems = slots * 2 * kRows * S;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
    const int nqt = (Lq + kSmRows - 1) / kSmRows;
    const int n_items = BHq * nqt;
    const int n_groups = (n_items + W - 1) / W;
    const int kv_end = min(kv_len, Lkv);
    const FastDiv div_nqt(nqt), div_hq(Hq), div_group(Hq / Hkv);
    const float sc = lut_mode ? scale : scale * kLog2e;  // LUT indexes the score itself
    const float exp_inv_step = 1.0f / exp_step;
    if (lut_mode) {
        for (int i = tid; i < kExpSize; i += kThreads) s_exp[i] = __ldg(&exp_tab[i]);
    }  // read only after the first step's __syncthreads
    if (blockIdx.x >= n_groups) return;

    // Called by whole warps.  Item -> (batch * head, first query row, keys
    // [lo, hi) its rows can see); under a causal mask a head's longest query
    // tiles come first.  GQA: query head h reads key/value head h / (Hq / Hkv).
    auto group_info = [&](int grp, SmGroup& gi) {
        gi.it0 = grp * W;
        gi.n = min(W, n_items - gi.it0);
        const int item = gi.it0 + min(lane, gi.n - 1);
        gi.bh = div_nqt(item);
        const int r = item - gi.bh * nqt;
        gi.q0 = (causal ? nqt - 1 - r : r) * kSmRows;
        gi.ihi = causal ? min(kv_end, min(gi.q0 + kSmRows, Lq)) : kv_end;
        gi.ilo = window > 0 ? max(0, gi.q0 - window + 1) : 0;
        const int b = div_hq(gi.bh);
        gi.hkv = b * Hkv + div_group(gi.bh - b * Hq);
        const bool seen = gi.ihi > gi.ilo;
        int lo = __reduce_min_sync(0xffffffffu, seen ? gi.ilo : 0x7fffffff);
        int hi = __reduce_max_sync(0xffffffffu, seen ? gi.ihi : 0);
        if (hi <= lo) lo = hi = 0;  // no key visible: one empty step, zero output
        gi.lo = lo;
        gi.hi = hi;
        gi.n_tiles = max(1, (hi - lo + kRows - 1) / kRows);
        gi.hkv0 = __shfl_sync(0xffffffffu, gi.hkv, 0);
        gi.n_slots = __shfl_sync(0xffffffffu, gi.hkv, gi.n - 1) - gi.hkv0 + 1;  // <= slots
    };
    auto copy = [&](T* dst, const T* src, bool in) {  // zeros where !in
        if constexpr (ALIGNED) {
            cp_async16(dst, src, in ? 16 : 0);
        } else {
            *dst = in ? *src : T(0.0f);
        }
    };
    // One step's copies: tile `tile` of group gi into K/V stage `st` and, on
    // its first tile, each warp its item's query rows into query buffer `qs`;
    // zeros past the group's keys and past Lq.
    auto issue = [&](const SmGroup& gi, int tile, int qs, int st) {
        if (tile == 0) {
            const int bh_w = __shfl_sync(0xffffffffu, gi.bh, warp);
            const int q0_w = __shfl_sync(0xffffffffu, gi.q0, warp);
            T* dq = qbuf + qs * kQElems + warp * kSmRows * S;
            for (int i = lane; i < kSmRows * kPerRow && warp < gi.n; i += 32) {
                const int c = i % kPerRow, row = i / kPerRow;
                const bool in = q0_w + row < Lq;
                const T* src = q + (static_cast<long long>(bh_w) * Lq + (in ? q0_w + row : 0)) * D;
                copy(dq + row * S + c * kCopy, src + c * kCopy, in);
            }
        }
        T* dst0 = ring + st * stage_elems;
        const int t0 = gi.lo + tile * kRows;
        const int n = gi.n_slots * 2 * kRows * kPerRow;
        for (int i = tid; i < n; i += kThreads) {
            const int c = i % kPerRow, r = i / kPerRow;  // r = (slot * 2 + K|V) * kRows + key
            const int key = r % kRows, sv = r / kRows;
            const int kpos = t0 + key;
            const bool in = kpos < gi.hi;
            const T* src = ((sv & 1) ? v : k) +
                           (static_cast<long long>(gi.hkv0 + (sv >> 1)) * Lkv + (in ? kpos : 0)) * D;
            copy(dst0 + r * S + c * kCopy, src + c * kCopy, in);
        }
    };

    // Producer cursor: the next step to copy.
    SmGroup gp;
    int grp_p = blockIdx.x, tile_p = 0, gq_p = 0;
    bool more_p = true;
    group_info(grp_p, gp);
    auto produce = [&](int st) {
        if (more_p) {
            issue(gp, tile_p, gq_p % kSmStages, st);
            if (++tile_p == gp.n_tiles) {
                tile_p = 0;
                ++gq_p;
                grp_p += gridDim.x;
                more_p = grp_p < n_groups;
                if (more_p) group_info(grp_p, gp);
            }
        }
        cp_async_commit();  // one group per step, empty or not
    };
    produce(0);

    // Consumer cursor, and this warp's item.
    SmGroup gc;
    group_info(blockIdx.x, gc);
    int grp_c = blockIdx.x, tile_c = 0, gq_c = 0;
    bool active = false;
    int bh = 0, q0 = 0, lo_w = 0, hi_w = 0, slot = 0, q_last = 0;
    QFrag<T, D> qf;
    constexpr int kAcc = 2;  // P V accumulators: key block nb into nb % kAcc
    float o[kAcc][D / 2];
    float m[2], l[2];

    for (int step = 0;; ++step) {
        produce((step + 1) % kSmStages);
        cp_async_wait<1>();
        __syncthreads();
        if (tile_c == 0) {  // a new group: this warp's item, its query fragments
            active = warp < gc.n;
            bh = __shfl_sync(0xffffffffu, gc.bh, warp);
            q0 = __shfl_sync(0xffffffffu, gc.q0, warp);
            lo_w = __shfl_sync(0xffffffffu, gc.ilo, warp);
            hi_w = __shfl_sync(0xffffffffu, gc.ihi, warp);
            if (!active) lo_w = hi_w = 0;
            slot = __shfl_sync(0xffffffffu, gc.hkv, warp) - gc.hkv0;
            q_last = min(q0 + kSmRows, Lq) - 1;
            load_q<D>(qf, qbuf + (gq_c % kSmStages) * kQElems + warp * kSmRows * S, g, tig);
#pragma unroll
            for (int a = 0; a < kAcc; ++a) {
#pragma unroll
                for (int i = 0; i < D / 2; ++i) o[a][i] = 0.0f;
            }
            m[0] = m[1] = -INFINITY;
            l[0] = l[1] = 0.0f;
        }
        const int t0 = gc.lo + tile_c * kRows;
        if (t0 < hi_w && t0 + kRows > lo_w) {
            const T* sk = ring + (step % kSmStages) * stage_elems + slot * 2 * kRows * S;
            const T* sv = sk + kRows * S;
            float s[NB * 4];
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) block_scores<D>(&s[4 * nb], qf, sk + 8 * nb * S, g, tig);
            // Element i is key t0 + 2 tig + c, c = 8 (i / 4) + i % 2, of row
            // q0 + g + 8 h, h = (i / 2) % 2: visible when lo[h] < c < hi[h].
            // Tested only on tiles at the end of the keys, the diagonal or the
            // window edge.
            if (t0 + kRows > kv_end || (causal && t0 + kRows - 1 > q0) ||
                (window > 0 && q_last - t0 >= window)) {
                int lo[2], hi[2];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int qrel = q0 + g + 8 * h - t0 - 2 * tig;
                    hi[h] = causal ? min(kv_end - t0 - 2 * tig, qrel + 1) : kv_end - t0 - 2 * tig;
                    lo[h] = window > 0 ? qrel - window : -0x7fffffff;
                }
                if (causal || window > 0) {
#pragma unroll
                    for (int i = 0; i < NB * 4; ++i) {
                        const int c = 8 * (i >> 2) + (i & 1), h = (i >> 1) & 1;
                        if (c <= lo[h] || c >= hi[h]) s[i] = -INFINITY;
                    }
                } else {  // the end of the keys only: the same bound for both rows
#pragma unroll
                    for (int i = 0; i < NB * 4; ++i) {
                        if (8 * (i >> 2) + (i & 1) >= hi[0]) s[i] = -INFINITY;
                    }
                }
            }
            if (lut_mode) {  // no max subtraction: weights straight from the table
#pragma unroll
                for (int i = 0; i < NB * 4; ++i) {
                    const float w = s_exp[lut_index_linear_fast(s[i] * sc, exp_off, exp_step,
                                                                exp_inv_step, kExpSize)];
                    s[i] = s[i] == -INFINITY ? 0.0f : w;
                    l[(i >> 1) & 1] += s[i];
                }
            } else {  // sc > 0: the row max of s sc is sc times that of s
                float mt[2] = {-INFINITY, -INFINITY}, mu[2], alpha[2];
#pragma unroll
                for (int i = 0; i < NB * 4; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
#pragma unroll
                for (int h = 0; h < 2; ++h) {  // the 4 lanes of a row: 4 g .. 4 g + 3
                    mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
                    mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
                    const float m_new = fmaxf(m[h], mt[h] * sc);
                    mu[h] = m_new == -INFINITY ? 0.0f : m_new;  // nothing visible yet
                    alpha[h] = ex2_approx(m[h] - mu[h]);        // 0 on the first visible tile
                    m[h] = m_new;
                    l[h] *= alpha[h];
                }
#pragma unroll
                for (int i = 0; i < NB * 4; ++i) {
                    s[i] = ex2_approx(fmaf(s[i], sc, -mu[(i >> 1) & 1]));
                    l[(i >> 1) & 1] += s[i];
                }
#pragma unroll
                for (int a = 0; a < kAcc; ++a) {
#pragma unroll
                    for (int i = 0; i < D / 2; ++i) o[a][i] *= alpha[(i >> 1) & 1];
                }
            }
            if constexpr (C::kBf16) {
#pragma unroll
                for (int kk = 0; kk < NB / 2; ++kk) pair_pv<D>(o[kk % kAcc], &s[8 * kk], sv + 16 * kk * S, lane);
            } else {
#pragma unroll
                for (int nb = 0; nb < NB; ++nb) block_pv<D>(o[nb % kAcc], &s[4 * nb], sv + 8 * nb * S, g, tig);
            }
        }
        if (tile_c == gc.n_tiles - 1 && active) {  // the item's last tile: normalize, store
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
                l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int qi = q0 + g + 8 * h;
                if (qi >= Lq) continue;
                float inv = 0.0f;
                if (l[h] > 0.0f) {
                    inv = lut_mode ? __ldg(&inv_tab[lut_index_log(l[h], inv_off, inv_step, kInvSize)])
                                   : __frcp_rn(l[h]);  // = 1.0f / l[h], without the division
                }
                T* op = out + (static_cast<long long>(bh) * Lq + qi) * D + 2 * tig;
#pragma unroll
                for (int nb = 0; nb < D / 8; ++nb) {
                    const int i = 4 * nb + 2 * h;
                    float a = o[0][i], b = o[0][i + 1];
#pragma unroll
                    for (int j = 1; j < kAcc; ++j) a += o[j][i], b += o[j][i + 1];
                    a *= inv;
                    b *= inv;
                    if constexpr (ALIGNED) {
                        store_pair(op + 8 * nb, a, b);
                    } else {
                        op[8 * nb] = T(a);
                        op[8 * nb + 1] = T(b);
                    }
                }
            }
        }
        __syncthreads();  // this step's stage and query buffer may be refilled
        if (++tile_c == gc.n_tiles) {
            tile_c = 0;
            ++gq_c;
            grp_c += gridDim.x;
            if (grp_c >= n_groups) break;
            group_info(grp_c, gc);
        }
    }
    cp_async_wait<0>();
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(TcTile<T, D, G>::kThreads)
tc_attention_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, T* __restrict__ out,
                    const float* __restrict__ exp_tab, const float* __restrict__ inv_tab,
                    int BHq, int Hq, int Hkv, int Lq, int Lkv, int kv_len, int causal,
                    int window, int lut_mode, float scale, float exp_off, float exp_step,
                    float inv_off, float inv_step) {
    using C = TcTile<T, D, G>;
    constexpr int kStages = C::kStages;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    float* s_exp = reinterpret_cast<float*>(smem + C::kQBytes + 2 * kStages * C::kKVBytes);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);  // Q, then one per stage
    auto stage_k = [&](int st) { return smem + C::kQBytes + st * 2 * C::kKVBytes; };
    auto stage_v = [&](int st) { return stage_k(st) + C::kKVBytes; };

    const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
    const int warp = wtid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
    const int r0 = 16 * warp + g;  // this thread's rows of the tile: r0 and r0 + 8
    const int nqt = (Lq + kTcRows - 1) / kTcRows;
    const int bh = blockIdx.x % BHq;
    const int q0 = (nqt - 1 - blockIdx.x / BHq) * kTcRows;  // longest causal tiles first
    const int hkv = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);

    // Keys any row of this block can attend to.
    const int q_last = min(q0 + kTcRows, Lq) - 1;
    int kv_hi = min(kv_len, Lkv);
    if (causal) kv_hi = min(kv_hi, q_last + 1);
    const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + C::kBN - 1) / C::kBN : 0;

    auto issue = [&](int tile) {  // K and V of one tile into its stage
        const int st = tile % kStages, t0 = kv_lo + tile * C::kBN;
        mbar_expect_tx(&bars[1 + st], 2 * C::kKVBytes);
#pragma unroll
        for (int bx = 0; bx < C::kBoxes; ++bx) {
            tma_load_3d(stage_k(st) + bx * C::kBN * 128, &tk, bx * C::kBoxCols, t0, hkv,
                        &bars[1 + st]);
            tma_load_3d(stage_v(st) + bx * C::kBN * 128, &tv, bx * C::kBoxCols, t0, hkv,
                        &bars[1 + st]);
        }
    };

    if (tid == 0) {
        for (int i = 0; i < 1 + kStages; ++i) mbar_init(&bars[i], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (lut_mode) {
        for (int i = tid; i < kExpSize; i += C::kThreads) s_exp[i] = __ldg(&exp_tab[i]);
    }
    __syncthreads();
    if (tid == 0) {
        mbar_expect_tx(&bars[0], C::kQBytes);
#pragma unroll
        for (int bx = 0; bx < C::kBoxes; ++bx) {
            tma_load_3d(smem + bx * kTcRows * 128, &tq, bx * C::kBoxCols, q0, bh, &bars[0]);
        }
        for (int t = 0; t < min(kStages, n_tiles); ++t) issue(t);
    }

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    mbar_wait(&bars[0], 0);

    // Scales and masks one tile's scores (s: element i is key block i / 4, row
    // r0 + 8 ((i / 2) % 2), key 2 tig + i % 2 of the block) and turns them into
    // weights in place.  alpha rescales the rows' earlier sums (1 in lut mode).
    auto softmax = [&](float (&s)[C::kNB * 4], int t0, float (&alpha)[2]) {
        // element masks only on tiles at the end of the keys, the diagonal or the window edge
        const bool edge = t0 + C::kBN > kv_hi || (causal && t0 + C::kBN - 1 > q0) ||
                          (window > 0 && q_last - t0 >= window);
#pragma unroll
        for (int i = 0; i < C::kNB * 4; ++i) {
            float x = s[i] * scale;
            if (edge) {
                const int qi = q0 + r0 + 8 * ((i >> 1) & 1);
                const int kpos = t0 + 8 * (i >> 2) + 2 * tig + (i & 1);
                const bool ok = kpos < kv_hi && (!causal || kpos <= qi) &&
                                (window <= 0 || qi - kpos < window);
                if (!ok) x = -INFINITY;
            }
            s[i] = x;
        }
        if (lut_mode) {  // no max subtraction: weights straight from the table
            alpha[0] = alpha[1] = 1.0f;
#pragma unroll
            for (int i = 0; i < C::kNB * 4; ++i) {
                s[i] = s[i] == -INFINITY
                           ? 0.0f
                           : s_exp[lut_index_linear(s[i], exp_off, exp_step, kExpSize)];
                l[(i >> 1) & 1] += s[i];
            }
            return;
        }
        float mt[2] = {-INFINITY, -INFINITY}, mu[2];
#pragma unroll
        for (int i = 0; i < C::kNB * 4; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the 4 threads of a row: lanes 4 g .. 4 g + 3
            mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
            mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
            const float m_new = fmaxf(m[h], mt[h]);
            mu[h] = m_new == -INFINITY ? 0.0f : m_new;  // a row with nothing visible yet
            alpha[h] = exp2f((m[h] - mu[h]) * kLog2e);  // 0 on the first visible tile
            m[h] = m_new;
            l[h] *= alpha[h];
        }
#pragma unroll
        for (int i = 0; i < C::kNB * 4; ++i) {
            s[i] = exp2f((s[i] - mu[(i >> 1) & 1]) * kLog2e);
            l[(i >> 1) & 1] += s[i];
        }
    };
    auto release = [&](int j) {  // this warpgroup is done with tile j's stage: refill it
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        if (wtid == 0 && j + kStages < n_tiles) issue(j + kStages);
    };

    float s[C::kNB * 4], alpha[2];
    if constexpr (C::kBf16) {
        // Warpgroup tiles j, j + G, ...: S(j + G) = Q K^T and O += P(j) V(j) are
        // issued back to back, and the softmax of tile j + G runs on the CUDA
        // cores while P(j) V(j) is still on the tensor cores.
        uint32_t pa[4][4];
        int j = wg;
        if (j < n_tiles) {
            mbar_wait(&bars[1 + j % kStages], (j / kStages) & 1);
            scores_bf16<D>(s, smem_u32(smem), smem_u32(stage_k(j % kStages)));
            softmax(s, kv_lo + j * C::kBN, alpha);
        }
        // Steady state; the last tile is peeled off so that no wgmma is issued
        // under a condition (ptxas serializes wgmma on divergent paths).
        for (; j + G < n_tiles; j += G) {
            const int next = j + G;
            pack_p(pa, s);
            mbar_wait(&bars[1 + next % kStages], (next / kStages) & 1);
            fence_regs(o);
            wgmma_fence();
            issue_scores_bf16<D>(s, smem_u32(smem), smem_u32(stage_k(next % kStages)));
            wgmma_commit();
            issue_pv_bf16<D>(o, pa, smem_u32(stage_v(j % kStages)));
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs(s);
            softmax(s, kv_lo + next * C::kBN, alpha);
            wgmma_wait<0>();
            fence_regs(o);
            fence_regs(pa);
            release(j);
#pragma unroll
            for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        }
        if (j < n_tiles) {
            pack_p(pa, s);
            fence_regs(o);
            wgmma_fence();
            issue_pv_bf16<D>(o, pa, smem_u32(stage_v(j % kStages)));
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(o);
            fence_regs(pa);
            release(j);
        }
    } else {
        for (int j = wg; j < n_tiles; j += G) {  // warpgroup wg takes tiles wg, wg + G, ...
            const int st = j % kStages;
            mbar_wait(&bars[1 + st], (j / kStages) & 1);
            scores_f32<D>(s, reinterpret_cast<const float*>(smem),
                          reinterpret_cast<const float*>(stage_k(st)), r0, g, tig);
            softmax(s, kv_lo + j * C::kBN, alpha);
#pragma unroll
            for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
            pv_f32<D>(o, s, reinterpret_cast<const float*>(stage_v(st)), g, tig);
            release(j);
        }
    }

    // Merge warpgroup 1's rows into warpgroup 0's through the idle ring.
    if constexpr (G == 2) {
        __syncthreads();
        float* xch = reinterpret_cast<float*>(smem + C::kQBytes);  // [D / 2 + 4][128]
        if (wg == 1) {
#pragma unroll
            for (int i = 0; i < D / 2; ++i) xch[i * 128 + wtid] = o[i];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                xch[(D / 2 + h) * 128 + wtid] = m[h];
                xch[(D / 2 + 2 + h) * 128 + wtid] = l[h];
            }
        }
        __syncthreads();
        if (wg == 1) return;
        float a0[2] = {1.0f, 1.0f}, a1[2] = {1.0f, 1.0f};  // lut: plain sums
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float m1 = xch[(D / 2 + h) * 128 + wtid], l1 = xch[(D / 2 + 2 + h) * 128 + wtid];
            if (!lut_mode) {
                const float mm = fmaxf(m[h], m1);
                const float mu = mm == -INFINITY ? 0.0f : mm;
                a0[h] = exp2f((m[h] - mu) * kLog2e);
                a1[h] = exp2f((m1 - mu) * kLog2e);
            }
            l[h] = l[h] * a0[h] + l1 * a1[h];
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
            o[i] = o[i] * a0[(i >> 1) & 1] + xch[i * 128 + wtid] * a1[(i >> 1) & 1];
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int qi = q0 + r0 + 8 * h;
        if (qi >= Lq) continue;
        float inv = 0.0f;
        if (l[h] > 0.0f) {
            inv = lut_mode ? __ldg(&inv_tab[lut_index_log(l[h], inv_off, inv_step, kInvSize)])
                           : 1.0f / l[h];
        }
        T* op = out + (static_cast<long long>(bh) * Lq + qi) * D + 2 * tig;
#pragma unroll
        for (int nb = 0; nb < D / 8; ++nb) {
            store_pair(op + 8 * nb, o[4 * nb + 2 * h] * inv, o[4 * nb + 2 * h + 1] * inv);
        }
    }
}

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

// (D, L, heads) map of a contiguous (B, H, L, D) tensor; boxes of 128 bytes x rows x 1,
// 128-byte swizzle, zeros past every edge.
template <typename T, int D>
bool encode_map(CUtensorMap* map, const void* base, int L, int heads, int rows) {
    constexpr cuuint32_t kBoxCols = TcTile<T, D, 1>::kBoxCols;
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(L),
                                static_cast<cuuint64_t>(heads)};
    const cuuint64_t strides[2] = {D * sizeof(T), static_cast<cuuint64_t>(L) * D * sizeof(T)};
    const cuuint32_t box[3] = {kBoxCols, static_cast<cuuint32_t>(rows), 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUtensorMapDataType type =
        sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    return encode(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

// SM count of the current device, and the kernel's shared-memory opt-in, each
// done once per device (a launch above 48 KB without the opt-in is refused).
int sm_count(int dev) {
    static int count[kMaxDevices] = {};
    if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
    return count[dev];
}

template <typename T, int D, int NB, int W, bool ALIGNED>
cudaError_t launch_small_w(int dev, int items, int smem, int slots,
                           const void* q, const void* k, const void* v, void* out,
                           const float* exp_tab, const float* inv_tab, int B, int Hq, int Hkv,
                           int Lq, int Lkv, int kv_len, int causal, int window, int lut_mode,
                           float scale, float exp_off, float exp_step, float inv_off,
                           float inv_step, cudaStream_t stream) {
    const auto kernel = small_attention_kernel<T, D, NB, W, ALIGNED>;
    static int opted_in[kMaxDevices] = {};  // dynamic shared memory allowed so far
    if (smem > 48 * 1024 && smem > opted_in[dev]) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        opted_in[dev] = smem;
    }
    // resident blocks only: each walks its groups through one copy ring
    int per_sm = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * W, smem);
    if (err != cudaSuccess) return err;
    const int grid = std::min((items + W - 1) / W, std::max(1, per_sm) * sm_count(dev));
    kernel<<<grid, 32 * W, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), exp_tab, inv_tab, B * Hq, Hq, Hkv, Lq, Lkv, kv_len, causal, window,
        lut_mode, scale, exp_off, exp_step, inv_off, inv_step, slots);
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_small(const void* q, const void* k, const void* v, void* out,
                         const float* exp_tab, const float* inv_tab, int B, int Hq, int Hkv,
                         int Lq, int Lkv, int kv_len, int causal, int window, int lut_mode,
                         float scale, float exp_off, float exp_step, float inv_off,
                         float inv_step, cudaStream_t stream) {
    const int nqt = (Lq + kSmRows - 1) / kSmRows;
    const long long items = static_cast<long long>(B) * Hq * nqt;
    if (items > 0x7fffffffLL - 8) return cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) &
                          15) == 0;
    // 8-key blocks per tile: the fewest that cover the keys in as few tiles
    // of at most 8 blocks as there can be, where an instance has it: 2 (L up
    // to 16: btagging's 15), 7 (float32; engine_anomaly's 50 and gw's 100 in
    // one and two tiles), else 8 (and for unaligned pointers).
    const int kv_end = std::min(kv_len, Lkv);
    const int blocks = (kv_end + 7) / 8, tiles = (blocks + kSmMaxNB - 1) / kSmMaxNB;
    const int need = (blocks + tiles - 1) / tiles;
    const int nb = !aligned ? 8 : need <= 2 ? 2 : need == 7 && sizeof(T) == 4 ? 7 : 8;
    const int rows = 8 * nb;
    // K/V slots per stage: the most key/value heads W consecutive items span.
    auto slots_for = [&](int w) { return std::min(w, 1 + (w - 1 + nqt - 1) / nqt); };
    auto smem_for = [&](int w) {  // the exp table, 2 x (query rows, K/V tiles)
        return (lut_mode ? kExpSize * 4 : 0) + kSmStages * (w * kSmRows + slots_for(w) * 2 * rows) *
                                                   SmTile<T, D>::kStride * static_cast<int>(sizeof(T));
    };
    // Eight warps per block once the grid has two such blocks per SM and
    // their ring leaves room for two blocks on an SM; else four (more blocks
    // for small grids, fewer slots when Lq <= 16 and the keys are long).
    const bool eight = aligned && items >= 2LL * 8 * sm_count(dev) && smem_for(8) <= 96 * 1024;
    constexpr int kNb7 = sizeof(T) == 4 ? 7 : 8;  // bf16 takes 16 keys per P V step
#define REPRO_FA_SMALL(NB, W, AL)                                                               \
    launch_small_w<T, D, NB, W, AL>(dev, static_cast<int>(items), smem_for(W), slots_for(W), q,  \
                                    k, v, out, exp_tab, inv_tab, B, Hq, Hkv, Lq, Lkv, kv_len,    \
                                    causal, window, lut_mode, scale, exp_off, exp_step, inv_off, \
                                    inv_step, stream)
#define REPRO_FA_SMALL_W(NB) eight ? REPRO_FA_SMALL(NB, 8, true) : REPRO_FA_SMALL(NB, 4, true)
    if (!aligned) return REPRO_FA_SMALL(8, 4, false);
    switch (nb) {
        case 2:
            return REPRO_FA_SMALL_W(2);
        case 7:
            return REPRO_FA_SMALL_W(kNb7);
        default:
            return REPRO_FA_SMALL_W(8);
    }
#undef REPRO_FA_SMALL_W
#undef REPRO_FA_SMALL
}

template <typename T, int D, int G>
cudaError_t launch_tc_groups(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                             int dev, int blocks, void* out, const float* exp_tab,
                             const float* inv_tab, int B, int Hq, int Hkv, int Lq, int Lkv,
                             int kv_len, int causal, int window, int lut_mode, float scale,
                             float exp_off, float exp_step, float inv_off, float inv_step,
                             cudaStream_t stream) {
    using C = TcTile<T, D, G>;
    static bool opted_in[kMaxDevices] = {};
    if (!opted_in[dev]) {
        const cudaError_t err = cudaFuncSetAttribute(
            tc_attention_kernel<T, D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            C::kSmemBytes);
        if (err != cudaSuccess) return err;
        opted_in[dev] = true;
    }
    tc_attention_kernel<T, D, G><<<blocks, C::kThreads, C::kSmemBytes, stream>>>(
        tq, tk, tv, static_cast<T*>(out), exp_tab, inv_tab, B * Hq, Hq, Hkv, Lq, Lkv, kv_len,
        causal, window, lut_mode, scale, exp_off, exp_step, inv_off, inv_step);
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      const float* exp_tab, const float* inv_tab, int B, int Hq, int Hkv, int Lq,
                      int Lkv, int kv_len, int causal, int window, int lut_mode, float scale,
                      float exp_off, float exp_step, float inv_off, float inv_step,
                      cudaStream_t stream) {
    constexpr int kBN = TcTile<T, D, 1>::kBN;
    CUtensorMap tq, tk, tv;
    if (!encode_map<T, D>(&tq, q, Lq, B * Hq, kTcRows) ||
        !encode_map<T, D>(&tk, k, Lkv, B * Hkv, kBN) ||
        !encode_map<T, D>(&tv, v, Lkv, B * Hkv, kBN)) {
        return cudaErrorInvalidValue;
    }
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    // Two warpgroups per block halve the longest block's key walk.  In bf16
    // a grid that fills the SMs takes one instead, whose smaller ring fits
    // two blocks on an SM; float32 gains from the second warpgroup's latency
    // hiding at every size (measured on an H100).
    const int blocks = B * Hq * ((Lq + kTcRows - 1) / kTcRows);
    const bool two_groups = sizeof(T) == 4 || blocks <= sm_count(dev);
#define REPRO_FA_TC(G)                                                                       \
    launch_tc_groups<T, D, G>(tq, tk, tv, dev, blocks, out, exp_tab, inv_tab, B, Hq, Hkv, Lq, \
                              Lkv, kv_len, causal, window, lut_mode, scale, exp_off, exp_step, \
                              inv_off, inv_step, stream)
    err = two_groups ? REPRO_FA_TC(2) : REPRO_FA_TC(1);
#undef REPRO_FA_TC
    return err;
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
                       const float* exp_tab, const float* inv_tab, int B, int Hq,
                       int Hkv, int Lq, int Lkv, int kv_len, int causal, int window,
                       int lut_mode, float scale, float exp_off, float exp_step,
                       float inv_off, float inv_step, cudaStream_t stream) {
#define REPRO_FA_CASE(DIM, LAUNCH)                                                      \
    case DIM:                                                                           \
        return LAUNCH<T, DIM>(q, k, v, out, exp_tab, inv_tab, B, Hq, Hkv, Lq, Lkv,      \
                              kv_len, causal, window, lut_mode, scale, exp_off,         \
                              exp_step, inv_off, inv_step, stream);
    switch (D) {
        REPRO_FA_CASE(8, launch_small)
        REPRO_FA_CASE(16, launch_small)
        REPRO_FA_CASE(32, launch_small)
        REPRO_FA_CASE(64, launch_tc)
        REPRO_FA_CASE(128, launch_tc)
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
