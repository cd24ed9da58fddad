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
// shapes (D = 64, 96, 128; L = 1024, 2048) are bound by operations: 989
// TFLOP/s in bf16, 165 TFLOP/s of float32 work done as 3xTF32.  Both kernels
// keep every score and output element in the m16n8 accumulator fragment
// layout of mma (thread lane: rows lane/4 and lane/4 + 8, columns 2 (lane %
// 4) + {0, 1} of each 8-wide block; wgmma's m64 accumulators are four such
// warp slices), and run float32 as 3xTF32: each operand is split into big,
// a TF32 value, and small, the rest read as TF32, and the float32
// accumulator takes small*big + big*small + big*big (kernel 1 adds
// small*small in Q K^T).  One TF32 product keeps 10 mantissa bits (1e-3 off
// against the 2e-5 tolerance at every shape tried); three keep float32's
// accuracy.  In the P V product the k order of an 8-key step is permuted (k
// index t <-> key 2t, t + 4 <-> key 2t + 1) so the score fragment is the A
// fragment with no shuffle.  Two kernels, by head_dim:
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
// 2. (q/k, V) head_dims (64, 64), (96, 64) and (128, 128) (LM heads, MLA's
//    prefill attend at q/k 96 and V 64, the streaming MHA at granite-8b's
//    width): tc_attention_kernel<T, DQK, DV, G>.  A block owns 64 query rows
//    and holds G = 1 or 2 consumer warpgroups (4 warps, 128 threads each)
//    that split its key tiles (tile j to warpgroup j % G) and merge their
//    rows' (max, sum, output) through shared memory at the end; warp w of a
//    warpgroup owns rows 16w .. 16w + 15.  Q and K are K-major (DQK
//    contiguous) and V keeps its own head_dim: all three come by TMA
//    straight from the unpadded tensors (cp.async.bulk.tensor, 3-D maps over
//    (head_dim, L, batch * heads), 128-byte swizzle; at 96 in bf16 the
//    second 64-column box is half past the tensor's edge, TMA's zero fill,
//    which no product reads), K/V tiles through a ring of two stages per
//    warpgroup tracked by mbarriers, the copy of a warpgroup's next tile in
//    flight while it computes this one.  Reads past L are zero fill, so no
//    length need be a multiple of a tile.
//    - bf16 (64-key tiles): S = Q K^T is wgmma m64n64k16, DQK / 16 k-steps
//      (6 at 96: no zero column multiplied), Q and K read from shared
//      memory.  The online softmax runs on the accumulator fragments (a
//      row's max over the 4 threads that share it with two shuffles, in
//      log2 units with scale log2(e) folded into one FMA per score, then
//      ex2; its sum only once, at the end).  P is rounded to bf16 in
//      registers as the A operand of P V (m64nDVk16), the V tile the
//      shared-memory B operand with the transpose bit.  S of the next tile
//      and P V of this one are issued back to back, and the next tile's
//      softmax runs while P V is on the tensor cores.  G = 2 where the grid
//      leaves SMs idle (the longest causal walk halves), else G = 1, whose
//      69 KB at (96, 64) fits three blocks on an SM.
//    - float32: 3xTF32 on wgmma m64nNk8.  TF32 wgmma reads only K-major
//      operands from shared memory, and reads each 32-bit operand truncated
//      to TF32, so the halves are made once and kept there: Q's by each
//      block (Veltkamp's split, the big half in place), K's by the
//      warpgroup per tile (Veltkamp, in place), V's per tile transposed to
//      V^T (DV rows x keys, keys contiguous, the permuted k order; the raw
//      value is its own big half, the small half x - trunc(x)); P's in
//      registers (Veltkamp) as the A operand.  S takes 3 DQK / 8 wgmma,
//      P V 3 per 8 keys.  One warpgroup, 64-key tiles at (64, 64) and
//      (96, 64) (189 KB of shared memory at (96, 64)), 32-key tiles at
//      (128, 128); two warpgroups of 32-key tiles measured 3 % slower.
//      Bound by the CUDA-core work around the products (the softmax, the
//      splits, the transpose) more than by the tensor cores.  It replaced
//      3xTF32 on mma.sync with operands split on every fragment load, 2x
//      slower at the LM shapes (PERF.md).
//    A block walks only the key tiles its rows can see; element masks are
//    evaluated only on tiles that cross the diagonal, the window edge or the
//    end of kv_len.  A safe row that sees no key (a window ending before
//    kv_len) is stored as the mean of V over every key, as the plain
//    version's softmax of a row masked everywhere gives: v_mean_kernel
//    writes it per (batch, kv head), launched only when such rows exist, and
//    both kernels read it only for rows that end with a zero sum.  Grid
//    order: 1-D, heads in groups whose K/V fills at most a quarter of L2
//    (the host's heads_per_group), a group's blocks consecutive with its
//    longest causal query tiles first and its heads fastest, so the blocks
//    in flight share a few heads' K/V in L2 and under a causal mask (a call
//    takes as long as its longest block) the long walks still start first.
//    At minicpm3-4b's (8, 40, 2048, 96 / 64) bf16 the heads-fastest order
//    measured 1.40x slower (PERF.md).
//
// Both kernels: GQA maps query head h to key/value head h / (Hq / Hkv) by
// index; K/V are never repeated in memory.  LUT mode: exp from the
// 1024-entry linear table in shared memory (its gathers diverge), indexed
// on the float32 score itself, running row sum without max subtraction,
// reciprocal from the 4096-entry log table at the end.
//
// The kernels allocate nothing and launch on the caller's stream; the C
// entry returns cudaGetLastError() (or cudaErrorInvalidValue for a (q/k, V)
// pair without an instance, or when a tensor map cannot be encoded: on the
// tensor-core kernel a pointer that is not 16-byte aligned).

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

// Q/K head_dim DQK, V head_dim DV.  G consumer warpgroups per block share its
// 64 query rows and split the key tiles between them (tile j to warpgroup
// j % G); two ring stages each.  float32 runs one warpgroup and keeps,
// beside the ring, the TF32 halves its wgmma products read: Q's small half,
// one K tile's small half and one V tile transposed (V^T, DV rows x kBN
// keys, keys contiguous in boxes of 32) as big and small halves.  Every
// buffer starts on a 1024-byte swizzle period.
template <typename T, int DQK, int DV, int G>
struct TcTile {
    static constexpr int kThreads = 128 * G;
    static constexpr int kStages = 2 * G;  // the bf16 loop waits for tile j + G before it
                                           // releases tile j: two stages per warpgroup
    static constexpr bool kBf16 = sizeof(T) == 2;
    static_assert(kBf16 || G == 1, "float32 runs one warpgroup per block");
    // keys per K/V tile: 64, or 32 where float32's buffers would not fit at 64
    static constexpr int kBN = kBf16 || DQK + DV <= 192 ? 64 : 32;
    static constexpr int kNB = kBN / 8;               // 8-key blocks per tile
    static constexpr int kBoxCols = 128 / sizeof(T);  // columns of one 128-byte swizzled box
    // Q/K boxes: bf16 at 96 takes two, the second half past the tensor's
    // edge (TMA's zero fill; the products never read it)
    static constexpr int kQKBoxes = (DQK + kBoxCols - 1) / kBoxCols;
    static constexpr int kVBoxes = DV / kBoxCols;
    static_assert(DV % kBoxCols == 0 && DV <= DQK, "V at whole boxes, at most q/k's head_dim");
    static constexpr int kQBytes = kTcRows * kQKBoxes * 128;
    static constexpr int kKBytes = kBN * kQKBoxes * 128;  // one K tile
    static constexpr int kVBytes = kBN * kVBoxes * 128;   // one V tile
    static constexpr int kStageBytes = kKBytes + kVBytes;
    static constexpr int kVtBytes = kBf16 ? 0 : DV * kBN * 4;  // one half of V^T
    static constexpr int kQsOffset = kQBytes;
    static constexpr int kRingOffset = kQsOffset + (kBf16 ? 0 : kQBytes);
    static constexpr int kKsOffset = kRingOffset + kStages * kStageBytes;
    static constexpr int kVtOffset = kKsOffset + (kBf16 ? 0 : kKBytes);  // big, then small
    static constexpr int kExpOffset = kVtOffset + 2 * kVtBytes;
    static constexpr int kBarOffset = kExpOffset + kExpSize * 4;
    static_assert((DV / 2 + 4) * 128 * 4 <= kStages * kStageBytes, "merge fits in the ring");
    // + 1024 for aligning the base to the 1024-byte swizzle period
    static constexpr int kSmemBytes = kBarOffset + 8 * (1 + kStages) + 1024;
    static_assert(kSmemBytes <= 232448, "fits an SM's shared memory");
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

// TF32 wgmma (m64nNk8): the tensor cores read the top 19 bits of each
// 32-bit operand, so a float32 value is read truncated to TF32.  TF32 takes
// only K-major operands (no transpose bit).
#define REPRO_ACC8(d, i)                                                                 \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),        \
        "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPRO_REGS16 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define REPRO_REGS32 REPRO_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31"
#define REPRO_REGS64 REPRO_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, " \
    "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
    "%58, %59, %60, %61, %62, %63"

// D (64 x N, float32) (+)= A B, A (64 x 8) and B (8 x N) both K-major in
// shared memory; N = 32 or 64 (the keys of an S tile).
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[N / 2], uint64_t da, uint64_t db,
                                              int scale_d) {
    if constexpr (N == 64) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" REPRO_REGS32
                     "}, %32, %33, p, 1, 1;\n}\n"
                     : REPRO_ACC8(d, 0), REPRO_ACC8(d, 8), REPRO_ACC8(d, 16), REPRO_ACC8(d, 24)
                     : "l"(da), "l"(db), "r"(scale_d));
    } else {
        static_assert(N == 32, "S tiles of 32 or 64 keys");
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" REPRO_REGS16
                     "}, %16, %17, p, 1, 1;\n}\n"
                     : REPRO_ACC8(d, 0), REPRO_ACC8(d, 8)
                     : "l"(da), "l"(db), "r"(scale_d));
    }
}

// D (64 x N) += A B: A (64 x 8 TF32) from registers in the mma.m16n8k8
// layout, B (8 x N) K-major in shared memory; N = 64 or 128 (V's head_dim).
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t db) {
    if constexpr (N == 64) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" REPRO_REGS32
                     "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                     : REPRO_ACC8(d, 0), REPRO_ACC8(d, 8), REPRO_ACC8(d, 16), REPRO_ACC8(d, 24)
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    } else {
        static_assert(N == 128, "V head_dims of 64 or 128");
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" REPRO_REGS64
                     "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                     : REPRO_ACC8(d, 0), REPRO_ACC8(d, 8), REPRO_ACC8(d, 16), REPRO_ACC8(d, 24),
                       REPRO_ACC8(d, 32), REPRO_ACC8(d, 40), REPRO_ACC8(d, 48), REPRO_ACC8(d, 56)
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    }
}
#undef REPRO_REGS64
#undef REPRO_REGS32
#undef REPRO_REGS16
#undef REPRO_ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
    return *reinterpret_cast<const uint32_t*>(&v);
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
                       const float* __restrict__ vmean,
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
        if (hi <= lo) lo = hi = 0;  // no key visible: one empty step (the rows take vmean)
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
                // a safe row that saw no key: the mean of V (vmean, safe mode only)
                const long long vrow = static_cast<long long>(gc.hkv0 + slot) * D;
                const float* vm =
                    l[h] > 0.0f || vmean == nullptr ? nullptr : vmean + vrow + 2 * tig;
#pragma unroll
                for (int nb = 0; nb < D / 8; ++nb) {
                    const int i = 4 * nb + 2 * h;
                    float a = o[0][i], b = o[0][i + 1];
#pragma unroll
                    for (int j = 1; j < kAcc; ++j) a += o[j][i], b += o[j][i + 1];
                    a *= inv;
                    b *= inv;
                    if (vm != nullptr) a = vm[8 * nb], b = vm[8 * nb + 1];
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

// ------------------------------------------------------------------------
// float32 on wgmma (tensor-core path): 3xTF32 with each operand split once
// into TF32 halves in shared memory (Q once per block, K and V once per tile)
// or in registers (P).  Q, K and P take Veltkamp's split (split_fast: the
// big half to nearest, the small half read truncated, 2^-23 |x| at most).
// The tensor cores read a 32-bit operand truncated to TF32, so V's raw
// values are its own big half and the small half is the exact rest
// x - trunc(x) (read truncated: 2^-21 |x| at most, on the output only).

__device__ __forceinline__ float small_trunc(float x) {
    return __fsub_rn(x, __uint_as_float(__float_as_uint(x) & 0xffffe000u));
}

// Q's halves, once per block: the big half in place, the small half at qs.
template <int BYTES>
__device__ __forceinline__ void split_q_smem(float* q, float* qs, int tid) {
    float4* q4 = reinterpret_cast<float4*>(q);
    float4* s4 = reinterpret_cast<float4*>(qs);
    for (int i = tid; i < BYTES / 16; i += 128) {
        float x[4] = {q4[i].x, q4[i].y, q4[i].z, q4[i].w};
        uint32_t b[4], sm[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split_fast(x[r], b[r], sm[r]);
        q4[i] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]),
                            __uint_as_float(b[3]));
        s4[i] = make_float4(__uint_as_float(sm[0]), __uint_as_float(sm[1]),
                            __uint_as_float(sm[2]), __uint_as_float(sm[3]));
    }
}

// A K tile's halves: Veltkamp's big half in place, the small half at ks, in
// the tile's own (swizzled) layout.  Rounding the big half (rather than
// reading K truncated) keeps the scores within 2^-23 of their float32
// value, so that the LUT softmax's table indices move at ties only.
template <int BYTES>
__device__ __forceinline__ void split_k_smem(float* k, float* ks, int tid) {
    float4* k4 = reinterpret_cast<float4*>(k);
    float4* s4 = reinterpret_cast<float4*>(ks);
#pragma unroll 2
    for (int i = tid; i < BYTES / 16; i += 128) {
        float x[4] = {k4[i].x, k4[i].y, k4[i].z, k4[i].w};
        uint32_t b[4], sm[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split_fast(x[r], b[r], sm[r]);
        k4[i] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]),
                            __uint_as_float(b[3]));
        s4[i] = make_float4(__uint_as_float(sm[0]), __uint_as_float(sm[1]),
                            __uint_as_float(sm[2]), __uint_as_float(sm[3]));
    }
}

// V^T's big and small halves (DV rows x BN keys, keys contiguous in boxes of
// 32, 128-byte swizzled: the K-major B operand of P V) from a V tile (BN
// keys x DV, boxes of 32 columns).  The keys of each 8-key block are
// permuted (k index t <-> key 2t, t + 4 <-> key 2t + 1), so P's accumulator
// fragment is its A fragment.  A thread takes (row n, 4 k indices); a
// warp's lanes take 32 consecutive n, so its loads read one 128-byte row and
// each 8-lane phase of its 16-byte stores falls in 8 different bank groups.
template <int DV, int BN>
__device__ __forceinline__ void transpose_v_smem(const float* v, float* vtb, float* vts, int tid) {
#pragma unroll 4
    for (int i = tid; i < DV * BN / 4; i += 128) {
        const int n = i % DV, c = i / DV;         // k indices 4c .. 4c + 3
        const int key0 = 8 * (c >> 1) + (c & 1);  // their keys: key0, + 2, + 4, + 6
        float x[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) x[t] = v[swz_f32<BN>(key0 + 2 * t, n)];
        const int o = swz_f32<DV>(n, 4 * c);
        *reinterpret_cast<float4*>(vtb + o) = make_float4(x[0], x[1], x[2], x[3]);
        *reinterpret_cast<float4*>(vts + o) = make_float4(small_trunc(x[0]), small_trunc(x[1]),
                                                          small_trunc(x[2]), small_trunc(x[3]));
    }
}

// Issues S (64 x BN keys) = Q K^T as three TF32 products per k8 step
// (small * big, big * small, big * big), every operand K-major in shared
// memory (4 k8 steps per 128-byte box).
template <int DQK, int BN>
__device__ __forceinline__ void issue_scores_f32(float (&s)[BN / 2], uint32_t q, uint32_t qs,
                                                 uint32_t k, uint32_t ks) {
#pragma unroll
    for (int st = 0; st < DQK / 8; ++st) {
        const uint32_t qo = (st / 4) * (kTcRows * 128) + (st % 4) * 32;
        const uint32_t ko = (st / 4) * (BN * 128) + (st % 4) * 32;
        wgmma_ss_tf32<BN>(s, sw128_desc(qs + qo, 0), sw128_desc(k + ko, 0), st > 0);
        wgmma_ss_tf32<BN>(s, sw128_desc(q + qo, 0), sw128_desc(ks + ko, 0), 1);
        wgmma_ss_tf32<BN>(s, sw128_desc(q + qo, 0), sw128_desc(k + ko, 0), 1);
    }
}

// P's TF32 halves as wgmma A fragments (Veltkamp), in the permuted k order:
// k8 step kk holds key block kk, p[4 kk .. 4 kk + 3].
template <int NB>
__device__ __forceinline__ void split_p(uint32_t (&pb)[NB][4], uint32_t (&ps)[NB][4],
                                        const float (&p)[NB * 4]) {
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
        split_fast(p[4 * kk + 0], pb[kk][0], ps[kk][0]);
        split_fast(p[4 * kk + 2], pb[kk][1], ps[kk][1]);
        split_fast(p[4 * kk + 1], pb[kk][2], ps[kk][2]);
        split_fast(p[4 * kk + 3], pb[kk][3], ps[kk][3]);
    }
}

// Issues O (64 x DV) += P V as three TF32 products per 8-key step: P from
// registers, V^T's halves from shared memory.
template <int DV, int NB>
__device__ __forceinline__ void issue_pv_f32(float (&o)[DV / 2], const uint32_t (&pb)[NB][4],
                                             const uint32_t (&ps)[NB][4], uint32_t vtb,
                                             uint32_t vts) {
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
        const uint32_t off = (kk / 4) * (DV * 128) + (kk % 4) * 32;
        wgmma_rs_tf32<DV>(o, ps[kk], sw128_desc(vtb + off, 0));
        wgmma_rs_tf32<DV>(o, pb[kk], sw128_desc(vts + off, 0));
        wgmma_rs_tf32<DV>(o, pb[kk], sw128_desc(vtb + off, 0));
    }
}

template <int NB>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[NB][4]) {
#pragma unroll
    for (int i = 0; i < NB * 4; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

template <typename T, int DQK, int DV, int G>
__global__ void __launch_bounds__(TcTile<T, DQK, DV, G>::kThreads)
tc_attention_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, T* __restrict__ out,
                    const float* __restrict__ exp_tab, const float* __restrict__ inv_tab,
                    const float* __restrict__ vmean,
                    int BHq, int Hq, int Hkv, int Lq, int Lkv, int kv_len, int causal,
                    int window, int lut_mode, float scale, float exp_off, float exp_step,
                    float inv_off, float inv_step, int heads_per_group) {
    using C = TcTile<T, DQK, DV, G>;
    constexpr int kStages = C::kStages;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    float* s_exp = reinterpret_cast<float*>(smem + C::kExpOffset);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);  // Q, then one per stage
    auto stage_k = [&](int st) { return smem + C::kRingOffset + st * C::kStageBytes; };
    auto stage_v = [&](int st) { return stage_k(st) + C::kKBytes; };

    const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
    const int warp = wtid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
    const int r0 = 16 * warp + g;  // this thread's rows of the tile: r0 and r0 + 8
    const int nqt = (Lq + kTcRows - 1) / kTcRows;
    // Grid order: heads in groups whose K/V fits in a share of L2 (the host
    // picks heads_per_group), a group's blocks consecutive, so the blocks in
    // flight share a few heads' K/V tiles in L2; within a group the longest
    // causal query tiles first, heads fastest.
    const int per_group = heads_per_group * nqt;
    const int grp = blockIdx.x / per_group, in_grp = blockIdx.x - grp * per_group;
    const int heads = min(heads_per_group, BHq - grp * heads_per_group);
    const int bh = grp * heads_per_group + in_grp % heads;
    const int q0 = (nqt - 1 - in_grp / heads) * kTcRows;
    const int hkv = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);

    // Keys any row of this block can attend to.
    const int q_last = min(q0 + kTcRows, Lq) - 1;
    int kv_hi = min(kv_len, Lkv);
    if (causal) kv_hi = min(kv_hi, q_last + 1);
    const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + C::kBN - 1) / C::kBN : 0;

    auto issue = [&](int tile) {  // K and V of one tile into its stage
        const int st = tile % kStages, t0 = kv_lo + tile * C::kBN;
        mbar_expect_tx(&bars[1 + st], C::kStageBytes);
#pragma unroll
        for (int bx = 0; bx < C::kQKBoxes; ++bx) {
            tma_load_3d(stage_k(st) + bx * C::kBN * 128, &tk, bx * C::kBoxCols, t0, hkv,
                        &bars[1 + st]);
        }
#pragma unroll
        for (int bx = 0; bx < C::kVBoxes; ++bx) {
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
        for (int bx = 0; bx < C::kQKBoxes; ++bx) {
            tma_load_3d(smem + bx * kTcRows * 128, &tq, bx * C::kBoxCols, q0, bh, &bars[0]);
        }
        for (int t = 0; t < min(kStages, n_tiles); ++t) issue(t);
    }

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    mbar_wait(&bars[0], 0);

    // Masks one tile's scores (s: element i is key block i / 4, row r0 + 8
    // ((i / 2) % 2), key 2 tig + i % 2 of the block) and turns them into
    // weights in place.  alpha rescales the rows' earlier sums (1 in lut
    // mode).  safe: the running max m in log2 units (scale log2(e) folded
    // into one FMA per score, then ex2); lut: the table index without a
    // division (lut.cuh: lut_index_linear_fast).
    const float sc = scale * kLog2e, exp_inv_step = 1.0f / exp_step;
    auto softmax = [&](float (&s)[C::kNB * 4], int t0, float (&alpha)[2]) {
        // element masks only on tiles at the end of the keys, the diagonal or the window edge
        if (t0 + C::kBN > kv_hi || (causal && t0 + C::kBN - 1 > q0) ||
            (window > 0 && q_last - t0 >= window)) {
#pragma unroll
            for (int i = 0; i < C::kNB * 4; ++i) {
                const int qi = q0 + r0 + 8 * ((i >> 1) & 1);
                const int kpos = t0 + 8 * (i >> 2) + 2 * tig + (i & 1);
                const bool ok = kpos < kv_hi && (!causal || kpos <= qi) &&
                                (window <= 0 || qi - kpos < window);
                if (!ok) s[i] = -INFINITY;
            }
        }
        if (lut_mode) {  // no max subtraction: weights straight from the table
            alpha[0] = alpha[1] = 1.0f;
#pragma unroll
            for (int i = 0; i < C::kNB * 4; ++i) {
                const float w = s_exp[lut_index_linear_fast(s[i] * scale, exp_off, exp_step,
                                                             exp_inv_step, kExpSize)];
                s[i] = s[i] == -INFINITY ? 0.0f : w;
                l[(i >> 1) & 1] += s[i];
            }
            return;
        }
        float mt[2] = {-INFINITY, -INFINITY}, mu[2];  // sc > 0: max(s sc) = sc max(s)
#pragma unroll
        for (int i = 0; i < C::kNB * 4; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the 4 threads of a row: lanes 4 g .. 4 g + 3
            mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
            mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
            const float m_new = fmaxf(m[h], mt[h] * sc);
            mu[h] = m_new == -INFINITY ? 0.0f : m_new;  // a row with nothing visible yet
            alpha[h] = ex2_approx(m[h] - mu[h]);        // 0 on the first visible tile
            m[h] = m_new;
            l[h] *= alpha[h];
        }
#pragma unroll
        for (int i = 0; i < C::kNB * 4; ++i) {
            s[i] = ex2_approx(fmaf(s[i], sc, -mu[(i >> 1) & 1]));
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
            scores_bf16<DQK>(s, smem_u32(smem), smem_u32(stage_k(j % kStages)));
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
            issue_scores_bf16<DQK>(s, smem_u32(smem), smem_u32(stage_k(next % kStages)));
            wgmma_commit();
            issue_pv_bf16<DV>(o, pa, smem_u32(stage_v(j % kStages)));
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs(s);
            softmax(s, kv_lo + next * C::kBN, alpha);
            wgmma_wait<0>();
            fence_regs(o);
            fence_regs(pa);
            release(j);
#pragma unroll
            for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        }
        if (j < n_tiles) {
            pack_p(pa, s);
            fence_regs(o);
            wgmma_fence();
            issue_pv_bf16<DV>(o, pa, smem_u32(stage_v(j % kStages)));
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(o);
            fence_regs(pa);
            release(j);
        }
    } else {
        // float32: 3xTF32 on wgmma, one warpgroup.  Per tile j: P(j)'s halves
        // in registers, V(j)^T's and K(j + 1)'s halves into shared memory
        // (which frees stage j for tile j + 2's copy), then S(j + 1) and
        // O += P(j) V(j) issued back to back, and the softmax of tile j + 1 on
        // the CUDA cores while P(j) V(j) is on the tensor cores.
        constexpr int kNB = C::kNB;
        float* ks_f = reinterpret_cast<float*>(smem + C::kKsOffset);
        float* vtb_f = reinterpret_cast<float*>(smem + C::kVtOffset);
        float* vts_f = vtb_f + C::kVtBytes / 4;
        const uint32_t q_a = smem_u32(smem), qs_a = smem_u32(smem + C::kQsOffset);
        const uint32_t ks_a = smem_u32(ks_f), vtb_a = smem_u32(vtb_f), vts_a = smem_u32(vts_f);
        auto to_async = [&] {  // the block's shared-memory writes, visible to wgmma
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            __syncthreads();
        };
        auto split_k = [&](int j) {
            mbar_wait(&bars[1 + j % kStages], (j / kStages) & 1);
            split_k_smem<C::kKBytes>(reinterpret_cast<float*>(stage_k(j % kStages)), ks_f, tid);
        };
        auto transpose_v = [&](int j) {
            transpose_v_smem<DV, C::kBN>(reinterpret_cast<const float*>(stage_v(j % kStages)),
                                         vtb_f, vts_f, tid);
        };
        auto scale_o = [&] {
#pragma unroll
            for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        };
        split_q_smem<C::kQBytes>(reinterpret_cast<float*>(smem),
                                 reinterpret_cast<float*>(smem + C::kQsOffset), tid);
        if (n_tiles > 0) split_k(0);
        to_async();
        uint32_t pb[kNB][4], ps[kNB][4];
        if (n_tiles > 0) {
            fence_regs(s);
            wgmma_fence();
            issue_scores_f32<DQK, C::kBN>(s, q_a, qs_a, smem_u32(stage_k(0)), ks_a);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(s);
            softmax(s, kv_lo, alpha);
        }
        // Steady state; the last tile is peeled off (no wgmma under a condition).
        int j = 0;
        for (; j + 1 < n_tiles; ++j) {
            scale_o();
            split_p(pb, ps, s);
            transpose_v(j);
            split_k(j + 1);
            to_async();
            if (tid == 0 && j + kStages < n_tiles) issue(j + kStages);  // stage j is free
            fence_regs(o);
            fence_regs(pb);
            fence_regs(ps);
            wgmma_fence();
            issue_scores_f32<DQK, C::kBN>(s, q_a, qs_a, smem_u32(stage_k((j + 1) % kStages)),
                                          ks_a);
            wgmma_commit();
            issue_pv_f32<DV, kNB>(o, pb, ps, vtb_a, vts_a);
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs(s);
            softmax(s, kv_lo + (j + 1) * C::kBN, alpha);
            wgmma_wait<0>();
            fence_regs(o);
            fence_regs(pb);
            fence_regs(ps);
        }
        if (j < n_tiles) {
            scale_o();
            split_p(pb, ps, s);
            transpose_v(j);
            to_async();
            fence_regs(o);
            fence_regs(pb);
            fence_regs(ps);
            wgmma_fence();
            issue_pv_f32<DV, kNB>(o, pb, ps, vtb_a, vts_a);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(o);
            fence_regs(pb);
            fence_regs(ps);
        }
    }

    // Merge warpgroup 1's rows into warpgroup 0's through the idle ring.
    if constexpr (G == 2) {
        __syncthreads();
        float* xch = reinterpret_cast<float*>(smem + C::kRingOffset);  // [DV / 2 + 4][128]
        if (wg == 1) {
#pragma unroll
            for (int i = 0; i < DV / 2; ++i) xch[i * 128 + wtid] = o[i];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                xch[(DV / 2 + h) * 128 + wtid] = m[h];
                xch[(DV / 2 + 2 + h) * 128 + wtid] = l[h];
            }
        }
        __syncthreads();
        if (wg == 1) return;
        float a0[2] = {1.0f, 1.0f}, a1[2] = {1.0f, 1.0f};  // lut: plain sums
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float m1 = xch[(DV / 2 + h) * 128 + wtid];
            const float l1 = xch[(DV / 2 + 2 + h) * 128 + wtid];
            if (!lut_mode) {
                const float mm = fmaxf(m[h], m1);  // log2 units
                const float mu = mm == -INFINITY ? 0.0f : mm;
                a0[h] = ex2_approx(m[h] - mu);
                a1[h] = ex2_approx(m1 - mu);
            }
            l[h] = l[h] * a0[h] + l1 * a1[h];
        }
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) {
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
        T* op = out + (static_cast<long long>(bh) * Lq + qi) * DV + 2 * tig;
        if (l[h] == 0.0f && vmean != nullptr) {  // a safe row that saw no key: the mean of V
            const float* vm = vmean + static_cast<long long>(hkv) * DV + 2 * tig;
#pragma unroll
            for (int nb = 0; nb < DV / 8; ++nb) store_pair(op + 8 * nb, vm[8 * nb], vm[8 * nb + 1]);
            continue;
        }
#pragma unroll
        for (int nb = 0; nb < DV / 8; ++nb) {
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

// (cols, L, heads) map of a contiguous (B, H, L, cols) tensor; boxes of 128
// bytes x rows x 1, 128-byte swizzle, zeros past every edge (a box that
// reaches past cols reads nothing there).
template <typename T>
bool encode_map(CUtensorMap* map, const void* base, int cols, int L, int heads, int rows) {
    constexpr cuuint32_t kBoxCols = 128 / sizeof(T);
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(L),
                                static_cast<cuuint64_t>(heads)};
    const cuuint64_t strides[2] = {cols * sizeof(T), static_cast<cuuint64_t>(L) * cols * sizeof(T)};
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
                           const float* exp_tab, const float* inv_tab, const float* vmean,
                           int B, int Hq, int Hkv,
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
        static_cast<T*>(out), exp_tab, inv_tab, vmean, B * Hq, Hq, Hkv, Lq, Lkv, kv_len, causal,
        window, lut_mode, scale, exp_off, exp_step, inv_off, inv_step, slots);
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_small(const void* q, const void* k, const void* v, void* out,
                         const float* exp_tab, const float* inv_tab, const float* vmean,
                         int B, int Hq, int Hkv,
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
                                    k, v, out, exp_tab, inv_tab, vmean, B, Hq, Hkv, Lq, Lkv,     \
                                    kv_len,                                                      \
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

template <typename T, int DQK, int DV, int G>
cudaError_t launch_tc_groups(const void* q, const void* k, const void* v, int dev, int blocks,
                             int heads_per_group, void* out, const float* exp_tab,
                             const float* inv_tab, const float* vmean, int B, int Hq, int Hkv,
                             int Lq, int Lkv,
                             int kv_len, int causal, int window, int lut_mode, float scale,
                             float exp_off, float exp_step, float inv_off, float inv_step,
                             cudaStream_t stream) {
    using C = TcTile<T, DQK, DV, G>;
    CUtensorMap tq, tk, tv;  // K/V boxes of this instance's kBN keys
    if (!encode_map<T>(&tq, q, DQK, Lq, B * Hq, kTcRows) ||
        !encode_map<T>(&tk, k, DQK, Lkv, B * Hkv, C::kBN) ||
        !encode_map<T>(&tv, v, DV, Lkv, B * Hkv, C::kBN)) {
        return cudaErrorInvalidValue;
    }
    static bool opted_in[kMaxDevices] = {};
    if (!opted_in[dev]) {
        const cudaError_t err = cudaFuncSetAttribute(
            tc_attention_kernel<T, DQK, DV, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            C::kSmemBytes);
        if (err != cudaSuccess) return err;
        opted_in[dev] = true;
    }
    tc_attention_kernel<T, DQK, DV, G><<<blocks, C::kThreads, C::kSmemBytes, stream>>>(
        tq, tk, tv, static_cast<T*>(out), exp_tab, inv_tab, vmean, B * Hq, Hq, Hkv, Lq, Lkv,
        kv_len,
        causal, window, lut_mode, scale, exp_off, exp_step, inv_off, inv_step, heads_per_group);
    return cudaGetLastError();
}

// L2 bytes of the current device, once per device.
int l2_bytes(int dev) {
    static int bytes[kMaxDevices] = {};
    if (bytes[dev] == 0) cudaDeviceGetAttribute(&bytes[dev], cudaDevAttrL2CacheSize, dev);
    return bytes[dev];
}

template <typename T, int DQK, int DV>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      const float* exp_tab, const float* inv_tab, const float* vmean, int B,
                      int Hq, int Hkv, int Lq,
                      int Lkv, int kv_len, int causal, int window, int lut_mode, float scale,
                      float exp_off, float exp_step, float inv_off, float inv_step,
                      cudaStream_t stream) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    const int blocks = B * Hq * ((Lq + kTcRows - 1) / kTcRows);
    // Heads per group of the grid order: as many key/value heads as fill a
    // quarter of L2 (at least one), with all the query heads that read them.
    const long long kv_head_bytes = 1LL * Lkv * (DQK + DV) * sizeof(T);
    const long long kv_per_group = std::max(1LL, l2_bytes(dev) / 4 / kv_head_bytes);
    const int heads_per_group =
        static_cast<int>(std::min<long long>(1LL * B * Hq, kv_per_group * (Hq / Hkv)));
#define REPRO_FA_TC(G)                                                                         \
    launch_tc_groups<T, DQK, DV, G>(q, k, v, dev, blocks, heads_per_group, out, exp_tab,       \
                                    inv_tab, vmean, B, Hq, Hkv, Lq, Lkv, kv_len, causal,       \
                                    window,                                                    \
                                    lut_mode, scale, exp_off, exp_step, inv_off, inv_step,     \
                                    stream)
    if constexpr (sizeof(T) == 4) {
        // float32: one warpgroup (two of 32-key tiles measured 3 % slower at
        // the LM shapes, PERF.md)
        err = REPRO_FA_TC(1);
    } else {
        // bf16: two warpgroups per block halve the longest block's key walk
        // where the grid does not fill the SMs; else one, whose smaller ring
        // fits more blocks on an SM
        err = blocks <= sm_count(dev) ? REPRO_FA_TC(2) : REPRO_FA_TC(1);
    }
#undef REPRO_FA_TC
    return err;
}

// The mean of V over all Lkv keys per (batch, kv head), float32, into vmean
// (B Hkv, DV): what a `safe` row that sees no key gives.  Every score of such
// a row is masked, and the plain version's softmax over a row masked
// everywhere weighs every key alike.  One block per (batch, kv head), a
// thread per column; launched only when some row sees no key.
template <typename T>
__global__ void v_mean_kernel(const T* __restrict__ v, float* __restrict__ vmean, int Lkv,
                              int DV) {
    const T* src = v + static_cast<long long>(blockIdx.x) * Lkv * DV;
    for (int c = threadIdx.x; c < DV; c += blockDim.x) {
        float sum = 0.0f;
        for (int j = 0; j < Lkv; ++j) {
            sum += static_cast<float>(src[static_cast<long long>(j) * DV + c]);
        }
        vmean[static_cast<long long>(blockIdx.x) * DV + c] = sum / static_cast<float>(Lkv);
    }
}

// The instances by (q/k head_dim, V head_dim): 8, 16, 32 on the small-head
// kernel, (64, 64), (96, 64) and (128, 128) on the tensor-core one.
template <typename T>
cudaError_t dispatch_d(int D, int DV, const void* q, const void* k, const void* v, void* out,
                       const float* exp_tab, const float* inv_tab, const float* vmean,
                       int B, int Hq, int Hkv, int Lq, int Lkv, int kv_len, int causal, int window,
                       int lut_mode, float scale, float exp_off, float exp_step,
                       float inv_off, float inv_step, cudaStream_t stream) {
#define REPRO_FA_CALL(LAUNCH)                                                     \
    LAUNCH(q, k, v, out, exp_tab, inv_tab, vmean, B, Hq, Hkv, Lq, Lkv, kv_len, causal, \
           window, lut_mode, scale, exp_off, exp_step, inv_off, inv_step, stream)
    if (D == 96 && DV == 64) return REPRO_FA_CALL((launch_tc<T, 96, 64>));
    if (D != DV) return cudaErrorInvalidValue;
    switch (D) {
        case 8:
            return REPRO_FA_CALL((launch_small<T, 8>));
        case 16:
            return REPRO_FA_CALL((launch_small<T, 16>));
        case 32:
            return REPRO_FA_CALL((launch_small<T, 32>));
        case 64:
            return REPRO_FA_CALL((launch_tc<T, 64, 64>));
        case 128:
            return REPRO_FA_CALL((launch_tc<T, 128, 128>));
        default:
            return cudaErrorInvalidValue;
    }
#undef REPRO_FA_CALL
}

}  // namespace
}  // namespace repro_torch

// q (B, Hq, Lq, D), k (B, Hkv, Lkv, D), v (B, Hkv, Lkv, DV), out (B, Hq, Lq,
// DV), all contiguous, dtype 0 = float32, 1 = bfloat16.  window <= 0 means
// no sliding window.  vmean: null, or (B Hkv, DV) float32 scratch that, in
// safe mode, takes the mean of V for the rows that see no key (a window that
// ends before kv_len); the caller passes it when such rows exist.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, const float* exp_tab, const float* inv_tab,
                                     float* vmean, int B, int Hq, int Hkv, int Lq, int Lkv,
                                     int D, int DV, int kv_len, int causal, int window,
                                     int lut_mode, int dtype, float scale, float exp_off,
                                     float exp_step, float inv_off, float inv_step,
                                     void* stream) {
    using namespace repro_torch;
    if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Lq <= 0 || Lkv <= 0 ||
        kv_len <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (lut_mode) vmean = nullptr;  // lut: such a row's sum is 0, and so is its output
    if (vmean != nullptr) {
        if (dtype == 0) {
            v_mean_kernel<float><<<B * Hkv, 128, 0, s>>>(static_cast<const float*>(v), vmean,
                                                         Lkv, DV);
        } else if (dtype == 1) {
            v_mean_kernel<__nv_bfloat16><<<B * Hkv, 128, 0, s>>>(
                static_cast<const __nv_bfloat16*>(v), vmean, Lkv, DV);
        }
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaError_t err;
    if (dtype == 0) {
        err = dispatch_d<float>(D, DV, q, k, v, out, exp_tab, inv_tab, vmean, B, Hq, Hkv, Lq,
                                Lkv, kv_len, causal, window, lut_mode, scale, exp_off,
                                exp_step, inv_off, inv_step, s);
    } else if (dtype == 1) {
        err = dispatch_d<__nv_bfloat16>(D, DV, q, k, v, out, exp_tab, inv_tab, vmean, B, Hq,
                                        Hkv, Lq, Lkv, kv_len, causal, window, lut_mode, scale,
                                        exp_off, exp_step, inv_off, inv_step, s);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
