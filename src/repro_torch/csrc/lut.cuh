// Lookup-table indexing shared by the port's kernels.
//
// Must pick the same entry as repro_torch.core.lut.lut_index (and the JAX
// reference's core/lut.py:60-69): float32 arithmetic with the spec's offset
// and step already rounded to float32 by the caller, round half to even
// (rintf, not roundf or floorf(x + 0.5f)), then saturate to [0, size - 1].
// Log-spaced tables index log2(max(x, 1e-30)).
#pragma once

#include <math.h>

namespace repro_torch {

__device__ __forceinline__ int lut_index_linear(float x, float offset, float step, int size) {
    float idx = rintf((x - offset) / step);
    idx = fminf(fmaxf(idx, 0.0f), static_cast<float>(size - 1));
    return static_cast<int>(idx);
}

// lut_index_linear without a division, a float-to-int conversion or a
// branch, for unrolled loops: the same index.  inv_step = 1.0f / step,
// correctly rounded.  q = d * inv_step is within an ulp or so of d / step;
// r = d - q * step is exact in one FMA, and q + r * inv_step rounded once
// is then the correctly rounded quotient d / step (Markstein's theorem; no
// operand here over- or underflows, and a -inf score gives NaN, which the
// clamp maps to entry 0).  Clamping before rounding gives the same index,
// the bounds being integers; adding 1.5 * 2^23 rounds a float in [0, 2^22)
// to an integer (half to even, as rintf), which then sits in the low bits
// of the sum.
__device__ __forceinline__ int lut_index_linear_fast(float x, float offset, float step,
                                                     float inv_step, int size) {
    constexpr float kRound = 12582912.0f;  // 1.5 * 2^23
    const float d = __fsub_rn(x, offset);
    const float q = __fmul_rn(d, inv_step);
    const float quot = __fmaf_rn(__fmaf_rn(-q, step, d), inv_step, q);
    const float idx = fminf(fmaxf(quot, 0.0f), static_cast<float>(size - 1));
    return __float_as_int(__fadd_rn(idx, kRound)) - __float_as_int(kRound);
}

__device__ __forceinline__ int lut_index_log(float x, float offset, float step, int size) {
    return lut_index_linear(log2f(fmaxf(x, 1e-30f)), offset, step, size);
}

// Butterfly sum over groups of `width` adjacent lanes (width a power of two
// <= 32).  Every lane of a group ends with the bitwise-same value, because
// each step adds the same two operands on both partners.
template <int width>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
    for (int off = width / 2; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    return v;
}

}  // namespace repro_torch
