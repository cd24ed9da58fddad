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
