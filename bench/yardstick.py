"""The benchmark's frozen arithmetic: the H100's published peaks and the
work of the two hand-written kernels the cells drive, so that no change to
the program moves the yardstick.  A model family's FLOPs sit in its
reference module (``bench/references/<reference>.py``), which its ``mfu``
reader takes.

The kernel costs are a copy of ``repro_torch.roofline.kernel_costs``
(``flash_attention``, ``layernorm``) and the peaks of
``repro_torch.core.latency_model.H100``, as they stood when the benchmark
was written.  A kernel's roofline share is its bound (the larger of its
operations over the peak of their type and its bytes over HBM bandwidth)
divided by its measured device time.
"""

from __future__ import annotations

import dataclasses
import math

#: dense peaks of one H100 SXM5 at its 700 W limit, by the type the work runs
#: in (NVIDIA's data sheet); "tf32x3" is float32 work done as three TF32
#: products on the tensor cores, a third of the TF32 rate
PEAKS = {
    "float32": 67e12,
    "tf32": 495e12,
    "tf32x3": 495e12 / 3,
    "bfloat16": 989e12,
    "float16": 989e12,
    "int8": 1979e12,
}
HBM_BYTES_PER_S = 3.35e12
LUT_TABLE_BYTES = (1024 + 4096) * 4  # the exp and 1/x tables, float32
RSQRT_TABLE_BYTES = 4096 * 4  # the 1/sqrt table, float32
_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


@dataclasses.dataclass(frozen=True)
class KernelCost:
    flops: dict  # {type the work runs in: operations}
    bytes: float

    def bound_s(self) -> float:
        """The least seconds the card could take for this call."""
        t_ops = math.fsum(f / PEAKS[t] for t, f in self.flops.items())
        return max(t_ops, self.bytes / HBM_BYTES_PER_S)


def attention_pairs(lq: int, lkv: int, causal: bool) -> float:
    """The (query, key) pairs a mask lets through, a causal diagonal at half
    weight (a causal square of L queries counts L²/2)."""
    if not causal:
        return float(lq * lkv)
    full = sum(min(q + 1, lkv) for q in range(lq)) if lq != lkv else lq * (lq + 1) / 2
    return float(full - min(lq, lkv) / 2)


def flash_attention(b: int, hq: int, hkv: int, lq: int, lkv: int, d: int, dv: int, dtype: str,
                    causal: bool, mode: str) -> KernelCost:
    """One attention call: QKᵀ at d and P·V at dv over the mask's pairs;
    q, k, v read and the output written once, the tables in ``lut`` mode."""
    pairs = attention_pairs(lq, lkv, causal)
    es = _ITEMSIZE[dtype]
    nbytes = es * (b * hq * lq * d + b * hkv * lkv * (d + dv) + b * hq * lq * dv)
    if mode == "lut":
        nbytes += LUT_TABLE_BYTES
    kind = "tf32x3" if dtype == "float32" else dtype
    return KernelCost({kind: 2.0 * b * hq * pairs * (d + dv)}, float(nbytes))


def layernorm(rows: int, k: int, dtype: str, param_dtype: str, rms: bool,
              use_lut: bool) -> KernelCost:
    """One staged LayerNorm / RMSNorm of (rows, k): ~8 float32 operations per
    element; x read, the output written, gamma (and beta) read once."""
    nbytes = 2 * rows * k * _ITEMSIZE[dtype] + (1 if rms else 2) * k * _ITEMSIZE[param_dtype]
    if use_lut:
        nbytes += RSQRT_TABLE_BYTES
    return KernelCost({"float32": 8.0 * rows * k}, float(nbytes))
