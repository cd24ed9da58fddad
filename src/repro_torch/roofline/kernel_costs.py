"""The work of each hand-written kernel as a function of its call.

One function per kernel (``flash_attention``, ``layernorm``, ``qmatmul``,
``lut_softmax``, ``ssd_scan``), of the shapes, types and mode a wrapper
hands the kernel.  Each returns a :class:`KernelCost`: the operations the
function needs, by the type they run in on the card, and its bytes with
every input read once and every output written once.  The count is the
function's, not a route's: a zero-padded head_dim, ``wgmma`` or
``mma.sync`` leave it as it is.

An attention call counts the (query, key) pairs its mask lets through
(causal, window, ``kv_len``), a causal call's diagonal at half weight: a
causal square of L queries counts L²/2 pairs, the reference's
``roofline.analysis.attention_flops`` convention, so that the prefill
calls of a cell sum to it.  Its bytes are those of its own types (the
reference's ``attention_io_bytes`` counts every element at 2 bytes).
float32 attention and SSD work runs on the tensor cores as three TF32
products (``tf32x3``); the norms and the LUT softmax are float32 work on
the CUDA cores.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.latency_model import H100, HardwareSpec, compute_seconds

LUT_TABLE_BYTES = (1024 + 4096) * 4  # the exp and 1/x tables, float32
RSQRT_TABLE_BYTES = 4096 * 4  # the 1/sqrt table, float32


@dataclasses.dataclass(frozen=True)
class KernelCost:
    kernel: str
    flops: dict[str, float]  # {type the work runs in: operations}
    bytes: float

    @property
    def total_flops(self) -> float:
        return math.fsum(self.flops.values())

    def bound(self, hw: HardwareSpec = H100) -> tuple[float, str]:
        """(least ms the card could take, "operations" or "bytes"): the
        larger of the operations at their peaks and the bytes over HBM."""
        t_ops, t_bytes = compute_seconds(self.flops, hw), self.bytes / hw.hbm_bw
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _type(dtype) -> str:
    """A torch dtype (or its name) as a type name: ``torch.bfloat16`` ->
    ``"bfloat16"``."""
    return str(dtype).removeprefix("torch.")


def _itemsize(dtype) -> int:
    return {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
            "int32": 4}[_type(dtype)]


def attention_pairs(lq: int, lkv: int, *, causal: bool, window: int | None,
                    kv_len: int | None) -> float:
    """The (query, key) pairs of ``mha``'s mask (key < kv_len, key <= query
    when causal, query - key < window), a causal call's diagonal counted
    half."""
    kv_len = lkv if kv_len is None else kv_len
    q = np.arange(lq, dtype=np.int64)
    hi = np.minimum(kv_len - 1, q) if causal else np.full(lq, kv_len - 1, dtype=np.int64)
    lo = np.maximum(0, q - window + 1) if window is not None else np.zeros(lq, dtype=np.int64)
    pairs = float(np.clip(hi - lo + 1, 0, None).sum())
    if causal:  # the diagonal (query == key) lies in the mask wherever key < kv_len
        pairs -= min(lq, kv_len) / 2
    return pairs


def flash_attention(b: int, hq: int, hkv: int, lq: int, lkv: int, d: int, dv: int, dtype,
                    *, causal: bool = False, window: int | None = None, mode: str = "safe",
                    kv_len: int | None = None) -> KernelCost:
    """``mha`` of q (b, hq, lq, d), k (b, hkv, lkv, d), v (b, hkv, lkv, dv):
    QKᵀ at d and P·V at dv over the mask's pairs; q, k, v read and the
    (b, hq, lq, dv) output written once, and the LUT tables in ``lut``
    mode."""
    pairs = attention_pairs(lq, lkv, causal=causal, window=window, kv_len=kv_len)
    t = _type(dtype)
    es = _itemsize(t)
    nbytes = es * (b * hq * lq * d + b * hkv * lkv * (d + dv) + b * hq * lq * dv)
    if mode == "lut":
        nbytes += LUT_TABLE_BYTES
    flops = 2.0 * b * hq * pairs * (d + dv)
    return KernelCost("flash_attention", {"tf32x3" if t == "float32" else t: flops},
                      float(nbytes))


def layernorm(rows: int, k: int, dtype, *, rms: bool, use_lut: bool = False,
              param_dtype=None) -> KernelCost:
    """The staged LayerNorm / RMSNorm of (rows, k): ~8 float32 operations
    per element; x read, the output written, gamma (and LayerNorm's beta)
    read once, and the 1/sqrt table with ``use_lut``."""
    es = _itemsize(dtype)
    pes = es if param_dtype is None else _itemsize(param_dtype)
    nbytes = 2 * rows * k * es + (1 if rms else 2) * k * pes
    if use_lut:
        nbytes += RSQRT_TABLE_BYTES
    return KernelCost("layernorm", {"float32": 8.0 * rows * k}, float(nbytes))


def qmatmul(m: int, k: int, n: int) -> KernelCost:
    """int8 codes (m, k) x (k, n) with float32 row and column scales into a
    float32 (m, n): 2mnk int8 operations."""
    return KernelCost("qmatmul", {"int8": 2.0 * m * n * k},
                      float(m * k + k * n + 4 * (m + n) + 4 * m * n))


def lut_softmax(rows: int, k: int) -> KernelCost:
    """The LUT softmax of float32 (rows, k): ~4 float32 operations per
    score (index, sum, multiply); the scores read, the output written, the
    two tables read."""
    return KernelCost("lut_softmax", {"float32": 4.0 * rows * k},
                      float(8 * rows * k + LUT_TABLE_BYTES))


def ssd_scan(b: int, l: int, h: int, p: int, n: int, groups: int, chunk: int,
             dtype) -> KernelCost:
    """The chunked SSD scan of xdt (b, l, h, p), a (b, l, h), B and C
    (b, l, groups, n): per chunk of q = min(chunk, l), q(q+1)N operations
    per group (the lower triangle of C Bᵀ) and q(q+1)P + 4qPN per head (the
    lower triangle of G·xdt, C·S_in and the chunk state); each input read
    once, y and the float32 final state written once."""
    t = _type(dtype)
    es = _itemsize(t)
    q = min(chunk, l)
    nc = l // q
    flops = b * nc * (groups * q * (q + 1) * n + h * (q * (q + 1) * p + 4 * q * p * n))
    nbytes = es * (2 * b * l * h * p + b * l * h + 2 * b * l * groups * n) + 4 * b * h * p * n
    return KernelCost("ssd_scan", {"tf32x3" if t == "float32" else t: float(flops)},
                      float(nbytes))
