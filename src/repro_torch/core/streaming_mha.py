"""The paper's 4-stage streaming MHA (Sec. IV-A), int8 inference path.

Stage 1: Q/K/V projections          -> kernels/qmatmul (int8 codes, int32 sums)
Stage 2: Q K^T, scale, softmax      -> fused into kernels/flash_attention
Stage 3: scores x V                 -> (same fused kernel)
Stage 4: concat heads + out proj    -> kernels/qmatmul

On the FPGA the stages talk through FIFOs; here stages 2 and 3 are one
fused kernel and stages 1 and 4 are GEMM kernels over int8 codes, with the
activations quantized per row on the way in.  The layout is the JAX
package's: (batch, seq, d_model) in and out.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import quant
from repro_torch.kernels.flash_attention import mha, mha_ref
from repro_torch.kernels.qmatmul import qmatmul_prequantized


WEIGHTS = ("wq", "wk", "wv", "wo")


@dataclasses.dataclass
class StreamingMHAParams:
    """int8 weights (one scale per output column) and float biases of one
    MHA layer.  ``kmajor`` holds a K-major copy of each weight's codes,
    (d_out, d_in) contiguous: the operand of the card's wgmma route
    (``kernels/qmatmul``), made once with the weights rather than per call."""

    wq: quant.QTensor  # (d_model, n_heads * d_head)
    wk: quant.QTensor
    wv: quant.QTensor
    wo: quant.QTensor  # (n_heads * d_head, d_model)
    bq: torch.Tensor | None = None
    bk: torch.Tensor | None = None
    bv: torch.Tensor | None = None
    bo: torch.Tensor | None = None
    kmajor: dict[str, torch.Tensor] = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.kmajor = {name: getattr(self, name).values.t().contiguous() for name in WEIGHTS}


def quantize_mha_params(wq, wk, wv, wo, bq=None, bk=None, bv=None, bo=None) -> StreamingMHAParams:
    return StreamingMHAParams(
        wq=quant.quantize_int8(wq, axis=1),
        wk=quant.quantize_int8(wk, axis=1),
        wv=quant.quantize_int8(wv, axis=1),
        wo=quant.quantize_int8(wo, axis=1),
        bq=bq, bk=bk, bv=bv, bo=bo,
    )


def int8_linear(x: torch.Tensor, w: quant.QTensor, bias: torch.Tensor | None,
                w_kmajor: torch.Tensor | None = None) -> torch.Tensor:
    """Stage 1 / 4 GEMM on (rows, d_in): per-row activation codes times the
    prequantized weight codes (``w_kmajor``: their K-major copy), dequantized,
    plus the float bias."""
    out = qmatmul_prequantized(quant.quantize_int8(x, axis=0), w, w_kmajor=w_kmajor)
    return out if bias is None else out + bias


def split_heads(t: torch.Tensor, b: int, s: int, n_heads: int) -> torch.Tensor:
    """(b * s, n_heads * d_head) -> contiguous (b, n_heads, s, d_head)."""
    return t.reshape(b, s, n_heads, -1).transpose(1, 2).contiguous()


def streaming_mha(
    x: torch.Tensor,  # (batch, seq, d_model)
    params: StreamingMHAParams,
    *,
    n_heads: int,
    causal: bool = False,
    window: int | None = None,
    softmax_mode: str = "lut",  # the paper's datapath
) -> torch.Tensor:
    """Runs where ``x`` lies: the kernels on a CUDA tensor, their plain
    versions on a CPU tensor."""
    b, s, d_model = x.shape
    flat = x.reshape(b * s, d_model)
    # ---- Stage 1: linear projections
    km = params.kmajor
    q = split_heads(int8_linear(flat, params.wq, params.bq, km["wq"]), b, s, n_heads)
    k = split_heads(int8_linear(flat, params.wk, params.bk, km["wk"]), b, s, n_heads)
    v = split_heads(int8_linear(flat, params.wv, params.bv, km["wv"]), b, s, n_heads)
    # ---- Stages 2 + 3: fused scores / softmax / weighted sum
    o = mha(q, k, v, causal=causal, window=window, mode=softmax_mode)
    # ---- Stage 4: concat heads + output projection
    o = o.transpose(1, 2).reshape(b * s, -1)
    return int8_linear(o, params.wo, params.bo, km["wo"]).reshape(b, s, -1)


def streaming_mha_float_ref(
    x: torch.Tensor, wq, wk, wv, wo, *, n_heads: int, causal: bool = False,
    window: int | None = None,
) -> torch.Tensor:
    """Float oracle of the whole pipeline (float32 products, exact softmax,
    the plain attention on every device)."""
    b, s, _ = x.shape
    q, k, v = (split_heads(x @ w, b, s, n_heads) for w in (wq, wk, wv))
    o = mha_ref(q, k, v, causal=causal, window=window, mode="safe")
    return o.transpose(1, 2).reshape(b, s, -1) @ wo
