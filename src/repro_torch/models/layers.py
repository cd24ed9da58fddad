"""Shared primitive layers: dense (quantizable), norm (kernel-backed),
activations, token embedding and the tied unembedding."""

from __future__ import annotations

import torch

from repro_torch.kernels.layernorm import layernorm
from repro_torch.models.params import ArraySpec


def dense_spec(
    d_in: int,
    d_out: int,
    *,
    axes=("embed", "mlp"),
    bias: bool = False,
    dtype=torch.float32,
    init: str = "fan_in",
):
    spec = {"kernel": ArraySpec((d_in, d_out), dtype, tuple(axes), init)}
    if bias:
        spec["bias"] = ArraySpec((d_out,), dtype, (axes[1],), "zeros")
    return spec


def dense(params, x: torch.Tensor, quant_cfg=None) -> torch.Tensor:
    """x @ kernel (+ bias), kernel laid out (d_in, d_out), with the
    precision plan's fake-quant hooks."""
    w = params["kernel"]
    if quant_cfg is not None:
        w = quant_cfg.maybe_fake_quant_weight(w)
        x = quant_cfg.maybe_fake_quant_act(x)
    y = torch.matmul(x, w)
    if "bias" in params:
        y = y + params["bias"]
    return y


def norm_spec(d: int, kind: str, dtype=torch.float32):
    if kind == "none":
        return {}
    spec = {"scale": ArraySpec((d,), dtype, ("embed",), "ones")}
    if kind == "layernorm":
        spec["bias"] = ArraySpec((d,), dtype, ("embed",), "zeros")
    return spec


def norm(
    params, x: torch.Tensor, kind: str, eps: float = 1e-5, use_lut: bool = False
) -> torch.Tensor:
    """Staged LayerNorm / RMSNorm through the layernorm kernel, which reads
    ``x`` and the params in their own dtypes, computes in float32 and returns
    ``x.dtype``; ``use_lut`` selects the paper's 1/sqrt-LUT datapath."""
    if kind == "none":
        return x
    if kind not in ("layernorm", "rmsnorm"):
        raise ValueError(f"unknown norm kind {kind}")
    rms = kind == "rmsnorm"
    return layernorm(x, params["scale"], None if rms else params["bias"],
                     use_lut=use_lut, rms=rms, eps=eps)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return torch.nn.functional.silu(x)
    if kind == "gelu":  # jax.nn.gelu defaults to the tanh approximation
        return torch.nn.functional.gelu(x, approximate="tanh")
    if kind == "relu":
        return torch.relu(x)
    raise ValueError(f"unknown activation {kind}")


def embedding_spec(vocab: int, d: int, dtype=torch.float32):
    return {"table": ArraySpec((vocab, d), dtype, ("vocab", "embed"), "embed", init_scale=0.02)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: x @ table.T"""
    return torch.matmul(x, params["table"].t())
