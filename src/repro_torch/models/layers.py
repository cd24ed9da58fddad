"""Shared primitive layers: dense (quantizable), norm (kernel-backed), rotary
position embedding, activations, token embedding and the tied unembedding;
under a model group (``distributed.tensor_parallel``) the row-parallel
dense, the vocab-parallel embedding and the vocab-local unembedding."""

from __future__ import annotations

import torch

from repro_torch.distributed import tensor_parallel as tp_lib
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
    precision plan's fake-quant hooks.  Mixed operand types promote as
    ``jnp.einsum`` promotes them: a bfloat16 kernel against float32 ``x``
    goes up to float32 (MLA's projections of the float32 latent)."""
    w = params["kernel"]
    if quant_cfg is not None:
        w = quant_cfg.maybe_fake_quant_weight(w)
        x = quant_cfg.maybe_fake_quant_act(x)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = torch.matmul(x, w)
    if "bias" in params:
        y = y + params["bias"]
    return y


def row_parallel_dense(params, x: torch.Tensor, group, quant_cfg=None) -> torch.Tensor:
    """``dense`` with the kernel's input rows split over ``group``: ``x``
    holds this rank's columns of the input, the partial products are
    all-reduced, and the bias (replicated) is added once, after."""
    y = tp_lib.reduce(dense({"kernel": params["kernel"]}, x, quant_cfg), group)
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


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """The (head_dim / 2,) float32 rotary frequencies theta^(-2i / head_dim)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """float32 cos and sin of the rotary angles, (..., seq, head_dim / 2)
    for ``positions`` (..., seq)."""
    angles = positions[..., :, None].to(torch.float32) * rope_freqs(head_dim, theta,
                                                                    positions.device)
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs formed by the two halves of the head (not
    interleaved pairs) of ``x`` (..., seq, head_dim) in float32; the result
    in x's dtype, a fresh contiguous tensor."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding of ``x`` (..., seq, head_dim) at
    ``positions``, which broadcast against x's leading axes with a seq axis
    last: (seq,) in train and prefill, (B, 1, 1) in decode, (B, 1, seq) in
    extend."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


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


def embed(params, tokens: torch.Tensor, group=None) -> torch.Tensor:
    """The table's rows at ``tokens``.  With ``group``, the table holds this
    rank's even shard of the rows: ids outside it look up zeros, and the
    group's lookups are all-reduced."""
    table = params["table"]
    if group is None:
        return table[tokens]
    lo = group.rank * table.shape[0]
    local = tokens - lo
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(inside, local, 0)] * inside[..., None].to(table.dtype)
    return tp_lib.reduce(rows, group)


def unembed(params, x: torch.Tensor, group=None) -> torch.Tensor:
    """Tied unembedding: x @ table.T; with ``group``, this rank's vocab
    columns of it (the table's rows that the rank holds)."""
    if group is not None:
        x = tp_lib.enter(x, group)
    return torch.matmul(x, params["table"].t())
