"""Mamba2 / SSD (state-space duality, arXiv:2405.21060), port of
``repro.models.ssm``.

Train/prefill run the chunked SSD scan through ``kernels.ssd_scan`` (the
hand-written kernel on the card, the plain ``ssd_chunked`` on the CPU), where
the reference calls its jnp ``ssd_chunked``: the same function.  Decode is
the O(1) single-token state update in plain torch, as in the reference.
``ssd_chunked`` and the naive recurrence live with the kernel's plain
version (``kernels/ssd_scan/ref.py``) and are re-exported here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ssd_scan import ssd_with_state
from repro_torch.kernels.ssd_scan.ref import _segsum, ssd_chunked, ssd_naive_ref  # noqa: F401
from repro_torch.models import layers
from repro_torch.models.params import ArraySpec

# ---------------------------------------------------------------------------
# Param spec
# ---------------------------------------------------------------------------


def mamba_spec(cfg: ModelConfig, dtype=torch.float32):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    h = s.n_heads(d)
    conv_dim = di + 2 * s.n_groups * s.state_dim
    d_in_proj = 2 * di + 2 * s.n_groups * s.state_dim + h
    return {
        "in_proj": layers.dense_spec(d, d_in_proj, axes=("embed", "inner"), dtype=dtype),
        "conv_w": ArraySpec((s.conv_width, conv_dim), dtype, (None, "inner"), "fan_in"),
        "conv_b": ArraySpec((conv_dim,), dtype, ("inner",), "zeros"),
        "A_log": ArraySpec((h,), torch.float32, ("ssm_heads",), "zeros"),
        "dt_bias": ArraySpec((h,), torch.float32, ("ssm_heads",), "zeros"),
        "D": ArraySpec((h,), torch.float32, ("ssm_heads",), "ones"),
        "gate_norm": layers.norm_spec(di, "rmsnorm", dtype),
        "out_proj": layers.dense_spec(di, d, axes=("inner", "embed"), dtype=dtype),
    }


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


def ssd_step(
    state: torch.Tensor,  # (b, h, p, n)
    x: torch.Tensor,  # (b, h, p) single token (NOT pre-multiplied by dt)
    dt: torch.Tensor,  # (b, h)
    a_log_decay: torch.Tensor,  # (b, h) = dt * A
    bvec: torch.Tensor,  # (b, h, n)
    cvec: torch.Tensor,  # (b, h, n)
) -> tuple[torch.Tensor, torch.Tensor]:
    """O(1) decode update: h' = exp(dt*A) h + dt * x B^T ;  y = C . h'."""
    da = torch.exp(a_log_decay)[..., None, None]
    upd = torch.einsum("bhp,bhn->bhpn", x * dt[..., None], bvec)
    new_state = state * da + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, cvec)
    return y, new_state


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0); F.softplus switches to x above
    its threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, x (b, l, c), w (width, c): out_t =
    sum_k w[k] x[t - (width - 1) + k] + b (a cross-correlation, as the
    reference's ``conv_general_dilated``)."""
    width, c = w.shape
    xp = F.pad(x.transpose(1, 2), (width - 1, 0))  # (b, c, l + width - 1)
    out = F.conv1d(xp, w.t().reshape(c, 1, width), groups=c)
    return out.transpose(1, 2) + b


def mamba_cache_spec(cfg: ModelConfig, batch: int, dtype=torch.float32) -> dict:
    """{name: (shape, dtype)} of one layer's decode cache."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    h = s.n_heads(d)
    conv_dim = di + 2 * s.n_groups * s.state_dim
    return {
        "ssm_state": ((batch, h, s.head_dim, s.state_dim), dtype),
        "conv_state": ((batch, s.conv_width - 1, conv_dim), dtype),
    }


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in mamba_cache_spec(cfg, batch, dtype).items()}


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.state_dim
    h = s.n_heads(cfg.d_model)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    assert dt.shape[-1] == h, (dt.shape, h)
    return z, xbc, dt


def _expand_groups(t: torch.Tensor, h: int, g: int) -> torch.Tensor:
    """(b, l, g*n) -> (b, l, h, n) broadcasting groups across heads."""
    b, l, _ = t.shape
    n = t.shape[-1] // g
    return t.reshape(b, l, g, n).repeat_interleave(h // g, dim=2)


def mamba_apply(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (b, l, d)
    *,
    mode: str = "train",
    cache: dict | None = None,
    quant=None,  # per-layer runtime hook from the precision plan
) -> tuple[torch.Tensor, dict | None]:
    """Returns (out (b, l, d), new_cache); the cache tensors are new, the
    caller's are never written."""
    s = cfg.ssm
    qc = cfg.quant if quant is None else quant
    b, l, d = x.shape
    di = s.d_inner(d)
    h = s.n_heads(d)
    p = s.head_dim
    g = s.n_groups
    n = s.state_dim
    f32 = torch.float32

    zxbcdt = layers.dense(params["in_proj"], x, qc)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    dt = _softplus(dt.to(f32) + params["dt_bias"])  # (b, l, h)
    a_neg = -torch.exp(params["A_log"])  # (h,) negative decay rates

    new_cache = cache
    if mode == "decode" and cache is not None:
        # conv over the rolling window of the last width - 1 inputs
        window = torch.cat([cache["conv_state"], xbc.to(f32)], dim=1)
        conv_out = (
            torch.einsum("bwc,wc->bc", window, params["conv_w"].to(f32))
            + params["conv_b"].to(f32)
        )[:, None]
        new_conv_state = window[:, 1:].to(cache["conv_state"].dtype)
        xbc_c = F.silu(conv_out)
        x_in = xbc_c[..., :di].reshape(b, 1, h, p)[:, 0]
        bmat = _expand_groups(xbc_c[..., di: di + g * n], h, g)[:, 0]
        cmat = _expand_groups(xbc_c[..., di + g * n:], h, g)[:, 0]
        dt0 = dt[:, 0]
        y, new_state = ssd_step(
            cache["ssm_state"].to(f32), x_in.to(f32), dt0, dt0 * a_neg,
            bmat.to(f32), cmat.to(f32),
        )
        y = y + x_in.to(f32) * params["D"][:, None]
        y = y.reshape(b, 1, di).to(x.dtype)
        new_cache = {
            "ssm_state": new_state.to(cache["ssm_state"].dtype),
            "conv_state": new_conv_state,
        }
    else:
        xbc_c = F.silu(_causal_conv(xbc, params["conv_w"], params["conv_b"]))
        x_in = xbc_c[..., :di].reshape(b, l, h, p)
        xdt = (x_in.to(f32) * dt[..., None]).contiguous()
        a = (dt * a_neg).contiguous()  # (b, l, h)
        bg = xbc_c[..., di: di + g * n].to(f32).reshape(b, l, g, n).contiguous()
        cg = xbc_c[..., di + g * n:].to(f32).reshape(b, l, g, n).contiguous()
        # the kernel on the card, ssd_chunked on the CPU; B and C by group
        y, final_state = ssd_with_state(xdt, a, bg, cg, chunk=min(s.chunk_size, l))
        y = y + x_in.to(f32) * params["D"].reshape(1, 1, h, 1)
        y = y.reshape(b, l, di).to(x.dtype)
        if cache is not None:  # prefill: hand the final state to decode
            width = s.conv_width
            tail = xbc[:, -(width - 1):].to(f32)  # the pre-conv inputs
            if l < width - 1:
                tail = F.pad(tail, (0, 0, width - 1 - l, 0))
            new_cache = {
                "ssm_state": final_state.to(cache["ssm_state"].dtype),
                "conv_state": tail.to(cache["conv_state"].dtype),
            }

    # gated output: RMSNorm(y * silu(z)) -> out_proj
    y = y * F.silu(z)
    y = layers.norm(params["gate_norm"], y, "rmsnorm", cfg.norm_eps)
    return layers.dense(params["out_proj"], y, qc), new_cache
