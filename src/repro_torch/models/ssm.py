"""Mamba2 / SSD (state-space duality, arXiv:2405.21060), port of
``repro.models.ssm``.

Train/prefill run the chunked SSD scan through ``kernels.ssd_scan`` (the
hand-written kernel on the card, the plain ``ssd_chunked`` on the CPU), where
the reference calls its jnp ``ssd_chunked``: the same function.  Decode is
the O(1) single-token state update in plain torch, as in the reference.
``ssd_chunked`` and the naive recurrence live with the kernel's plain
version (``kernels/ssd_scan/ref.py``) and are re-exported here.

Under a model group whose layout splits the SSM heads
(``distributed.tensor_parallel``) each rank runs its heads: ``in_proj``,
``conv_w`` and ``conv_b`` come whole and are narrowed to its heads' ``z``,
``x`` and ``dt`` columns and the whole ``B`` / ``C`` (one group, which
every head reads)
(``tensor_parallel.ssm_columns``), ``A_log`` / ``dt_bias`` / ``D`` to its
heads, the scan runs over them, the local ``y`` is gathered for
``gate_norm`` (one RMSNorm over the whole ``inner``, so the layernorm
kernel runs on whole rows, repeated on every rank), and the normed rows'
local columns go through ``out_proj`` row-parallel.  Gathering ``y`` keeps
the kernel and every unsharded bit of the norm; the alternative, an
all-reduce of the squares under a norm of its own, would not.  The caches
hold the local heads' state and the local ``x`` with the whole ``B`` /
``C`` (``tensor_parallel.local_caches``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import tensor_parallel as tp_lib
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


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor, h: int | None = None):
    """(z, xBC, dt) of ``in_proj``'s output at ``h`` heads (default all;
    a rank's under the split, whose columns ``tensor_parallel.ssm_columns``
    packs in the same order)."""
    s = cfg.ssm
    h = s.n_heads(cfg.d_model) if h is None else h
    di = h * s.head_dim
    gn = s.n_groups * s.state_dim
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


def _local_params(params, cfg: ModelConfig, tp):
    """The leaves this rank's heads use, entered into its work: in_proj's
    and the conv's columns, A_log / dt_bias / D's heads."""
    lo, hi = tp_lib.ssm_head_range(cfg, tp)
    out = dict(params)
    out["in_proj"] = {k: tp_lib.enter(t, tp).index_select(
        -1, tp_lib.ssm_columns(cfg, tp, "zxbcdt").to(t.device))
        for k, t in params["in_proj"].items()}
    cols = tp_lib.ssm_columns(cfg, tp, "xbc").to(params["conv_w"].device)
    for name in ("conv_w", "conv_b"):
        out[name] = tp_lib.enter(params[name], tp).index_select(-1, cols)
    for name in ("A_log", "dt_bias", "D"):
        out[name] = tp_lib.enter(params[name], tp).narrow(0, lo, hi - lo)
    return out, lo, hi - lo


def mamba_apply(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (b, l, d)
    *,
    mode: str = "train",
    cache: dict | None = None,
    quant=None,  # per-layer runtime hook from the precision plan
    group=None,  # tensor_parallel.ModelGroup: split by SSM heads where its layout says
) -> tuple[torch.Tensor, dict | None]:
    """Returns (out (b, l, d), new_cache); the cache tensors are new, the
    caller's are never written.  Under ``group`` (module docstring) the
    cache is this rank's."""
    s = cfg.ssm
    qc = cfg.quant if quant is None else quant
    b, l, d = x.shape
    p = s.head_dim
    g = s.n_groups
    n = s.state_dim
    f32 = torch.float32
    tp = tp_lib.active(group)
    if tp is not None and not tp.layout.ssm:
        tp = None  # the SSM heads do not split: the block repeats on every rank
    lo, h, full = 0, s.n_heads(d), params
    if tp is not None:
        params, lo, h = _local_params(params, cfg, tp)
        x = tp_lib.enter(x, tp)
    di = h * p

    zxbcdt = layers.dense(params["in_proj"], x, qc)
    z, xbc, dt = _split_proj(cfg, zxbcdt, h)
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
    if tp is None:
        y = layers.norm(params["gate_norm"], y, "rmsnorm", cfg.norm_eps)
        return layers.dense(params["out_proj"], y, qc), new_cache
    y = layers.norm(full["gate_norm"], tp_lib.gather(y, tp, -1), "rmsnorm", cfg.norm_eps)
    y = tp_lib.enter(y, tp).narrow(-1, lo * p, di)
    return layers.row_parallel_dense(full["out_proj"], y, tp, qc), new_cache
