"""GQA/MHA attention (port of ``repro.models.attention``): ``train`` over a
whole sequence, ``prefill`` over a dense KV cache or a rolling
sliding-window buffer, ``decode`` over those or a paged cache
(``serve.kv_cache``).

Train and prefill attend through the fused attention kernel (``mha``); the
decode attend is plain torch ops, as the reference's is plain jnp.  A paged
decode writes its token through ``kv_cache.paged_decode_write`` and attends
the dense view ``kv_cache.paged_decode_view`` gathers.

A cache that carries ``k_scale`` / ``v_scale`` is the int8 KV cache
(``int8_serve``): k/v are stored as per-(token, head) symmetric int8 codes
(``_kv_quantize``) with float32 scales; prefill attends the cache's own
dequantized representation (float32, through the kernel's float32 route),
so the values it scores are those decode reads back.  Not ported yet:
``mode="extend"`` (ROADMAP queue 1, item 8, step 5) and MLA (item 9).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import scalar
from repro_torch.kernels.flash_attention import mha
from repro_torch.models import layers
from repro_torch.serve import kv_cache as kv_cache_lib

MODES = ("train", "prefill", "extend", "decode")


def gqa_spec(cfg: ModelConfig, dtype=torch.float32):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": layers.dense_spec(d, h * hd, axes=("embed", "heads"), bias=cfg.attn_bias, dtype=dtype),
        "wk": layers.dense_spec(d, hkv * hd, axes=("embed", "kv_heads"), bias=cfg.attn_bias, dtype=dtype),
        "wv": layers.dense_spec(d, hkv * hd, axes=("embed", "kv_heads"), bias=cfg.attn_bias, dtype=dtype),
        "wo": layers.dense_spec(h * hd, d, axes=("heads", "embed"), bias=cfg.attn_bias, dtype=dtype),
    }


def attention_spec(cfg: ModelConfig, dtype=torch.float32):
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"attn_kind {cfg.attn_kind!r} is not ported yet (ROADMAP queue 1, item 9)"
        )
    return gqa_spec(cfg, dtype)


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim).transpose(1, 2).contiguous()


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _check_cache(cache, mode: str) -> None:
    if kv_cache_lib.is_paged(cache) and mode != "decode":
        raise ValueError(
            "a paged cache takes decode writes only: prefill fills a dense scratch "
            "cache, which CacheManager.insert_prefill scatters into the pages"
        )


def _kv_quantize(x: torch.Tensor):
    """(b, h, s, d) -> (int8 codes, float32 scales (b, h, s)): per-token-head
    symmetric int8, the paper's fixed-point datapath applied to the KV
    cache.  The scale is divided by a device scalar (CUDA's division by a
    Python number is a reciprocal multiply); rounding is half to even, as
    ``jnp.round``."""
    amax = torch.amax(torch.abs(x), dim=-1)
    scale = torch.clamp_min(amax, 1e-8) / scalar(127.0, amax.dtype, str(amax.device))
    codes = torch.clamp(torch.round(x / scale[..., None]), -128, 127).to(torch.int8)
    return codes, scale.to(torch.float32)


def _dequantize(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes (..., L, D) and float32 scales (..., L) -> float32."""
    return codes.float() * scale[..., None]


def _prefill_write(cache, rows: dict[str, torch.Tensor], positions: torch.Tensor,
                   window: int | None) -> None:
    """Write a prompt's rows into ``cache`` in place: k/v (B, Hkv, S, D) and,
    for the int8 cache, their scales (B, Hkv, S); at offset 0 of a dense
    slab, or, for a rolling buffer, its last ``window`` positions at
    ``pos % window`` over an emptied buffer (slot positions of the rest
    -1).  A negative position is dropped, as the reference's scatter with
    ``mode="drop"`` drops its padded slots."""
    if "slot_pos" not in cache:
        for name, t in rows.items():
            cache[name][:, :, : t.shape[2]] = t
        return
    b, hkv, w = cache["k"].shape[:3]
    pos_tail = positions[-w:]
    slots = torch.where(pos_tail >= 0, pos_tail % w, w)  # w: the drop bin
    for name, t in rows.items():
        buf = cache[name].new_zeros((b, hkv, w + 1) + tuple(cache[name].shape[3:]))
        buf[:, :, slots] = t[:, :, -w:]
        cache[name].copy_(buf[:, :, :w])
    slot_pos = torch.full((w + 1,), -1, dtype=torch.int32, device=slots.device)
    slot_pos[slots] = pos_tail.to(torch.int32)
    cache["slot_pos"].copy_(slot_pos[:w].expand(b, w))  # every row alike after prefill


def _decode_write(cache, rows: dict[str, torch.Tensor], pos: torch.Tensor,
                  window: int | None) -> torch.Tensor:
    """Write one token's rows per sequence into ``cache`` in place (k/v
    (B, Hkv, D), scales (B, Hkv)), at ``pos`` or, rolling, at
    ``pos % window`` with its slot position.  Returns the (B, L) mask of the
    cache entries the token attends to."""
    b, hkv = rows["k"].shape[:2]
    rolling = "slot_pos" in cache
    slot = pos % window if rolling else pos
    bi = torch.arange(b, device=pos.device)[:, None]
    hi = torch.arange(hkv, device=pos.device)[None, :]
    for name, t in rows.items():
        cache[name][bi, hi, slot[:, None]] = t
    if rolling:
        cache["slot_pos"][bi[:, 0], slot] = pos.to(torch.int32)
        sp, p = cache["slot_pos"], pos[:, None]
        return (sp >= 0) & (sp <= p) & (sp > p - window)
    kv_pos = torch.arange(cache["k"].shape[2], device=pos.device)
    return kv_pos[None, :] <= pos[:, None]


def _decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: torch.Tensor, k_scale: torch.Tensor | None = None,
                   v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """One query position (B, Hq, 1, D) against the cache (B, Hkv, L, D),
    float or int8 codes with their (B, Hkv, L) scales, under ``valid``
    (B, L), in float32; the result in q's dtype.  Scores are divided by
    sqrt(D) through a device scalar: CUDA's division by a Python number is
    a reciprocal multiply."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    kf = k.float() if k_scale is None else _dequantize(k, k_scale)
    vf = v.float() if v_scale is None else _dequantize(v, v_scale)
    qf = q.float().reshape(b, hkv, (hq // hkv) * s, d)
    scores = torch.matmul(qf, kf.transpose(-1, -2))
    scores = scores / scalar(d ** 0.5, torch.float32, str(q.device))
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    out = torch.matmul(torch.softmax(scores, dim=-1), vf)
    return out.reshape(b, hq, s, d).to(q.dtype)


def gqa_apply(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor | None = None,  # (S,) train/prefill, (B,) decode
    *,
    mode: str = "train",
    cache=None,
    kernel: dict | None = None,
    quant=None,  # per-layer runtime hook from the precision plan
):
    """Returns (out, cache) like the reference.  With a cache, prefill and
    decode write the new k/v rows into ``cache``'s tensors in place and
    return it (``models.lm`` hands each layer its slice of one copy of the
    caller's caches); without one, every mode attends causally over ``x``
    alone, as the reference's."""
    if mode not in MODES:
        raise ValueError(f"unknown attention mode {mode!r}; use one of {MODES}")
    if mode == "extend":
        raise NotImplementedError(
            "gqa_apply mode='extend' (the cache-extending prefill) is not ported yet "
            "(ROADMAP queue 1, item 8, step 5)"
        )
    if cache is not None:
        _check_cache(cache, mode)
    kernel = kernel or {}
    qc = cfg.quant if quant is None else quant
    hd = cfg.resolved_head_dim
    q = _split_heads(layers.dense(params["wq"], x, qc), cfg.n_heads, hd)
    k = _split_heads(layers.dense(params["wk"], x, qc), cfg.n_kv_heads, hd)
    v = _split_heads(layers.dense(params["wv"], x, qc), cfg.n_kv_heads, hd)
    if positions is None:
        if mode == "decode":
            raise ValueError("decode requires explicit per-sequence positions")
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    if cfg.use_rope:  # q, k stay fresh contiguous tensors, as the kernel needs
        rope_pos = positions[:, None, None] if mode == "decode" else positions
        cos, sin = layers.rope_cos_sin(rope_pos, hd, cfg.rope_theta)  # once for q and k
        q, k = layers.rotate(q, cos, sin), layers.rotate(k, cos, sin)
    window = cfg.sliding_window
    softmax_mode = kernel.get("softmax_mode", "safe")

    if mode == "train" or cache is None:
        out = mha(q, k, v, causal=not cfg.is_encoder, window=window, mode=softmax_mode)
        return layers.dense(params["wo"], _merge_heads(out), qc), cache
    if "k_scale" in cache:  # int8 codes + per-(token, head) float32 scales
        (k_codes, k_sc), (v_codes, v_sc) = _kv_quantize(k), _kv_quantize(v)
        rows = {"k": k_codes, "v": v_codes, "k_scale": k_sc, "v_scale": v_sc}
    else:
        rows = {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}
    if mode == "prefill":
        _prefill_write(cache, rows, positions, window)
        if "k_scale" in cache:
            # attend the cache's own representation (the int8 round trip) in
            # float32, so prefill scores the values decode reads back; q goes
            # up to float32 with them and the output comes back to q's dtype
            k_att, v_att = _dequantize(k_codes, k_sc), _dequantize(v_codes, v_sc)
            out = mha(q.float(), k_att, v_att, causal=True, window=window,
                      mode=softmax_mode).to(q.dtype)
        else:
            out = mha(q, k, v, causal=True, window=window, mode=softmax_mode)
    elif kv_cache_lib.is_paged(cache):  # decode into its page, attend the gathered view
        kv_cache_lib.paged_decode_write(cache, {n: t[:, :, 0] for n, t in rows.items()},
                                        positions)
        view = kv_cache_lib.paged_decode_view(cache)
        kv_pos = torch.arange(view["k"].shape[2], device=positions.device)
        out = _decode_attend(q, view["k"], view["v"], kv_pos[None, :] <= positions[:, None],
                             view.get("k_scale"), view.get("v_scale"))
    else:  # decode: one token per sequence at its global position (B,)
        valid = _decode_write(cache, {n: t[:, :, 0] for n, t in rows.items()}, positions,
                              window)
        out = _decode_attend(q, cache["k"], cache["v"], valid, cache.get("k_scale"),
                             cache.get("v_scale"))
    return layers.dense(params["wo"], _merge_heads(out), qc), cache


def attention_apply(params, cfg, x, positions=None, **kw):
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"attn_kind {cfg.attn_kind!r} is not ported yet (ROADMAP queue 1, item 9)"
        )
    return gqa_apply(params, cfg, x, positions, **kw)
