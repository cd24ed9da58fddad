"""Attention (port of ``repro.models.attention``): GQA/MHA, and MLA
(multi-head latent attention, minicpm3-4b); ``train`` over a whole
sequence, ``prefill`` over a dense KV cache (or, GQA, a rolling
sliding-window buffer), ``decode`` over those or a paged cache
(``serve.kv_cache``), and ``extend`` (the cache-extending prefill): a
window of W tokens per row written at per-row positions (B, W) into a dense
or paged position-addressed cache, then attended against the whole logical
view (history + window) under the explicit mask ``kv_pos <= position``.

Train and prefill attend through the fused attention kernel (``mha``); the
decode and extend attends are plain torch ops, as the reference's are plain
jnp.  ``_window_attend`` (extend) is the plain version's arithmetic
(``kernels/flash_attention/ref.py``) over an explicit mask, so on the CPU a
window row gives what the prefill gave at that position.  A paged decode or
extend writes through ``kv_cache.paged_decode_write`` /
``paged_window_write`` and attends the dense view
``kv_cache.paged_decode_view`` gathers.

A cache that carries ``k_scale`` / ``v_scale`` is the int8 KV cache
(``int8_serve``): k/v are stored as per-(token, head) symmetric int8 codes
(``_kv_quantize``) with float32 scales; prefill attends the cache's own
dequantized representation (float32, through the kernel's float32 route),
so the values it scores are those decode reads back.

Under a model group (``distributed.tensor_parallel``) GQA splits by
heads: q/k/v project to this rank's heads, the kernel runs at the local
head counts, ``wo`` is row-parallel, and a cache holds the local kv heads
(``tensor_parallel.local_caches``).  When the kv heads do not divide the
group, K/V's weight comes whole and each rank projects the kv heads its q
heads use; when the q heads do not split evenly, the attention repeats
on every rank.  MLA splits by heads too: the latents and their norms are
computed whole on every rank (their weights come whole), ``wq_b`` /
``wk_b`` / ``wv_b`` are narrowed to this rank's heads' columns, the kernel
(or the decode's torch ops) runs at the local heads, ``wo`` is
row-parallel, and the latent cache stays whole.

MLA caches one packed latent per token, ``kv_lora_rank`` values of the
normed ``ckv`` and the ``qk_rope_head_dim`` values of the rotated ``k_rope``
shared by every head (``latent``; int8 codes with one float32
``latent_scale`` per token under ``int8_serve``).  Train and prefill
materialize per-head K and V from it and attend through ``mha`` at a q/k
head_dim of nope + rope, V zero-padded to it; decode materializes K and V
from the float32 latent view (the paper-faithful default) or, with
``kernel["mla_absorb"]``, folds ``wk_b`` / ``wv_b`` into the query and the
output and attends the latent itself.  Extend writes the window's latent
rows and materializes per-head K and V from the whole latent view, as the
prefill does, whatever ``mla_absorb``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import lut
from repro_torch.device import scalar
from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.kernels.flash_attention import mha
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models import layers
from repro_torch.roofline.op_counter import attnvol
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


def mla_spec(cfg: ModelConfig, dtype=torch.float32):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": layers.dense_spec(d, m.q_lora_rank, axes=("embed", "q_lora"), dtype=dtype),
        "q_norm": layers.norm_spec(m.q_lora_rank, "rmsnorm", dtype),
        "wq_b": layers.dense_spec(m.q_lora_rank, h * qk, axes=("q_lora", "heads"), dtype=dtype),
        "wkv_a": layers.dense_spec(d, m.kv_lora_rank + m.qk_rope_head_dim,
                                   axes=("embed", "kv_lora"), dtype=dtype),
        "kv_norm": layers.norm_spec(m.kv_lora_rank, "rmsnorm", dtype),
        "wk_b": layers.dense_spec(m.kv_lora_rank, h * m.qk_nope_head_dim,
                                  axes=("kv_lora", "heads"), dtype=dtype),
        "wv_b": layers.dense_spec(m.kv_lora_rank, h * m.v_head_dim, axes=("kv_lora", "heads"),
                                  dtype=dtype),
        "wo": layers.dense_spec(h * m.v_head_dim, d, axes=("heads", "embed"), dtype=dtype),
    }


def attention_spec(cfg: ModelConfig, dtype=torch.float32):
    return mla_spec(cfg, dtype) if cfg.attn_kind == "mla" else gqa_spec(cfg, dtype)


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim).transpose(1, 2).contiguous()


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _check_mode(mode: str, cache) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown attention mode {mode!r}; use one of {MODES}")
    if kv_cache_lib.is_paged(cache) and mode in ("train", "prefill"):
        raise ValueError(
            "a paged cache takes decode and extend writes only: prefill fills a dense "
            "scratch cache, which CacheManager.insert_prefill scatters into the pages"
        )
    if mode == "extend" and cache is not None and "slot_pos" in cache:
        raise ValueError(
            "cache-extend requires a position-addressed cache; "
            "rolling sliding-window buffers prefill exact-length"
        )


def _rope_positions(positions: torch.Tensor, mode: str) -> torch.Tensor:
    """The positions RoPE broadcasts against (..., seq, head_dim): (S,) in
    train and prefill, (B,) -> (B, 1, 1) in decode, (B, W) -> (B, 1, W) in
    extend."""
    if mode == "decode":
        return positions[:, None, None]
    if mode == "extend":
        return positions[:, None, :]
    return positions


def _window_write(cache, rows: dict[str, torch.Tensor], positions: torch.Tensor) -> dict:
    """Write a window's rows at (B, W) ``positions`` into ``cache`` in place
    and return the dense logical view to attend (the cache itself, or the
    paged cache's gathered pages)."""
    if kv_cache_lib.is_paged(cache):
        kv_cache_lib.paged_window_write(cache, rows, positions)
        return kv_cache_lib.paged_decode_view(cache)
    return kv_cache_lib.dense_window_write(cache, rows, positions)


def _window_mask(positions: torch.Tensor, length: int, window: int | None = None):
    """(B, W, L): window row i attends the kv positions <= its own (and,
    with a sliding window, within it)."""
    kv_pos = torch.arange(length, device=positions.device)
    mask = kv_pos[None, None, :] <= positions[:, :, None]
    if window is not None:
        mask = mask & (positions[:, :, None] - kv_pos[None, None, :] < window)
    return mask


def _kv_quantize(x: torch.Tensor):
    """(..., d) -> (int8 codes, float32 scales (...)): symmetric int8 over
    the last axis, the paper's fixed-point datapath applied to the KV cache:
    per (token, head) for GQA's (b, h, s, d), per token for MLA's latent
    (b, s, width), whose inline quantizer in the reference is this one's
    arithmetic.  The scale is divided by a device scalar (CUDA's division
    by a Python number is a reciprocal multiply); rounding is half to even,
    as ``jnp.round``."""
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


def _window_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, *,
                   softmax_mode: str = "safe", k_scale: torch.Tensor | None = None,
                   v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """W query rows (B, Hq, W, Dq) against the whole cache view (B, Hkv, L,
    Dk), float or int8 codes with their (B, Hkv, L) scales, under ``mask``
    (B, W, L), with the prefill path's arithmetic: KV heads repeated across
    query groups, one scaled product in float32, masked scores at NEG_INF
    (``safe``) or zero weight (``lut``: ``lut_exp``, then ``lut_inv`` of the
    sum), as the plain version of the attention kernel.  Masked columns are
    a suffix of each row's reduction and add exactly zero.  The scale
    1/sqrt(Dq) multiplies as the reference's, through a device scalar.
    Returns (B, Hq, W, Dv) in q's dtype."""
    d = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    kf = k.float() if k_scale is None else _dequantize(k, k_scale)
    vf = v.float() if v_scale is None else _dequantize(v, v_scale)
    if group > 1:
        kf = torch.repeat_interleave(kf, group, dim=1)
        vf = torch.repeat_interleave(vf, group, dim=1)
    m = mask[:, None]  # (B, 1, W, L): over every head
    with attnvol:  # the attention volume, for a roofline count
        s = torch.matmul(q.float(), kf.transpose(-1, -2))
        s = s * scalar(1.0 / d ** 0.5, torch.float32, str(q.device))
        if softmax_mode == "safe":
            p = torch.softmax(torch.where(m, s, NEG_INF), dim=-1)
        elif softmax_mode == "lut":
            e = torch.where(m, lut.lut_exp(s), 0.0)
            p = e * lut.lut_inv(torch.sum(e, dim=-1, keepdim=True))
        else:
            raise ValueError(f"unknown softmax mode {softmax_mode!r}")
        out = torch.matmul(p, vf)
    return out.to(q.dtype)


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
    with attnvol:  # the attention volume, for a roofline count
        scores = torch.matmul(qf, kf.transpose(-1, -2))
        scores = scores / scalar(d ** 0.5, torch.float32, str(q.device))
        scores = torch.where(valid[:, None, None, :], scores, -1e30)
        out = torch.matmul(torch.softmax(scores, dim=-1), vf)
    return out.reshape(b, hq, s, d).to(q.dtype)


def _head_projections(params, cfg: ModelConfig, tp, hd: int):
    """q/k/v's parameters at this rank's heads, and (q heads, kv heads):
    ``wq`` and, when the layout splits the kv heads, ``wk`` / ``wv`` are
    the rank's shards; otherwise K/V's whole weight, entered into the
    rank's work, is narrowed to the kv heads its q heads use."""
    lo, hi = tp_lib.kv_head_range(cfg, tp)
    proj = dict(params)
    if not tp.layout.kv_heads:
        for name in ("wk", "wv"):
            proj[name] = {k: tp_lib.enter(t, tp).narrow(-1, lo * hd, (hi - lo) * hd)
                          for k, t in params[name].items()}
    return proj, cfg.n_heads // tp.size, hi - lo


def gqa_apply(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor | None = None,  # (S,) train/prefill, (B,) decode, (B, W) extend
    *,
    mode: str = "train",
    cache=None,
    kernel: dict | None = None,
    quant=None,  # per-layer runtime hook from the precision plan
    group=None,  # tensor_parallel.ModelGroup: split by heads where its layout says
):
    """Returns (out, cache) like the reference.  With a cache, prefill,
    decode and extend write the new k/v rows into ``cache``'s tensors in
    place and return it (``models.lm`` hands each layer its slice of one
    copy of the caller's caches); without one, every mode attends causally
    over ``x`` alone, as the reference's."""
    _check_mode(mode, cache)
    kernel = kernel or {}
    qc = cfg.quant if quant is None else quant
    hd = cfg.resolved_head_dim
    tp = tp_lib.active(group)
    if tp is not None and not tp.layout.heads:
        tp = None  # the q heads do not split: the attention repeats on every rank
    proj, hq, hkv = params, cfg.n_heads, cfg.n_kv_heads
    if tp is not None:
        x = tp_lib.enter(x, tp)
        proj, hq, hkv = _head_projections(params, cfg, tp, hd)
    q = _split_heads(layers.dense(proj["wq"], x, qc), hq, hd)
    k = _split_heads(layers.dense(proj["wk"], x, qc), hkv, hd)
    v = _split_heads(layers.dense(proj["wv"], x, qc), hkv, hd)
    if positions is None:
        if mode in ("decode", "extend"):
            raise ValueError(f"{mode} requires explicit per-sequence positions")
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    if cfg.use_rope:  # q, k stay fresh contiguous tensors, as the kernel needs
        rope_pos = _rope_positions(positions, mode)
        cos, sin = layers.rope_cos_sin(rope_pos, hd, cfg.rope_theta)  # once for q and k
        q, k = layers.rotate(q, cos, sin), layers.rotate(k, cos, sin)
    window = cfg.sliding_window
    softmax_mode = kernel.get("softmax_mode", "safe")

    def out_proj(o):
        if tp is not None:
            return layers.row_parallel_dense(params["wo"], _merge_heads(o), tp, qc)
        return layers.dense(params["wo"], _merge_heads(o), qc)

    if mode == "train" or cache is None:
        out = mha(q, k, v, causal=not cfg.is_encoder, window=window, mode=softmax_mode)
        return out_proj(out), cache
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
    elif mode == "extend":  # the window at its (B, W) positions, attended over the whole view
        view = _window_write(cache, rows, positions)
        out = _window_attend(q, view["k"], view["v"],
                             _window_mask(positions, view["k"].shape[2], window),
                             softmax_mode=softmax_mode, k_scale=view.get("k_scale"),
                             v_scale=view.get("v_scale"))
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
    return out_proj(out), cache


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with ``jnp.einsum``'s promotion: the narrower
    operand goes up (a bfloat16 weight or query against the float32
    latent)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _mla_decode_attend(params, cfg: ModelConfig, q_nope, q_rope, view, pos, quant, absorb):
    """One query position per sequence (q_nope (b, h, 1, nope), q_rope
    (b, h, 1, rope)) against the whole latent view (b, L, width), float or
    int8 codes with their (b, L) scales, in float32 as the reference (the
    weights and the query promoted, never the latent cast down); returns
    (b, h, 1, v_head_dim) in float32.  Materialized (the default): per-head
    K and V from the latent through ``wk_b`` / ``wv_b``, every step.
    Absorbed: ``wk_b`` folded into the query and ``wv_b`` applied to the
    latent-space output.  ``params``' ``wk_b`` / ``wv_b`` hold the query's
    heads' columns."""
    m, h = cfg.mla, q_nope.shape[1]  # the heads of the query (a rank's, split)
    r, nope, vd = m.kv_lora_rank, m.qk_nope_head_dim, m.v_head_dim
    lat = view["latent"].float()
    if "latent_scale" in view:
        lat = lat * view["latent_scale"][..., None]
    b, length, _ = lat.shape
    ckv_all, krope_all = lat[..., :r], lat[..., r:]
    valid = torch.arange(length, device=pos.device)[None, :] <= pos[:, None]
    scale = 1.0 / ((nope + m.qk_rope_head_dim) ** 0.5)
    # ``attnvol`` (for a roofline count): the scores, softmax and P.V, as
    # the reference's named_scope; the materialized K / V projections and
    # the absorbed form's weight folds lie outside
    if absorb:
        q_lat = _einsum("bhsn,rhn->bhsr", q_nope, params["wk_b"]["kernel"].reshape(r, h, nope))
        with attnvol:
            scores = (_einsum("bhsr,bLr->bhsL", q_lat, ckv_all)
                      + _einsum("bhsd,bLd->bhsL", q_rope, krope_all)) * scale
            probs = torch.softmax(torch.where(valid[:, None, None, :], scores, -1e30), dim=-1)
            o_lat = _einsum("bhsL,bLr->bhsr", probs, ckv_all)
        return _einsum("bhsr,rhv->bhsv", o_lat, params["wv_b"]["kernel"].reshape(r, h, vd))
    k_nope = layers.dense(params["wk_b"], ckv_all, quant).reshape(b, length, h, nope)
    vv = layers.dense(params["wv_b"], ckv_all, quant).reshape(b, length, h, vd)
    with attnvol:
        scores = (_einsum("bhsn,bLhn->bhsL", q_nope, k_nope)
                  + _einsum("bhsd,bLd->bhsL", q_rope, krope_all)) * scale
        probs = torch.softmax(torch.where(valid[:, None, None, :], scores, -1e30), dim=-1)
        return _einsum("bhsL,bLhv->bhsv", probs, vv)


def _mla_extend(params, cfg: ModelConfig, q_nope, q_rope, view, positions, quant,
                softmax_mode: str) -> torch.Tensor:
    """The window rows (q_nope (b, h, W, nope), q_rope (b, h, W, rope))
    against the whole latent view (b, L, width), float or int8 codes with
    their scales, with the prefill's math: per-head K and V materialized
    from the float32 latent through ``wk_b`` / ``wv_b`` (the query's
    heads' columns) and attended by ``_window_attend``; returns the heads'
    output (b, h, W, v_head_dim)."""
    m, h = cfg.mla, q_nope.shape[1]
    r, nope, vd = m.kv_lora_rank, m.qk_nope_head_dim, m.v_head_dim
    lat = view["latent"].float()
    if "latent_scale" in view:
        lat = lat * view["latent_scale"][..., None]
    b, length, _ = lat.shape
    ckv_all, krope_all = lat[..., :r], lat[..., r:]
    k_nope = layers.dense(params["wk_b"], ckv_all, quant).reshape(b, length, h, nope)
    vv = layers.dense(params["wv_b"], ckv_all, quant).reshape(b, length, h, vd)
    k_full = torch.cat([k_nope.transpose(1, 2),
                        krope_all[:, None].expand(b, h, length, krope_all.shape[-1])], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    return _window_attend(q_full, k_full, vv.transpose(1, 2), _window_mask(positions, length),
                          softmax_mode=softmax_mode)


def _mla_head_projections(params, cfg: ModelConfig, tp):
    """``wq_b`` / ``wk_b`` / ``wv_b`` (whole: their lora rows are what the
    rules split) narrowed to this rank's heads' columns, entered into its
    work, and the local head count."""
    m = cfg.mla
    h = cfg.n_heads // tp.size
    lo = tp.rank * h
    widths = {"wq_b": m.qk_nope_head_dim + m.qk_rope_head_dim, "wk_b": m.qk_nope_head_dim,
              "wv_b": m.v_head_dim}
    proj = dict(params)
    for name, w in widths.items():
        proj[name] = {k: tp_lib.enter(t, tp).narrow(-1, lo * w, h * w)
                      for k, t in params[name].items()}
    return proj, h


def mla_apply(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor | None = None,  # (S,) train/prefill, (B,) decode, (B, W) extend
    *,
    mode: str = "train",
    cache=None,
    kernel: dict | None = None,
    quant=None,  # per-layer runtime hook from the precision plan
    group=None,  # tensor_parallel.ModelGroup: split by heads where its layout says
):
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3); returns (out,
    cache) like the reference.  With a cache, prefill, decode and extend
    write the new latent rows (int8 codes and their per-token scales under
    an int8 cache) into ``cache``'s tensors in place and return it.
    ``kernel["mla_absorb"]`` picks the absorbed decode.  Under ``group``
    whose layout splits the heads (module docstring) every mode attends at
    this rank's heads; the latent rows written are the whole ones."""
    _check_mode(mode, cache)
    kernel = kernel or {}
    absorb = kernel.get("mla_absorb", False)
    m = cfg.mla
    qc = cfg.quant if quant is None else quant
    b, s, _ = x.shape
    r = m.kv_lora_rank
    tp = tp_lib.active(group)
    if tp is not None and not tp.layout.heads:
        tp = None  # the heads do not split: the attention repeats on every rank
    proj, h = params, cfg.n_heads
    if tp is not None:
        proj, h = _mla_head_projections(params, cfg, tp)
    nope, vd = m.qk_nope_head_dim, m.v_head_dim
    qk = nope + m.qk_rope_head_dim
    if positions is None:
        if mode in ("decode", "extend"):
            raise ValueError(f"{mode} requires explicit per-sequence positions")
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    rope_pos = _rope_positions(positions, mode)

    def local(t):  # a replicated tensor into this rank's heads' work
        return t if tp is None else tp_lib.enter(t, tp)

    def out_proj(o):
        if tp is not None:
            return layers.row_parallel_dense(params["wo"], _merge_heads(o), tp, qc)
        return layers.dense(params["wo"], _merge_heads(o), qc)

    # query path: wq_a -> q_norm -> wq_b, RoPE on the last qk_rope dims
    cq = layers.norm(params["q_norm"], layers.dense(params["wq_a"], x, qc), "rmsnorm",
                     cfg.norm_eps)
    q = layers.dense(proj["wq_b"], local(cq), qc).reshape(b, s, h, qk).transpose(1, 2)
    q_nope = q[..., :nope]  # (b, h, s, nope)
    q_rope = layers.apply_rope(q[..., nope:], rope_pos, cfg.rope_theta)  # (b, h, s, rope)

    # latent path: wkv_a -> (kv_norm(ckv), RoPE(k_rope) shared by the heads)
    kv_a = layers.dense(params["wkv_a"], x, qc)
    ckv = layers.norm(params["kv_norm"], kv_a[..., :r], "rmsnorm", cfg.norm_eps)
    k_rope = layers.apply_rope(kv_a[..., r:][:, None], rope_pos, cfg.rope_theta)[:, 0]
    latent = torch.cat([ckv, k_rope], dim=-1)  # (b, s, r + rope)

    if cache is not None and mode != "train":
        if "latent_scale" in cache:  # int8 codes + one float32 scale per token
            codes, l_scale = _kv_quantize(latent)
            rows = {"latent": codes, "latent_scale": l_scale}
        else:
            rows = {"latent": latent.to(cache["latent"].dtype)}
        if mode == "prefill":
            for name, t in rows.items():
                cache[name][:, :s] = t
        elif mode == "extend":
            view = _window_write(cache, rows, positions)
            return out_proj(_mla_extend(proj, cfg, q_nope, q_rope, view, positions, qc,
                                        kernel.get("softmax_mode", "safe"))), cache
        elif kv_cache_lib.is_paged(cache):  # decode into its page, attend the gathered view
            kv_cache_lib.paged_decode_write(cache, {n: t[:, 0] for n, t in rows.items()},
                                            positions)
        else:  # decode: one token per sequence at its global position (B,)
            bi = torch.arange(b, device=positions.device)
            for name, t in rows.items():
                cache[name][bi, positions.long()] = t[:, 0]
        if mode == "decode":
            view = (kv_cache_lib.paged_decode_view(cache) if kv_cache_lib.is_paged(cache)
                    else cache)
            out = _mla_decode_attend(proj, cfg, q_nope, q_rope, view, positions, qc, absorb)
            return out_proj(out.to(x.dtype)), cache  # decode math runs f32; restore carry dtype
        if "latent_scale" in cache:
            # attend the cache's own representation (the int8 round trip), so
            # prefill scores the values decode reads back
            lat_att = _dequantize(codes, l_scale)
            ckv, k_rope = lat_att[..., :r], lat_att[..., r:]

    # train / prefill: materialize per-head K / V, attend through the kernel
    ckv, k_rope = local(ckv), local(k_rope)
    k_nope = layers.dense(proj["wk_b"], ckv, qc).reshape(b, s, h, nope)
    vv = layers.dense(proj["wv_b"], ckv, qc).reshape(b, s, h, vd)
    # fresh contiguous tensors, as the kernel needs (k_rope is broadcast)
    k_full = torch.cat([k_nope.transpose(1, 2),
                        k_rope[:, None].expand(b, h, s, k_rope.shape[-1])], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    v_heads = vv.transpose(1, 2).contiguous()  # V at its own head_dim, (b, h, s, vd)
    # an int8 latent attends in float32: q goes up with k / v, the output
    # comes back to q's dtype
    out = mha(q_full.to(k_full.dtype), k_full, v_heads, causal=not cfg.is_encoder,
              mode=kernel.get("softmax_mode", "safe")).to(q_full.dtype)
    return out_proj(out), cache


def attention_apply(params, cfg, x, positions=None, group=None, **kw):
    """MLA or GQA, either split by heads under ``group``."""
    if cfg.attn_kind == "mla":
        return mla_apply(params, cfg, x, positions, group=group, **kw)
    return gqa_apply(params, cfg, x, positions, group=group, **kw)
