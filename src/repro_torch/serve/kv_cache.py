"""KV-cache subsystem (port of ``repro.serve.kv_cache``): one
``CacheManager``, two storage layouts.

Per layer:
- dense GQA: ``k`` and ``v`` slabs (B, Hkv, L, D) in the cache dtype;
- a sliding window shorter than ``max_len``: a rolling buffer of length
  ``window`` plus ``slot_pos`` (B, window) int32, the global position held
  in each slot (-1 = empty);
- paged GQA: ``k`` and ``v`` pools (num_pages, Hkv, page_size, D) shared by
  every slot, and a ``page_table`` (B, max_len // page_size) int32 of
  physical page ids per slot.  Page 0 is the reserved trash page:
  unallocated table entries point at it, so pad and retired-slot writes
  land there and are never read back (reads are masked by position);
- the int8 KV cache (``int8_serve``): ``k`` / ``v`` as int8 codes in every
  layout above, with float32 ``k_scale`` / ``v_scale`` of their shape
  without the feature axis, one per (token, kv head); the paged scale pools
  (num_pages, Hkv, page_size) are head-major like ``k`` / ``v``;
- MLA (minicpm3-4b): one packed ``latent`` (B, L, kv_lora + rope) shared by
  every head, paged as pools (num_pages, page_size, width) with no head
  axis; under ``int8_serve`` int8 codes with one float32 ``latent_scale``
  per token, (B, L) or (num_pages, page_size);
- the ``ssm`` and ``hybrid`` families' Mamba2 cache (``ssm_state``
  (b, h, p, n) and ``conv_state`` (b, width - 1, conv_dim)), float32 of a
  fixed size whatever the model's type.
Stacked on a leading layer axis: ``{"layers": {name: (n_layers, ...)}}``.
The hybrid family adds ``"shared"``: the dense k / v (n_apps, B, H, L, D) of
its shared attention block, one slab per application, never paged and
never int8.

The device ops write into the caches they are handed, in place, and return
them: ``paged_decode_write`` (one token per slot into its page),
``dense_window_write`` / ``paged_window_write`` (a window of tokens per slot
at per-row positions, the cache-extending prefill's write; masked entries
carry a sentinel position past the cache, dropped by the dense scatter and
sent to the trash page by the paged one), ``paged_decode_view`` (each slot's
pages gathered into a dense (B, Hkv, L, D) or, for the latent, (B, L, width)
view, so decode attends exactly as over a dense slab), ``mask_cache_tail``
(zero each row past its prompt length), ``insert_prefill_dense`` /
``insert_prefill_paged`` (a prefill's dense scratch into its slots; pad rows,
slot index ``max_batch``, are dropped by the dense scatter and go to the
trash page in the paged one), ``share_written_rows`` (under a
``shard_decode`` split, the rows each rank wrote into its replicated paged
pools copied to every other rank).  Slot indices come from the host (numpy
or CPU tensors), so dropping pad rows needs no device synchronisation.

``CacheManager`` is host bookkeeping in numpy and Python, ported by copy:
page allocation, the worst-case reservation at admission, refcounts, the
prefix index (hash-chained full prompt pages), LRU retention of refcount-0
registered pages, copy-on-write (``flush_copies`` applies the queued page
copies on the device), the host victim tier (``kv_host_pages``: evicted
registered pages spill their rows to host rings and swap back into fresh
device pages on a later prefix hit; ``flush_swaps`` moves the rows) and
``check_invariants``.  A dispatch's queued device work is taken off the
queues as host arrays (``take_flush``) and applied (``apply_flush``), on
every rank of a ``shard_decode`` engine, each rank writing its own slots'
rows of the page table (``table_rows``) and keeping its own copy of the
victim tier's rings.  Every host-to-device copy goes through
``device.upload`` (a pinned buffer of its own, not blocking the host); the
rings are pinned CPU tensors when the manager's device is a card, and a
spill's device-to-host copy completes before ``flush_swaps`` returns, so
host code never reads a ring row whose copy is in flight.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.device import resolve_device, upload
from repro_torch.models import ssm

#: cache leaves with a sequence axis: name -> axis index from the right
SEQ_AXIS_FROM_RIGHT = {
    "k": 2, "v": 2, "latent": 2,  # (..., cache_len, feature)
    "k_scale": 1, "v_scale": 1, "latent_scale": 1,  # (..., cache_len)
}

#: pool leaves whose page axis is followed by a head axis (page, head, off, ...)
_HEAD_MAJOR_POOLS = ("k", "v", "k_scale", "v_scale")

#: reserved physical page id: write sink for pad scatters, never read
TRASH_PAGE = 0

LAYOUTS = ("dense", "paged")


# ---------------------------------------------------------------------------
# Per-layer attention cache specs (both layouts)
# ---------------------------------------------------------------------------


def attention_cache_spec(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype = torch.bfloat16,
    quantized: bool = False,
    layout: str = "dense",
    page_size: int | None = None,
    num_pages: int | None = None,
) -> dict:
    """Per-layer attention cache ``{name: (shape, dtype)}``; stacked by the
    caller.  ``quantized``: int8 k/v codes plus float32 per-(token, head)
    scales; for MLA, int8 latent codes plus one float32 scale per token."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown kv layout {layout!r}; use one of {LAYOUTS}")
    if layout == "paged":
        return _paged_attention_cache_spec(cfg, max_len, dtype, quantized, batch, page_size,
                                           num_pages)
    if cfg.attn_kind == "none":
        return {}
    if cfg.attn_kind == "mla":
        return _latent_leaves(cfg, (batch, max_len), dtype, quantized)
    length, extra = max_len, {}
    if cfg.sliding_window is not None and cfg.sliding_window < max_len:
        length = cfg.sliding_window
        extra["slot_pos"] = ((batch, length), torch.int32)
    rows = (batch, cfg.n_kv_heads, length)
    return {**_kv_leaves(rows, cfg.resolved_head_dim, dtype, quantized), **extra}


def _kv_leaves(rows: tuple, head_dim: int, dtype, quantized: bool) -> dict:
    """k / v of shape ``rows + (head_dim,)``, and with ``quantized`` int8
    codes and their float32 ``k_scale`` / ``v_scale`` of shape ``rows``."""
    kv = (rows + (head_dim,), torch.int8 if quantized else dtype)
    spec = {"k": kv, "v": kv}
    if quantized:
        spec["k_scale"] = spec["v_scale"] = (rows, torch.float32)
    return spec


def _latent_leaves(cfg: ModelConfig, rows: tuple, dtype, quantized: bool) -> dict:
    """MLA's packed ``latent`` of shape ``rows + (kv_lora + rope,)``, and
    with ``quantized`` int8 codes and their float32 ``latent_scale`` of
    shape ``rows``."""
    m = cfg.mla
    spec = {"latent": (rows + (m.kv_lora_rank + m.qk_rope_head_dim,),
                       torch.int8 if quantized else dtype)}
    if quantized:
        spec["latent_scale"] = (rows, torch.float32)
    return spec


def _paged_attention_cache_spec(cfg, max_len, dtype, quantized, batch, page_size, num_pages):
    if page_size is None or num_pages is None:
        raise ValueError("paged layout requires page_size and num_pages")
    if max_len % page_size != 0:
        raise ValueError(
            f"paged layout requires max_seq_len ({max_len}) to be a whole "
            f"number of pages (kv_page_size={page_size})"
        )
    if cfg.attn_kind not in ("gqa", "mla") or cfg.family in ("ssm", "hybrid"):
        raise ValueError(
            f"paged layout supports position-addressed GQA/MLA caches only "
            f"(got attn_kind={cfg.attn_kind!r}, family={cfg.family!r})"
        )
    if cfg.sliding_window is not None and cfg.sliding_window < max_len:
        raise ValueError("paged layout does not support rolling sliding-window buffers")
    if cfg.attn_kind == "mla":
        pools = _latent_leaves(cfg, (num_pages, page_size), dtype, quantized)
    else:
        pools = _kv_leaves((num_pages, cfg.n_kv_heads, page_size), cfg.resolved_head_dim, dtype,
                           quantized)
    return {**pools, "page_table": ((batch, max_len // page_size), torch.int32)}


def _zero_leaf(name: str, shape: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if name == "page_table":
        return torch.full(shape, TRASH_PAGE, dtype=dtype, device=device)
    if dtype == torch.int32:  # slot positions: -1 marks an empty slot
        return torch.full(shape, -1, dtype=dtype, device=device)
    return torch.zeros(shape, dtype=dtype, device=device)


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int,
                         dtype: torch.dtype = torch.bfloat16, *,
                         device: str | torch.device = "cuda", **kw) -> dict:
    dev = resolve_device(device)
    spec = attention_cache_spec(cfg, batch, max_len, dtype, **kw)
    return {k: _zero_leaf(k, shape, dt, dev) for k, (shape, dt) in spec.items()}


def _per_layer_cache_spec(cfg: ModelConfig, batch: int, max_len: int, dtype, quantized,
                          **layout_kw):
    if cfg.family in ("ssm", "hybrid"):
        return ssm.mamba_cache_spec(cfg, batch, torch.float32)
    return attention_cache_spec(cfg, batch, max_len, dtype, quantized=quantized, **layout_kw)


def abstract_caches(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype = torch.bfloat16,
    quantized: bool = False,
    layout: str = "dense",
    page_size: int | None = None,
    num_pages: int | None = None,
) -> dict:
    """{"layers": {name: (shape, dtype)}}, shapes with the leading layer
    axis, and for the hybrid family ``"shared"`` with a leading application
    axis.  ``max_len`` and ``dtype`` size and type the attention caches; the
    SSM caches are float32 of a fixed size."""
    per_layer = _per_layer_cache_spec(cfg, batch, max_len, dtype, quantized, layout=layout,
                                      page_size=page_size, num_pages=num_pages)
    caches = {"layers": {k: ((cfg.n_layers,) + shape, dt)
                         for k, (shape, dt) in per_layer.items()}}
    if cfg.family == "hybrid":
        from repro_torch.models import blocks, lm  # runtime import: both import this module

        shared = blocks.shared_attn_cache_spec(cfg, batch, max_len, dtype)
        caches["shared"] = {k: ((lm.n_shared_apps(cfg),) + shape, dt)
                            for k, (shape, dt) in shared.items()}
    return caches


def init_caches(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype = torch.bfloat16,
    quantized: bool = False,
    *,
    device: str | torch.device = "cuda",
    **layout_kw,
) -> dict:
    """Empty caches for ``abstract_caches`` on ``device``: zeros, -1 in the
    int32 slot positions and the trash page in the page table."""
    dev = resolve_device(device)
    spec = abstract_caches(cfg, batch, max_len, dtype, quantized, **layout_kw)
    return {group: {k: _zero_leaf(k, shape, dt, dev) for k, (shape, dt) in leaves.items()}
            for group, leaves in spec.items()}


def cache_logical_axes(cfg: ModelConfig, quantized: bool = False,
                       layout: str = "dense") -> dict:
    """The caches' logical axis names, leaf for leaf (the reference's, for
    sharding): paged pools have no batch axis and shard over heads; the page
    table shards over batch."""
    if layout == "paged":
        if cfg.attn_kind == "mla":
            per_layer = {"latent": ("layers", None, None, None)}
            if quantized:
                per_layer["latent_scale"] = ("layers", None, None)
        else:
            per_layer = {"k": ("layers", None, "kv_heads", None, None),
                         "v": ("layers", None, "kv_heads", None, None)}
            if quantized:
                per_layer["k_scale"] = per_layer["v_scale"] = ("layers", None, "kv_heads", None)
        per_layer["page_table"] = ("layers", "batch", None)
        return {"layers": per_layer}
    if cfg.family in ("ssm", "hybrid"):
        per_layer = {"ssm_state": ("layers", "batch", "ssm_heads", None, None),
                     "conv_state": ("layers", "batch", None, "inner")}
    elif cfg.attn_kind == "mla":
        per_layer = {"latent": ("layers", "batch", "cache_len", None)}
        if quantized:
            per_layer["latent_scale"] = ("layers", "batch", "cache_len")
    else:
        per_layer = {"k": ("layers", "batch", "kv_heads", "cache_len", None),
                     "v": ("layers", "batch", "kv_heads", "cache_len", None)}
        if cfg.sliding_window is not None:
            per_layer["slot_pos"] = ("layers", "batch", None)
        if quantized:
            per_layer["k_scale"] = per_layer["v_scale"] = ("layers", "batch", "kv_heads",
                                                           "cache_len")
    axes = {"layers": per_layer}
    if cfg.family == "hybrid":
        axes["shared"] = {"k": ("layers", "batch", "kv_heads", "cache_len", None),
                          "v": ("layers", "batch", "kv_heads", "cache_len", None)}
    return axes


# ---------------------------------------------------------------------------
# Device ops: paged decode write / view (used by models/attention.py)
# ---------------------------------------------------------------------------


def is_paged(cache: dict | None) -> bool:
    """A per-layer cache dict is paged iff it carries a page table."""
    return cache is not None and "page_table" in cache


def _pool_page_size(name: str, pool: torch.Tensor) -> int:
    return pool.shape[2] if name in _HEAD_MAJOR_POOLS else pool.shape[1]


def paged_decode_write(cache: dict, updates: dict[str, torch.Tensor],
                       positions: torch.Tensor) -> dict:
    """Scatter one token per slot into its physical page, in place.

    ``updates``: leaf name -> per-slot values with the seq axis removed
    (k/v: (B, Hkv, D); scales: (B, Hkv); latent: (B, width); latent_scale:
    (B,)).  ``positions``: (B,) global write positions.  Retired slots have
    all-trash page tables, so their writes land in the trash page and never
    alias live data."""
    first = next(iter(updates))
    ps = _pool_page_size(first, cache[first])  # one page size for every pool
    pos = positions.long()
    phys = cache["page_table"].gather(1, (pos // ps)[:, None])[:, 0].long()
    off = pos % ps
    for name, val in updates.items():
        pool = cache[name]
        if name in _HEAD_MAJOR_POOLS:
            pool[phys, :, off] = val.to(pool.dtype)
        else:
            pool[phys, off] = val.to(pool.dtype)
    return cache


def dense_window_write(cache: dict, updates: dict[str, torch.Tensor],
                       positions: torch.Tensor) -> dict:
    """Scatter a token window per slot into a dense per-layer cache, in
    place: the cache-extending prefill's write.  ``updates``: leaf name ->
    per-slot windows (k/v (B, Hkv, W, D); scales (B, Hkv, W); latent
    (B, W, width); latent_scale (B, W)).  ``positions``: (B, W) global write
    positions; masked entries carry a sentinel at or past the cache length
    and are dropped, as the reference's scatter with ``mode="drop"``."""
    first = next(iter(updates))
    length = cache[first].shape[2 if first in _HEAD_MAJOR_POOLS else 1]
    bi, wi = (positions < length).nonzero(as_tuple=True)
    pos = positions[bi, wi].long()
    for name, val in updates.items():
        buf = cache[name]
        if name in _HEAD_MAJOR_POOLS:  # advanced indices around a slice lead: (N, Hkv, ...)
            buf[bi, :, pos] = val[bi, :, wi].to(buf.dtype)
        else:
            buf[bi, pos] = val[bi, wi].to(buf.dtype)
    return cache


def paged_window_write(cache: dict, updates: dict[str, torch.Tensor],
                       positions: torch.Tensor) -> dict:
    """Scatter a token window per slot into its physical pages, in place:
    the update shapes and (B, W) ``positions`` of ``dense_window_write``.
    Each position routes through the page table on its own, so a window may
    straddle pages; a sentinel position indexes past the table and goes to
    the trash page, as retired slots' decode writes do."""
    first = next(iter(updates))
    phys, off = window_pages(cache["page_table"], positions,  # one page size for every pool
                             _pool_page_size(first, cache[first]))
    phys, off = phys.view(positions.shape), off.view(positions.shape)  # (B, W)
    for name, val in updates.items():
        pool = cache[name]
        if name in _HEAD_MAJOR_POOLS:  # the index axes lead: values go (B, W, Hkv[, D])
            pool[phys, :, off] = val.movedim(2, 1).to(pool.dtype)
        else:
            pool[phys, off] = val.to(pool.dtype)
    return cache


def paged_decode_view(cache: dict) -> dict[str, torch.Tensor]:
    """Gather each slot's pages into a contiguous logical view: k/v
    (B, Hkv, L, D) and scales (B, Hkv, L), latent (B, L, width) and
    latent_scale (B, L), with ``L = pages_per_slot * page_size``, so the
    attention math is the dense layout's (unallocated entries read the trash
    page and are masked by position, like dense positions past the write
    head).  One ``index_select`` per leaf: over (page, head) rows of
    page_size x D elements in (slot, head, page) order for the head-major
    pools, over whole pages in (slot, page) order for the latent pools, so
    the result is contiguous."""
    table = cache["page_table"].long()  # (B, n_pages)
    b, n_pages = table.shape
    if "k" in cache:  # head-major pools: (page, head) rows
        heads = cache["k"].shape[1]
        rows = (table[:, None, :] * heads
                + torch.arange(heads, device=table.device)[None, :, None]).reshape(-1)
        lead = (b, heads)
    else:  # the latent pools: whole pages
        rows, lead = table.reshape(-1), (b,)
    out = {}
    for name, pool in cache.items():
        if name == "page_table":
            continue
        src = pool.flatten(0, len(lead) - 1)  # (pages[ x heads], page_size[, D])
        g = src.reshape(src.shape[0], -1).index_select(0, rows)
        out[name] = g.view(*lead, n_pages * src.shape[1], *src.shape[2:])
    return out


def window_pages(table: torch.Tensor, positions: torch.Tensor,
                 page_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(physical page, offset) of each of the (B, K) ``positions`` through
    the (B, pages_per_slot) ``table``, flattened to (B * K,); a position
    past the table goes to the trash page, as ``paged_window_write`` routes
    a sentinel."""
    pos = positions.long()
    col = pos // page_size
    inside = col < table.shape[1]
    phys = torch.where(inside, table.gather(1, col.clamp_max(table.shape[1] - 1)), TRASH_PAGE)
    return phys.long().reshape(-1), (pos % page_size).reshape(-1)


def share_written_rows(layers: dict, positions: torch.Tensor, gather) -> None:
    """Copy into every rank's replicated paged pools the rows that each rank
    may just have written at its own slots' (B, K) ``positions`` (through
    its own rows of the page table), in place: ``gather(t, dim)`` is the
    all-gather of the ranks' ``t`` along ``dim`` in rank order.  A row a
    rank did not write holds the same bits on every rank, so copying the
    whole window is exact; rows aimed at the trash page land there."""
    pools = {name: pool for name, pool in layers.items() if name != "page_table"}
    first = next(iter(pools))
    phys, off = window_pages(layers["page_table"][0], positions,
                             _pool_page_size(first, pools[first][0]))
    all_phys, all_off = gather(phys, 0), gather(off, 0)
    for name, pool in pools.items():
        if name in _HEAD_MAJOR_POOLS:  # (L, pages, H, ps[, D]): rows (N, L, H[, D])
            pool[:, all_phys, :, all_off] = gather(pool[:, phys, :, off], 0)
        else:  # the latent pools (L, pages, ps[, W]): rows (L, N[, W])
            pool[:, all_phys, all_off] = gather(pool[:, phys, off], 1)


# ---------------------------------------------------------------------------
# Device ops: prefill masking + layout-specific slot insertion
# ---------------------------------------------------------------------------


def _host_index(idx) -> torch.Tensor:
    """Host-side int64 indices (numpy, list or tensor; a device tensor is
    copied back, which the executor never does)."""
    if isinstance(idx, torch.Tensor):
        return idx.detach().to("cpu", torch.int64)
    return torch.from_numpy(np.array(idx, dtype=np.int64, copy=True))


def mask_cache_tail(filled: dict, lengths: torch.Tensor) -> dict:
    """Zero cache entries at positions >= the per-row prompt length, in
    place.  ``filled``: stacked dense caches with batch axis 1 on every
    leaf; ``lengths``: (N,) true prompt lengths.  Leaves without a sequence
    axis (SSM state, slot_pos) pass through; those families prefill at
    exact length, where the mask is all-true."""
    for group in filled.values():
        for name, leaf in group.items():
            axis_r = SEQ_AXIS_FROM_RIGHT.get(name)
            if axis_r is None:
                continue
            axis = leaf.ndim - axis_r
            seq = torch.arange(leaf.shape[axis], device=leaf.device)
            seq_b = seq.reshape((1,) * axis + (-1,) + (1,) * (leaf.ndim - axis - 1))
            len_b = lengths.to(leaf.device).reshape((1, -1) + (1,) * (leaf.ndim - 2))
            leaf.masked_fill_(seq_b >= len_b, 0)
    return filled


def insert_prefill_dense(big: dict, filled: dict, slots) -> dict:
    """Scatter freshly prefilled rows into their slots (batch axis 1 on
    every stacked leaf of every group: the hybrid family's ``shared`` too),
    in place.  Rows whose slot index is out of range (the engine's pad
    sentinel ``max_batch``) are dropped."""
    slots = _host_index(slots)
    nb = next(iter(big["layers"].values())).shape[1]
    keep = ((slots >= 0) & (slots < nb)).nonzero()[:, 0]
    for group, leaves in filled.items():
        for name, f in leaves.items():
            b = big[group][name]
            b[:, slots[keep].to(b.device)] = f[:, keep.to(f.device)].to(b.dtype)
    return big


def insert_prefill_paged(big: dict, filled: dict, slots, page_size: int,
                         shared_pages=None, table_rows=None) -> dict:
    """Scatter dense prefilled rows into each slot's physical pages, in
    place.

    ``filled`` is the dense scratch cache the model wrote (tail-masked); it
    may be shorter than the full logical range (the engine sizes it to the
    bucket rounded up to whole pages) and fills the leading columns of the
    slots' page-table rows.  Unallocated entries (the pad tail past a
    prompt's pages, whole pad rows) point at the trash page.
    ``shared_pages``: optional (N,) per-row count of leading entries that
    alias prefix-cache pages owned by earlier requests; those columns go to
    the trash page, so shared history is never rewritten.  ``table_rows``:
    optional host (N, pages_per_slot) page-table rows of the rows' slots
    (pad rows all trash), for a rank whose device table holds only its own
    slots' rows (``shard_decode``); by default the device table's."""
    layers = big["layers"]
    dev = layers["page_table"].device
    if table_rows is None:
        table = layers["page_table"][0]  # identical across layers: (B, n_pages)
        nb = table.shape[0]
        slots = _host_index(slots)
        valid = ((slots >= 0) & (slots < nb)).to(dev)
        rows = table[slots.clamp(0, nb - 1).to(dev)]  # (N, pages_per_slot)
        rows = torch.where(valid[:, None], rows, TRASH_PAGE)
    else:
        rows = _host_index(table_rows).to(dev)
    if shared_pages is not None:
        shared = _host_index(shared_pages).to(dev)
        col = torch.arange(rows.shape[1], device=dev)
        rows = torch.where(col[None, :] < shared[:, None], TRASH_PAGE, rows)
    rows = rows.long()
    for name, small in filled["layers"].items():
        pool = layers[name]
        axis = small.ndim - SEQ_AXIS_FROM_RIGHT[name]
        n_pages = small.shape[axis] // page_size
        paged = small.reshape(small.shape[:axis] + (n_pages, page_size) + small.shape[axis + 1:])
        pages = paged.movedim(axis, 2)  # (L, N, n_pages, Hkv, ps, D) or (L, N, n_pages, ps, W)
        pool[:, rows[:, :n_pages]] = pages.to(pool.dtype)
    return big


# ---------------------------------------------------------------------------
# Host-side manager
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CacheStats:
    layout: str
    kv_bytes: int
    page_size: int
    pages_in_use: int
    pages_capacity: int
    page_allocs_total: int
    pages_in_use_peak: int
    pages_cached: int = 0
    prefix_queries: int = 0
    prefix_hits: int = 0
    prefix_pages_hit: int = 0
    cow_copies: int = 0
    page_evictions: int = 0
    #: pages shared by mapping a resident parent's live pages onto an
    #: n-best sibling (CacheManager.fork)
    gen_pages_shared: int = 0
    #: victim-tier movement: pages spilled to the host ring on eviction
    #: (swap_outs), spilled pages fetched back into device pages on a later
    #: prefix hit (swap_ins), spilled pages dropped when the ring itself
    #: overflowed (host_evictions)
    swap_outs: int = 0
    swap_ins: int = 0
    host_evictions: int = 0
    host_pages_used: int = 0
    host_pages_capacity: int = 0
    #: host wall seconds in flush_swaps (the device <-> host row copies)
    swap_latency_s: float = 0.0

    @property
    def page_utilization(self) -> float:
        if self.pages_capacity <= 0:
            return 0.0
        return self.pages_in_use / self.pages_capacity

    @property
    def prefix_hit_rate(self) -> float:
        if self.prefix_queries <= 0:
            return 0.0
        return self.prefix_hits / self.prefix_queries

    def as_dict(self) -> dict:
        return {
            "kv_layout": self.layout,
            "kv_bytes": self.kv_bytes,
            "kv_page_size": self.page_size,
            "pages_in_use": self.pages_in_use,
            "pages_capacity": self.pages_capacity,
            "page_utilization": self.page_utilization,
            "page_allocs_total": self.page_allocs_total,
            "pages_in_use_peak": self.pages_in_use_peak,
            "pages_cached": self.pages_cached,
            "prefix_queries": self.prefix_queries,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": self.prefix_hit_rate,
            "prefix_pages_hit": self.prefix_pages_hit,
            "cow_copies": self.cow_copies,
            "page_evictions": self.page_evictions,
            "gen_pages_shared": self.gen_pages_shared,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "host_evictions": self.host_evictions,
            "host_pages_used": self.host_pages_used,
            "host_pages_capacity": self.host_pages_capacity,
            "swap_latency_s": self.swap_latency_s,
        }


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Longest prefix-index match for a prompt.  ``keys[i]`` is the
    interned chain key of token chunk ``i`` (all full pages); the leading
    ``len(pages)`` chunks are device-resident (``pages[i]`` holds chunk
    ``i``), the remaining ``host_hits`` chunks live in the host victim tier
    and swap back in at admission.  ``tokens`` == ``len(keys) *
    page_size``, the coverage across both tiers."""

    pages: tuple[int, ...] = ()
    keys: tuple[int, ...] = ()
    tokens: int = 0

    @property
    def host_hits(self) -> int:
        """Matched chunks resident only in the host victim tier."""
        return len(self.keys) - len(self.pages)

    def __bool__(self) -> bool:
        return bool(self.keys)


class CacheManager:
    """Owns the KV-cache storage layout for one serving engine.

    Host-side: building the device cache tree, page allocation /
    reclamation / refcounting per slot (paged layout), the prefix-cache
    index (hash-chained full prompt pages, shared copy-on-write), and
    keeping the device page table in sync (``write_table``).  Device-side:
    inserting a prefilled dense slab into the big caches
    (``insert_prefill``) and the queued copy-on-write page copies
    (``flush_copies``).

    Dense layout is one page of ``max_seq_len`` tokens per slot, bound to
    the slot, so occupancy telemetry is uniform across layouts; prefix
    caching is a no-op there.

    Paged page lifecycle: ``free`` -> ``live`` (refcount >= 1, in one or
    more slot tables) -> back to ``free`` (unregistered content) or
    ``cached`` (refcount 0 but registered in the prefix index, evictable
    LRU) when its last owner finishes.  The trash page 0 is in none of the
    three sets.  With a victim tier (``ServeConfig.kv_host_pages``) eviction
    off the cached LRU adds a fourth, host-side state, ``spilled``: the
    page's rows live in the host ring under its chain key, and a later
    prefix hit swaps them back into a fresh device page (``flush_swaps``);
    the ring's own LRU eviction is the one point where warm prefix state is
    discarded.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        serve_cfg: ServeConfig,
        quantized: bool = False,
        dtype: torch.dtype = torch.float32,
        *,
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.quantized = quantized
        self.dtype = dtype
        self.device = resolve_device(device)
        sc = serve_cfg
        rolling = cfg.sliding_window is not None and cfg.sliding_window < sc.max_seq_len
        #: position-addressed caches can be right-padded (bucketed prefill)
        #: and paged; SSM state and rolling buffers cannot
        self.position_addressed = (
            cfg.attn_kind in ("gqa", "mla")
            and cfg.family not in ("ssm", "hybrid")
            and not rolling
        )
        requested = sc.kv_layout
        if requested not in LAYOUTS:
            raise ValueError(f"unknown kv_layout {requested!r}; use one of {LAYOUTS}")
        self.layout = "paged" if requested == "paged" and self.position_addressed else "dense"
        if self.layout == "paged":
            ps = sc.kv_page_size
            if ps < 1 or sc.max_seq_len % ps != 0:
                raise ValueError(
                    f"kv_page_size={ps} must divide max_seq_len="
                    f"{sc.max_seq_len} (fixed-stride pages)"
                )
            self.page_size = ps
            self.pages_per_slot = sc.max_seq_len // ps
            auto = sc.max_batch * self.pages_per_slot + 1  # +1 trash page
            self.num_pages = auto if sc.kv_pages is None else sc.kv_pages
            if self.num_pages < 2:
                raise ValueError("kv_pages must be >= 2 (one is the trash page)")
            # page 0 is the trash page; pop() allocates ascending
            self._free = list(range(self.num_pages - 1, 0, -1))
        else:
            self.page_size = sc.max_seq_len
            self.pages_per_slot = 1
            self.num_pages = sc.max_batch
            self._free = []
        #: prefix-cache sharing is a paged-layout feature; inert for dense
        self.prefix_cache = bool(sc.kv_prefix_cache and self.layout == "paged")
        self._slot_pages: list[list[int]] = [[] for _ in range(sc.max_batch)]
        # worst-case pages promised to each resident request at admission
        self._slot_reserved: list[int] = [0] * sc.max_batch
        #: per-slot interned chain keys for pages [0, len(keys)): the
        #: registration watermark (truncated when a write mutates a
        #: chained page: copy-on-write or deregister-on-write)
        self._slot_keys: list[list[int]] = [[] for _ in range(sc.max_batch)]
        self._table = np.zeros((sc.max_batch, self.pages_per_slot), np.int32)
        self._table_dirty = True
        self._allocs_total = 0
        self._peak_in_use = 0
        # --- refcounts + prefix index (paged sharing) ---
        self._page_ref = np.zeros(self.num_pages, np.int32)
        #: retained refcount-0 registered pages, insertion order == LRU
        self._cached: dict[int, None] = {}
        #: interned hash-chain keys: (parent_key, token chunk) -> key id.
        #: Exact token tuples (no lossy hashing); ids from a monotonic
        #: counter, never reused; mark-swept once the table doubles past
        #: the reachable set (_maybe_gc_intern)
        self._key_intern: dict[tuple[int, tuple[int, ...]], int] = {}
        self._next_key_id = 1
        self._intern_gc_floor = 1024
        self._intern_gc_at = self._intern_gc_floor
        self._prefix_index: dict[int, int] = {}  # key id -> physical page
        self._page_key: dict[int, int] = {}  # physical page -> key id
        #: device page copies scheduled by copy-on-write, applied by
        #: flush_copies before the next decode dispatch
        self._pending_copies: list[tuple[int, int]] = []
        self._cow_copies = 0
        self._evictions = 0
        self._gen_pages_shared = 0
        self._prefix_queries = 0
        self._prefix_hits = 0
        self._prefix_pages_hit = 0
        # --- host-memory victim tier (kv_host_pages) ---
        self.victim_tier = bool(self.prefix_cache and sc.kv_victim_tier
                                and sc.kv_host_pages > 0)
        self.host_pages = sc.kv_host_pages if self.victim_tier else 0
        #: per-pool host rings (n_layers, host_pages, per-page dims...),
        #: mirroring every device pool leaf but the page table; pinned when
        #: the device is a card
        self._host_pool: dict[str, torch.Tensor] = {}
        if self.victim_tier:
            for name, (shape, dt) in self._abstract()["layers"].items():
                if name != "page_table":
                    self._host_pool[name] = torch.zeros(
                        (shape[0], self.host_pages) + shape[2:], dtype=dt,
                        pin_memory=self.device.type == "cuda")
        self._host_free: list[int] = list(range(self.host_pages - 1, -1, -1))
        #: chain key -> host ring slot, insertion order == the ring's LRU
        self._host_index: dict[int, int] = {}
        self._host_key: dict[int, int] = {}  # host slot -> chain key
        #: host keys the current admit() must not evict while it allocates
        #: their swap-in device pages
        self._host_pins: set[int] = set()
        #: queued device->host copies (evictions of warm pages) and
        #: host->device copies (prefix hits on spilled chains), applied by
        #: flush_swaps at the executor's next dispatch
        self._pending_spills: list[tuple[int, int]] = []  # (page, host slot)
        self._pending_swap_ins: list[tuple[int, int]] = []  # (host slot, page)
        #: device page -> (host slot, chain key) of an unflushed swap-in
        self._swap_in_by_page: dict[int, tuple[int, int]] = {}
        self._swap_ins = 0
        self._swap_outs = 0
        self._host_evictions = 0
        self._swap_latency_s = 0.0
        #: the page table's sharding under ``shard_decode`` (set by the
        #: executor); ``write_table`` copies into the placed table in place,
        #: so its rebuilds keep this placement
        self.table_sharding = None
        #: the slots [lo, hi) whose page-table rows this rank's device table
        #: holds (all of them, unless ``shard_decode`` splits the slots)
        self.table_rows = (0, sc.max_batch)
        self.kv_bytes = sum(
            int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
            for group in self._abstract().values() for shape, dt in group.values()
        )

    # ----------------------------------------------------------- layout --
    def _layout_kw(self) -> dict:
        if self.layout == "paged":
            return dict(layout="paged", page_size=self.page_size, num_pages=self.num_pages)
        return dict(layout="dense")

    def _abstract(self) -> dict:
        return abstract_caches(
            self.cfg, self.serve_cfg.max_batch, self.serve_cfg.max_seq_len,
            dtype=self.dtype, quantized=self.quantized, **self._layout_kw(),
        )

    def init_device_caches(self) -> dict:
        return init_caches(
            self.cfg, self.serve_cfg.max_batch, self.serve_cfg.max_seq_len,
            dtype=self.dtype, quantized=self.quantized, device=self.device,
            **self._layout_kw(),
        )

    def device_shardings(self, rules) -> dict:
        """The ``NamedSharding`` tree of ``init_device_caches`` under
        ``rules`` (``distributed.sharding.ShardingRules``), for
        ``ServeConfig.shard_decode``."""
        from repro_torch.distributed.sharding import cache_shardings

        return cache_shardings(rules, self.cfg, self.serve_cfg.max_batch,
                               self.serve_cfg.max_seq_len, quantized=self.quantized,
                               **self._layout_kw())

    # ------------------------------------------------------- allocation --
    def pages_for(self, length: int) -> int:
        """Pages needed to hold ``length`` tokens (at least one)."""
        return max(1, -(-length // self.page_size))

    @property
    def pages_reserved_unallocated(self) -> int:
        """Reserved-but-not-yet-allocated pages (promised decode headroom)."""
        return sum(max(r - len(p), 0) for r, p in zip(self._slot_reserved, self._slot_pages))

    def can_reserve(self, n_pages: int) -> bool:
        """Whether the pool can promise ``n_pages`` to a new request without
        eating another resident's unallocated reservation.  Cached pages
        count as available: allocation evicts them LRU under pressure."""
        if self.layout != "paged":
            return True  # dense slabs are slot-bound; the engine gates on slots
        avail = len(self._free) + len(self._cached)
        return avail - self.pages_reserved_unallocated >= n_pages

    def _take_page(self) -> int | None:
        """Pop a free page, evicting the LRU cached page when the free list
        is empty; with a victim tier the evicted page's rows spill to the
        host ring (its chain key stays fetchable).  None when the pool is
        truly exhausted."""
        if self._free:
            return self._free.pop()
        if self._cached:
            page = next(iter(self._cached))
            del self._cached[page]
            self._spill(page)
            self._evictions += 1
            return page
        return None

    def _spill(self, page: int) -> None:
        """Deregister an evicted page; with a victim tier, move its chain
        key into the host index and queue the device->host row copy for
        ``flush_swaps`` (every dispatch flushes swaps before its device
        work, so the copy reads the rows before the page's new owner
        writes them).  Plain deregistration when the tier is off or the
        ring has no evictable slot."""
        key = self._page_key.pop(page, None)
        if key is not None and self._prefix_index.get(key) == page:
            del self._prefix_index[key]
        if not self.victim_tier or key is None:
            return
        if page in self._swap_in_by_page:
            # the page's content is itself an unflushed swap-in: the rows
            # never left the ring, so cancel the copy and re-register there
            self._cancel_swap_in(page)
            return
        host = self._host_take()
        if host is None:
            return  # ring exhausted (all pinned): discard, as without a tier
        self._host_index[key] = host
        self._host_key[host] = key
        self._pending_spills.append((page, host))
        self._swap_outs += 1

    def _host_take(self) -> int | None:
        """Pop a free ring slot, evicting the ring's LRU chain (its rows are
        gone) when it is full.  Keys pinned by an admission in progress are
        never victims."""
        if self._host_free:
            return self._host_free.pop()
        victim = next((k for k in self._host_index if k not in self._host_pins), None)
        if victim is None:
            return None
        host = self._host_index.pop(victim)
        del self._host_key[host]
        # an unflushed spill aimed at the recycled slot is superseded
        self._pending_spills = [(p, h) for p, h in self._pending_spills if h != host]
        self._host_evictions += 1
        return host

    def _cancel_swap_in(self, page: int) -> None:
        """Cancel the unflushed host->device copy aimed at ``page`` (evicted
        or freed before a dispatch flushed it) and restore its chain key on
        the ring slot, whose rows are intact."""
        host, key = self._swap_in_by_page.pop(page)
        self._pending_swap_ins = [(h, p) for h, p in self._pending_swap_ins if p != page]
        if key not in self._host_index and key not in self._prefix_index:
            self._host_index[key] = host
            self._host_key[host] = key
        elif host not in self._host_key:
            self._host_free.append(host)

    def _fetch_host(self, key: int) -> int:
        """Swap one spilled chain page back: a fresh device page, the
        host->device copy queued for ``flush_swaps``, the key registered on
        the device page (the ring slot frees once the copy is applied).
        Callers counted this allocation in ``admission_need``."""
        host = self._host_index.pop(key)
        del self._host_key[host]
        page = self._take_page()
        if page is None:
            self._host_index[key] = host
            self._host_key[host] = key
            raise RuntimeError(
                "KV page pool exhausted during victim-tier swap-in; "
                "check can_reserve(admission_need(...)) before admit()"
            )
        self._pending_swap_ins.append((host, page))
        self._swap_in_by_page[page] = (host, key)
        self._prefix_index[key] = page
        self._page_key[page] = key
        self._swap_ins += 1
        self._allocs_total += 1
        return page

    def _deregister(self, page: int) -> None:
        key = self._page_key.pop(page, None)
        if key is None:
            return
        if self._prefix_index.get(key) == page:
            del self._prefix_index[key]
        entry = self._swap_in_by_page.get(page)
        if entry is not None and entry[1] == key and key not in self._host_index:
            # deregistered by a write before its swap-in flushed: the ring
            # still holds the chain's rows, so the key stays fetchable there
            # (the pending copy still runs: the positions below the write
            # need the swapped rows)
            host = entry[0]
            self._host_index[key] = host
            self._host_key[host] = key

    def _intern_key(self, parent: int, chunk: tuple[int, ...]) -> int:
        key = self._key_intern.get((parent, chunk))
        if key is None:
            key = self._next_key_id
            self._next_key_id += 1
            self._key_intern[(parent, chunk)] = key
            self._maybe_gc_intern()
        return key

    def _maybe_gc_intern(self) -> None:
        """Mark-sweep the chain-key intern table once it doubles past its
        last post-sweep size: keep only keys reachable (via parent links)
        from a registered page or a resident slot's chain watermark."""
        if len(self._key_intern) <= self._intern_gc_at:
            return
        parent_of = {kid: parent for (parent, _), kid in self._key_intern.items()}
        live: set[int] = set()
        roots = list(self._prefix_index)
        for keys in self._slot_keys:
            roots.extend(keys)
        for key in roots:
            while key and key not in live:
                live.add(key)
                key = parent_of.get(key, 0)
        self._key_intern = {pk: kid for pk, kid in self._key_intern.items() if kid in live}
        self._intern_gc_at = max(self._intern_gc_floor, 2 * len(self._key_intern))

    # ----------------------------------------------------- prefix cache --
    def match_prefix(self, tokens: list[int]) -> PrefixMatch:
        """Longest run of leading *full* prompt pages in the prefix index:
        device-resident pages first, then (victim tier) chain keys whose
        rows live in the host ring.  The device run stays leading (a shared
        page sits at the same table column in every owner), so the walk
        ends at a chunk in neither tier, or at a device chunk after a host
        hit.  Pure lookup: hit/query telemetry is counted at ``admit``."""
        if not self.prefix_cache:
            return PrefixMatch()
        parent = 0
        pages: list[int] = []
        keys: list[int] = []
        for i in range(len(tokens) // self.page_size):
            chunk = tuple(tokens[i * self.page_size:(i + 1) * self.page_size])
            key = self._key_intern.get((parent, chunk))
            if key is None:
                break
            page = self._prefix_index.get(key)
            if page is not None and len(keys) == len(pages):
                pages.append(page)
            elif key not in self._host_index:
                break
            keys.append(key)
            parent = key
        return PrefixMatch(tuple(pages), tuple(keys), len(keys) * self.page_size)

    def _tail_need(self, match: PrefixMatch | None, reserve_len: int, write_from: int) -> int:
        """Pages this admission will still allocate beyond its shared
        coverage: the uncovered tail, plus one copy-on-write headroom page
        when the first decode write lands inside a covered page."""
        total = self.pages_for(min(reserve_len, self.serve_cfg.max_seq_len))
        shared = len(match.keys) if match else 0
        headroom = 1 if match and write_from < match.tokens else 0
        return max(total - shared, 0) + headroom

    def _revived(self, match: PrefixMatch | None) -> int:
        """Matched pages on the cached LRU (refcount 0): mapping them takes
        them out of the evictable pool."""
        if not match:
            return 0
        return sum(1 for p in match.pages if self._page_ref[p] == 0)

    def admission_need(self, match: PrefixMatch | None, reserve_len: int,
                       write_from: int) -> int:
        """Pages the pool must have available (free + evictable cached, net
        of other residents' unallocated reservations) to admit this
        request: its tail's worst case, the cached matched pages it revives,
        and one fresh page per host-tier hit."""
        if self.layout != "paged":
            return 0
        return (self._tail_need(match, reserve_len, write_from) + self._revived(match)
                + (match.host_hits if match else 0))

    def admit(
        self,
        slot: int,
        tokens: list[int],
        reserve_len: int,
        match: PrefixMatch | None = None,
        lazy_tail: bool = False,
        write_from: int | None = None,
        fill_len: int | None = None,
    ) -> int:
        """Admit a request: map a prefix-cache hit onto the slot's leading
        table entries (refcount++, reviving retained pages), reserve
        worst-case pages for the uncovered remainder (``reserve_len`` =
        prompt + generation budget, capped at max_seq_len), then allocate
        and register the prompt's own pages.  ``lazy_tail=True`` skips the
        prompt-tail allocation (prefill-skip fills it through decode
        writes, allocated by ``ensure``); ``fill_len`` (chunked prefill)
        allocates and registers only the leading ``fill_len`` positions.
        Returns the number of covered leading pages."""
        if write_from is None:
            write_from = len(tokens)
        if self.layout != "paged":
            self.alloc(slot, len(tokens))
            return 0
        if self.prefix_cache:
            self._prefix_queries += 1
        shared = list(match.pages) if match else []
        swapped = match.host_hits if match else 0
        need = self.admission_need(match, reserve_len, write_from)
        if not self.can_reserve(need):
            raise RuntimeError(
                f"cannot reserve {need} KV pages for admission; check "
                "can_reserve() before calling admit()"
            )
        tail_need = self._tail_need(match, reserve_len, write_from)
        if shared or swapped:
            self._prefix_hits += 1
            self._prefix_pages_hit += len(shared) + swapped
            pages = self._slot_pages[slot]
            for col, page in enumerate(shared):
                if self._page_ref[page] == 0:  # revive a retained page
                    del self._cached[page]
                self._page_ref[page] += 1
                self._table[slot, col] = page
                pages.append(page)
            if swapped:
                # each spilled chunk swaps back into a fresh device page; the
                # remaining host keys stay pinned, since a fetch's own
                # allocation can spill a page whose ring slot must not be one
                # this admission still needs
                host_keys = match.keys[len(shared):]
                self._host_pins = set(host_keys)
                try:
                    for col, key in enumerate(host_keys, start=len(shared)):
                        self._host_pins.discard(key)
                        page = self._fetch_host(key)
                        self._page_ref[page] = 1
                        self._table[slot, col] = page
                        pages.append(page)
                finally:
                    self._host_pins = set()
            self._slot_keys[slot] = list(match.keys)
            self._table_dirty = True
        self._slot_reserved[slot] = len(shared) + swapped + tail_need
        if not lazy_tail:
            self.ensure(slot, len(tokens))
            self.register_filled(slot, tokens, len(tokens))
        elif fill_len:
            # chunked prefill: the dispatch fills [0, fill_len); its full
            # pages are registerable (causal attention keeps their content
            # independent of the suffix)
            self.ensure(slot, fill_len)
            self.register_filled(slot, tokens, fill_len)
        self._peak_in_use = max(self._peak_in_use, self.pages_in_use)
        return len(shared) + swapped

    def fork_need(self, parent_slot: int, upto_len: int, reserve_len: int) -> int:
        """Pages a fork admission must reserve: the worst-case tail beyond
        the shared coverage, plus one copy-on-write headroom page."""
        if self.layout != "paged":
            return 0
        shared = min(-(-upto_len // self.page_size), len(self._slot_pages[parent_slot]))
        total = self.pages_for(min(reserve_len, self.serve_cfg.max_seq_len))
        return max(total - shared, 0) + (1 if shared else 0)

    def fork(self, slot: int, parent_slot: int, upto_len: int, reserve_len: int) -> int:
        """Map the parent's pages covering [0, ``upto_len``) onto ``slot``
        with a refcount bump each (the n-best sharing path; the child's
        own writes split off private copies through ``ensure``).  Returns
        the number of shared pages."""
        if self.layout != "paged":
            raise RuntimeError("fork() requires the paged layout")
        need = self.fork_need(parent_slot, upto_len, reserve_len)
        if not self.can_reserve(need):
            raise RuntimeError(
                f"cannot reserve {need} KV pages for fork; check "
                "can_reserve(fork_need()) before calling fork()"
            )
        parent_pages = self._slot_pages[parent_slot]
        n = min(-(-upto_len // self.page_size), len(parent_pages))
        pages = self._slot_pages[slot]
        if pages:
            raise RuntimeError(f"fork target slot {slot} already holds pages")
        for col in range(n):
            page = parent_pages[col]
            self._page_ref[page] += 1
            self._table[slot, col] = page
            pages.append(page)
        self._table_dirty = True
        self._slot_keys[slot] = list(self._slot_keys[parent_slot][:n])
        self._slot_reserved[slot] = n + need
        self._gen_pages_shared += n
        self._peak_in_use = max(self._peak_in_use, self.pages_in_use)
        return n

    def register_filled(self, slot: int, tokens: list[int], upto_len: int) -> None:
        """Register ``slot``'s fully written pages (positions
        [0, upto_len), token ids ``tokens``) in the prefix index.
        Idempotent and incremental (the slot's chain-key watermark)."""
        if not self.prefix_cache:
            return
        pages = self._slot_pages[slot]
        keys = self._slot_keys[slot]
        parent = keys[-1] if keys else 0
        for i in range(len(keys), min(upto_len // self.page_size, len(pages))):
            chunk = tuple(tokens[i * self.page_size:(i + 1) * self.page_size])
            parent = self._intern_key(parent, chunk)
            keys.append(parent)
            page = pages[i]
            if page in self._page_key or parent in self._prefix_index:
                continue
            self._prefix_index[parent] = page
            self._page_key[page] = parent

    def alloc(self, slot: int, length: int) -> None:
        """Ensure ``slot`` owns pages covering positions [0, length)."""
        self.ensure(slot, length)

    def ensure(self, slot: int, upto_len: int, write_from: int | None = None) -> None:
        """Grow ``slot``'s page list to cover ``upto_len`` positions (before
        each decode dispatch).  With ``write_from``, pages overlapping
        [write_from, upto_len) are made privately writable first: a shared
        page (refcount > 1) is copy-on-write replaced (fresh page, device
        copy queued for ``flush_copies``, table entry swapped), and a
        registered sole-owner page leaves the prefix index, so shared
        history is immutable."""
        if self.layout != "paged":
            if not self._slot_pages[slot]:
                self._slot_pages[slot] = [slot]
                self._allocs_total += 1
                self._peak_in_use = max(self._peak_in_use, self.pages_in_use)
            return
        pages = self._slot_pages[slot]
        need = self.pages_for(upto_len)
        while len(pages) < need:
            page = self._take_page()
            if page is None:
                raise RuntimeError(
                    f"KV page pool exhausted ({self.num_pages} pages of "
                    f"{self.page_size} tokens); raise ServeConfig.kv_pages "
                    "or admit fewer concurrent long sequences"
                )
            self._table[slot, len(pages)] = page
            pages.append(page)
            self._page_ref[page] = 1
            self._allocs_total += 1
            self._table_dirty = True
        if write_from is not None and upto_len > write_from:
            first = write_from // self.page_size
            last = (upto_len - 1) // self.page_size
            for col in range(first, min(last + 1, len(pages))):
                page = pages[col]
                if self._page_ref[page] > 1:
                    fresh = self._take_page()
                    if fresh is None:
                        raise RuntimeError(
                            "KV page pool exhausted during copy-on-write; "
                            "raise ServeConfig.kv_pages"
                        )
                    self._pending_copies.append((page, fresh))
                    self._page_ref[page] -= 1
                    self._page_ref[fresh] = 1
                    pages[col] = fresh
                    self._table[slot, col] = fresh
                    self._table_dirty = True
                    self._cow_copies += 1
                    self._allocs_total += 1
                    # the CoW headroom reserved at admission is now spent
                    self._slot_reserved[slot] = max(self._slot_reserved[slot] - 1, len(pages))
                    # the chunk content diverges from the chained key
                    del self._slot_keys[slot][col:]
                elif page in self._page_key:
                    # sole owner about to mutate a registered page
                    self._deregister(page)
                    del self._slot_keys[slot][col:]
        self._peak_in_use = max(self._peak_in_use, self.pages_in_use)

    def free(self, slot: int) -> None:
        """Drop a finished (or preempted) slot's references at once.  A
        page whose refcount falls to zero returns to the free list, unless
        it is registered in the prefix index (then it is retained on the
        evictable LRU)."""
        pages = self._slot_pages[slot]
        self._slot_pages[slot] = []
        self._slot_reserved[slot] = 0
        self._slot_keys[slot] = []
        if self.layout != "paged" or not pages:
            return
        freed: set[int] = set()
        for page in reversed(pages):
            self._page_ref[page] -= 1
            if self._page_ref[page] > 0:
                continue
            if self.prefix_cache and page in self._page_key:
                self._cached[page] = None
            else:
                self._free.append(page)
                freed.add(page)
        if freed and self._pending_copies:
            # a queued CoW copy whose destination just returned to the free
            # list died with this tenancy; flushing it later would corrupt
            # the page's next tenant
            self._pending_copies = [(s, d) for s, d in self._pending_copies if d not in freed]
        for page in freed:
            if page in self._swap_in_by_page:
                # likewise an unflushed swap-in aimed at a freed page: the
                # key and its rows stay fetchable in the ring
                self._cancel_swap_in(page)
        self._table[slot, :] = TRASH_PAGE
        self._table_dirty = True

    # ------------------------------------------------------ device sync --
    def take_flush(self, swaps: bool = True, copies: bool = True,
                   table: bool = True) -> dict | None:
        """Take the queued device work of a dispatch's host_prep off the
        queues, its host bookkeeping done: the victim tier's spills and
        swap-ins (``swaps``), the copy-on-write page copies (``copies``) and
        the page table when it changed (``table``), as host arrays; None
        when there is none.  :meth:`apply_flush` runs it on the device, on
        every rank of a ``shard_decode`` engine.  A spill's ring slot keeps
        the last page queued for it."""
        if self.layout != "paged":
            return None
        ops = {}
        if swaps and self._pending_spills:
            by_host = {h: p for p, h in self._pending_spills}
            self._pending_spills.clear()
            ops["spills"] = (np.array(list(by_host), np.int64),
                             np.array(list(by_host.values()), np.int64))
        if swaps and self._pending_swap_ins:
            ops["swap_ins"] = (np.array([h for h, _ in self._pending_swap_ins], np.int64),
                               np.array([p for _, p in self._pending_swap_ins], np.int64))
            for host, page in self._pending_swap_ins:
                self._swap_in_by_page.pop(page, None)
                # a slot whose key was restored meanwhile (its target page
                # deregistered) keeps the chain's rows; the others free
                if host not in self._host_key:
                    self._host_free.append(host)
            self._pending_swap_ins.clear()
        if copies and self._pending_copies:
            ops["copies"] = np.array(self._pending_copies, np.int64).T
            self._pending_copies.clear()
        if table and self._table_dirty:
            ops["table"] = self._table.copy()
            self._table_dirty = False
        return ops or None

    def apply_flush(self, caches: dict, ops: dict | None) -> dict:
        """Run :meth:`take_flush`'s ``ops`` on the device pools, in place:
        spills (evicted warm rows -> host ring) first, then swap-ins (ring
        rows -> fresh device pages), so a chain that spilled and matched
        again before any dispatch goes device -> host -> device in one
        flush; then the copy-on-write copies (a copy's destination can be a
        just-evicted page whose rows must reach the ring first); then this
        rank's rows of the page table (``table_rows``), copied into the
        placed table.  The victim tier's copies are batched, one per pool
        leaf and direction, through pinned buffers on a card; a spill's copy
        completes before this returns (the ring is host memory that a later
        swap-in reads); a swap-in copies up a pinned gather of its ring rows
        of its own, never the ring itself."""
        if not ops:
            return caches
        layers = caches["layers"]
        t0 = time.perf_counter()
        if "spills" in ops:
            hosts, pages = ops["spills"]
            pages = upload(pages, self.device)
            staged = {name: layers[name][:, pages].to("cpu", non_blocking=True)
                      for name in self._host_pool}  # pinned on a card
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            for name, ring in self._host_pool.items():
                ring.index_copy_(1, torch.from_numpy(hosts), staged[name])
        if "swap_ins" in ops:
            hosts, dst = ops["swap_ins"]
            hosts, dst = torch.from_numpy(hosts), upload(dst, self.device)
            for name, ring in self._host_pool.items():
                rows = torch.empty((ring.shape[0], len(hosts)) + ring.shape[2:],
                                   dtype=ring.dtype, pin_memory=ring.is_pinned())
                torch.index_select(ring, 1, hosts, out=rows)
                layers[name][:, dst] = rows.to(self.device, non_blocking=True)
        if "spills" in ops or "swap_ins" in ops:
            self._swap_latency_s += time.perf_counter() - t0
        if "copies" in ops:
            pairs = upload(ops["copies"], self.device)
            src, dst = pairs[0], pairs[1]
            for name, pool in layers.items():
                if name != "page_table":
                    pool[:, dst] = pool[:, src]
        if "table" in ops:
            lo, hi = self.table_rows
            table = upload(ops["table"][lo:hi], self.device)
            layers["page_table"].copy_(table.expand_as(layers["page_table"]))
        return caches

    def flush_copies(self, caches: dict) -> dict:
        """Apply the queued copy-on-write page copies to the device pools,
        in place (before the decode dispatch that writes the copied
        pages)."""
        return self.apply_flush(caches, self.take_flush(swaps=False, table=False))

    def flush_swaps(self, caches: dict) -> dict:
        """Apply the queued victim-tier movement to the device pools, in
        place (:meth:`apply_flush`'s spills, then swap-ins).  The executor
        runs it at the top of every dispatch's host_prep, before
        ``flush_copies``: a copy-on-write destination may be a just-evicted
        page whose rows must reach the ring first."""
        return self.apply_flush(caches, self.take_flush(copies=False, table=False))

    def write_table(self, caches: dict) -> dict:
        """Refresh the stacked device page table from the host table, in
        place (no-op for dense or when nothing changed since the last
        sync).  The host table goes up as a copy (``device.upload``): the
        device never sees a later ``ensure`` / ``free`` of the live numpy
        array.  In place, a placed (``shard_decode``) table keeps its
        placement."""
        return self.apply_flush(caches, self.take_flush(swaps=False, copies=False))

    def table_rows_of(self, slots) -> np.ndarray:
        """The host page-table rows of ``slots`` (the pad sentinel
        ``max_batch`` gets an all-trash row), for a prefill's insertion on a
        rank whose device table holds other slots' rows."""
        slots = np.asarray(slots, np.int64)
        nb = self._table.shape[0]
        rows = self._table[np.clip(slots, 0, nb - 1)].copy()
        rows[(slots < 0) | (slots >= nb)] = TRASH_PAGE
        return rows

    def insert_prefill(self, big: dict, filled: dict, slots, shared_pages=None,
                       table_rows=None) -> dict:
        """Insert tail-masked dense prefill rows into the big caches, in
        place.  ``shared_pages``: per-row count of leading prefix-cache
        pages that must not be rewritten (their columns go to the trash
        page); ``table_rows``: the slots' host page-table rows
        (:meth:`table_rows_of`), where the device table lacks them."""
        if self.layout == "paged":
            return insert_prefill_paged(big, filled, slots, self.page_size, shared_pages,
                                        table_rows)
        return insert_prefill_dense(big, filled, slots)

    # ---------------------------------------------------------- metrics --
    @property
    def pages_in_use(self) -> int:
        """Distinct live pages (a shared page counts once)."""
        if self.layout == "paged":
            return int((self._page_ref > 0).sum())
        return sum(len(p) for p in self._slot_pages)

    @property
    def pages_capacity(self) -> int:
        if self.layout == "paged":
            return self.num_pages - 1  # the trash page is not allocatable
        return self.serve_cfg.max_batch

    def stats(self) -> CacheStats:
        return CacheStats(
            layout=self.layout,
            kv_bytes=self.kv_bytes,
            page_size=self.page_size,
            pages_in_use=self.pages_in_use,
            pages_capacity=self.pages_capacity,
            page_allocs_total=self._allocs_total,
            pages_in_use_peak=self._peak_in_use,
            pages_cached=len(self._cached),
            prefix_queries=self._prefix_queries,
            prefix_hits=self._prefix_hits,
            prefix_pages_hit=self._prefix_pages_hit,
            cow_copies=self._cow_copies,
            page_evictions=self._evictions,
            gen_pages_shared=self._gen_pages_shared,
            swap_outs=self._swap_outs,
            swap_ins=self._swap_ins,
            host_evictions=self._host_evictions,
            host_pages_used=self.host_pages - len(self._host_free),
            host_pages_capacity=self.host_pages,
            swap_latency_s=self._swap_latency_s,
        )

    # ------------------------------------------------------- invariants --
    def check_invariants(self) -> None:
        """Assert the paged pool's structural invariants; raises
        AssertionError with a descriptive message on any violation."""
        if self.layout != "paged":
            return
        ref = self._page_ref
        assert ref[TRASH_PAGE] == 0, "trash page acquired a refcount"
        assert TRASH_PAGE not in self._free, "trash page on the free list"
        assert TRASH_PAGE not in self._cached, "trash page retained as cached"
        assert TRASH_PAGE not in self._page_key, "trash page registered"
        live = {p for p in range(self.num_pages) if ref[p] > 0}
        free_set, cached_set = set(self._free), set(self._cached)
        assert len(free_set) == len(self._free), "free list holds duplicates"
        assert not (free_set & cached_set), "page both free and cached"
        assert not (free_set & live), "live page on the free list"
        assert not (cached_set & live), "live page retained as cached"
        universe = free_set | cached_set | live
        expected = set(range(self.num_pages)) - {TRASH_PAGE}
        assert universe == expected, (
            f"page leak/double-free: missing={sorted(expected - universe)} "
            f"extra={sorted(universe - expected)}"
        )
        # refcount conservation: every reference is a slot table entry
        counts = np.zeros(self.num_pages, np.int64)
        for slot, pages in enumerate(self._slot_pages):
            for col, page in enumerate(pages):
                assert page != TRASH_PAGE, f"slot {slot} maps the trash page"
                assert self._table[slot, col] == page, f"table desync at slot {slot} col {col}"
                counts[page] += 1
            for col in range(len(pages), self.pages_per_slot):
                assert self._table[slot, col] == TRASH_PAGE, (
                    f"stale table entry at slot {slot} col {col}"
                )
        assert np.array_equal(counts, ref), (
            f"refcount drift: table refs {counts.nonzero()[0].tolist()} vs "
            f"refcounts {ref.nonzero()[0].tolist()}"
        )
        assert self.pages_in_use == len(live) == len(
            {p for pages in self._slot_pages for p in pages}
        ), "pages_in_use != distinct live table entries"
        for page in self._cached:
            assert page in self._page_key, "cached page lost its index key"
        for key, page in self._prefix_index.items():
            assert self._page_key.get(page) == key, f"index/page key desync for page {page}"
            assert page in live or page in cached_set, f"prefix index maps a freed page {page}"
        for page in self._page_key:
            assert page in live or page in cached_set, (
                f"registered page {page} is neither live nor cached"
            )
        for slot, (reserved, pages) in enumerate(zip(self._slot_reserved, self._slot_pages)):
            assert reserved >= len(pages) or reserved == 0, (
                f"slot {slot} holds more pages than it reserved"
            )
            assert len(self._slot_keys[slot]) <= len(pages), (
                f"slot {slot} chain-key watermark outran its page list"
            )
        # a page shared by several slots sits at the SAME table column in
        # every owner, so its tokens hold the same global positions in every
        # mapping (the paged gather's position arithmetic depends on it)
        col_of: dict[int, int] = {}
        for slot, pages in enumerate(self._slot_pages):
            for col, page in enumerate(pages):
                seen = col_of.setdefault(page, col)
                assert seen == col, (
                    f"shared page {page} mapped at column {seen} and at column {col} (slot {slot})"
                )
        # --- host victim tier: the ring is its own page universe ---
        assert len(self._host_index) == len(self._host_key), (
            "host index/reverse-map size mismatch"
        )
        for key, host in self._host_index.items():
            assert 0 <= host < self.host_pages, f"host slot {host} outside the ring"
            assert self._host_key.get(host) == key, f"host index/slot key desync for slot {host}"
            assert key not in self._prefix_index, f"chain key {key} served by both tiers"
        host_free = set(self._host_free)
        assert len(host_free) == len(self._host_free), "host free list holds duplicates"
        held = set(self._host_key)
        transit = {h for h, _ in self._pending_swap_ins}
        assert not (host_free & held), "host slot both free and indexed"
        assert not (host_free & transit), "host slot freed while its swap-in is still pending"
        assert host_free | held | transit == set(range(self.host_pages)), (
            "host slot leak/double-free"
        )
        assert {p for _, p in self._pending_swap_ins} == set(self._swap_in_by_page), (
            "pending swap-in queue and its page map desync"
        )
        for page in self._swap_in_by_page:
            assert ref[page] > 0 or page in self._cached, (
                f"pending swap-in targets page {page}, neither live nor cached"
            )
        for page, host in self._pending_spills:
            # a spill whose chain matched again before any flush: its ring
            # slot is in transit to a swap-in, which flush_swaps applies after
            # the spill (the reference's check flags this legal state)
            assert host in self._host_key or host in transit, (
                f"pending spill targets unindexed host slot {host}"
            )
