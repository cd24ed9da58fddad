"""Three-term roofline of a counted dry-run cell (port of
``repro.roofline.analysis``), on the H100.

    compute_s    = sum over types of FLOPs_per_device[type] / peak[type]
    memory_s     = bytes_per_device   / HBM bandwidth
    collective_s = coll_bytes_per_device / (NVLink links x link rate)

The FLOPs and bytes come from ``op_counter``'s count of one eager step on
``meta`` tensors at the per-device batch (``launch.dryrun``): no trip
counts, every layer dispatches its own ops.  Two variants per cell:

* **baseline**: the step as eager PyTorch runs its plain versions, the
  attention volume materialized in HBM;
* **fused**: the ``attnvol`` volume re-priced as the fused attention
  kernel by :func:`attention_flops` / :func:`attention_io_bytes`, and every
  other kernel's plain version by its ``kernel_costs`` (on the card those
  run as kernels), as :func:`fused_work` sets out.

MODEL_FLOPS uses the 6ND rule (6 x params x tokens for training; 2ND for
a forward-only pass) with N = active params for MoE.
"""

from __future__ import annotations

import collections
import dataclasses
import math

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.latency_model import H100, HardwareSpec, RooflineTerms, roofline_by_type
from repro_torch.roofline.op_counter import Count

# ---------------------------------------------------------------------------
# analytic attention-kernel cost model (the fused kernel)
# ---------------------------------------------------------------------------


def _attn_geometry(cfg: ModelConfig):
    """(layers_with_attention, n_heads, qk_head_dim, v_head_dim, kv_heads)."""
    if cfg.attn_kind == "none":
        return 0, 0, 0, 0, 0
    if cfg.family == "hybrid":
        n_apps = math.ceil(cfg.n_layers / cfg.hybrid.attn_every)
        width = 2 * cfg.d_model if cfg.hybrid.concat_residual else cfg.d_model
        hd = cfg.head_dim or width // cfg.n_heads  # set where the heads are a device's
        return n_apps, cfg.n_heads, hd, hd, cfg.n_kv_heads
    if cfg.attn_kind == "mla" and cfg.mla is not None:
        qk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        return cfg.n_layers, cfg.n_heads, qk, cfg.mla.v_head_dim, cfg.n_heads
    hd = cfg.resolved_head_dim
    return cfg.n_layers, cfg.n_heads, hd, hd, cfg.n_kv_heads


def attention_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global fused-kernel attention FLOPs: 2*(QK^T) + 2*(PV) per position
    pair, causal-halved, window-clipped; x3 for training (fwd+bwd)."""
    layers, h, qk_hd, v_hd, _ = _attn_geometry(cfg)
    if layers == 0:
        return 0.0
    b, l = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        ctx = min(l, cfg.sliding_window or l)
        per_layer = 2.0 * b * ctx * h * (qk_hd + v_hd)
        return per_layer * layers
    if cfg.sliding_window is not None and cfg.sliding_window < l:
        pairs = l * cfg.sliding_window  # each query sees <= window keys
    else:
        pairs = l * l / 2.0  # causal
        if cfg.is_encoder:
            pairs = l * l
    per_layer = 2.0 * b * pairs * h * (qk_hd + v_hd)
    mult = 3.0 if shape.kind == "train" else 1.0
    return per_layer * mult * layers


def attention_io_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global HBM traffic of the fused kernel: q/k/v/out streamed once
    (train: ~3x for fwd+bwd), plus cache reads for decode."""
    layers, h, qk_hd, v_hd, hkv = _attn_geometry(cfg)
    if layers == 0:
        return 0.0
    b, l = shape.global_batch, shape.seq_len
    bpe = 2.0  # bf16 activations
    if shape.kind == "decode":
        ctx = min(l, cfg.sliding_window or l)
        if cfg.attn_kind == "mla" and cfg.mla is not None:
            cache = b * ctx * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim)
        else:
            cache = 2.0 * b * hkv * ctx * qk_hd
        per_layer = cache * bpe + b * h * (qk_hd + v_hd) * bpe
        return per_layer * layers
    qo = 2.0 * b * l * h * max(qk_hd, v_hd)
    kv = 2.0 * b * l * hkv * qk_hd
    mult = 3.0 if shape.kind == "train" else 1.0
    return (qo + kv) * bpe * mult * layers


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6ND (train) / 2ND (prefill) / 2ND per token (decode)."""
    n_active = cfg.active_param_count_estimate()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# re-pricing a count
# ---------------------------------------------------------------------------


def attention_type(count: Count, cfg: ModelConfig) -> str:
    """The type the fused attention runs in: that of the step's attention
    kernel calls (bf16 as itself, float32 as 3xTF32), else the config's."""
    for call in count.calls:
        if call.cost.kernel == "flash_attention":
            return next(iter(call.cost.flops))
    return "tf32x3" if cfg.dtype == "float32" else cfg.dtype


def fused_work(count: Count, cfg: ModelConfig, shape: ShapeConfig) -> tuple[dict, float]:
    """(FLOPs by type, bytes) of ``count`` with the attention volume (the
    ``attnvol`` ops, and any attention kernel launch) re-priced by
    :func:`attention_flops` / :func:`attention_io_bytes` at ``shape`` (the
    per-device shape), and each other kernel's plain version (its ops in the
    count) replaced by its ``kernel_costs``.  On a count of the card, where
    the kernels launched, this differs from ``count.flops`` only by the
    attention's pricing."""
    flops = collections.defaultdict(float, count.ops.flops)
    nbytes = count.ops.bytes

    def add(tally_flops, tally_bytes, sign):
        nonlocal nbytes
        for t, f in tally_flops.items():
            flops[t] += sign * f
        nbytes += sign * tally_bytes

    add(count.attn.flops, count.attn.bytes, -1)
    for tally in count.plain.values():
        add(tally.flops, tally.bytes, -1)
    add(count.attn_in_plain.flops, count.attn_in_plain.bytes, +1)  # removed twice above
    for call in count.calls:
        if call.cost.kernel != "flash_attention":
            add(call.cost.flops, call.cost.bytes, +1)
    add({attention_type(count, cfg): attention_flops(cfg, shape)},
        attention_io_bytes(cfg, shape), +1)
    return {t: f for t, f in flops.items() if f}, nbytes


# ---------------------------------------------------------------------------
# cell analysis
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellAnalysis:
    """The reference's fields.  ``trip_counts`` holds the layer count (the
    reference's loop trip counts; eager dispatch needs none).  The
    ``*_by_type`` fields add the FLOPs by the type they are priced at."""

    arch: str
    shape: str
    mesh: str
    n_devices: int
    # baseline (the step as eager runs its plain versions)
    flops: float
    hbm_bytes: float
    coll_bytes: dict[str, float]
    terms: RooflineTerms
    # fused variant (attnvol re-priced as the fused kernel, kernels by their cost)
    flops_fused: float
    hbm_bytes_fused: float
    terms_fused: RooflineTerms
    attn_flops_hlo: float
    attn_hbm_hlo: float
    model_flops_global: float
    useful_ratio: float  # MODEL_FLOPS / (FLOPs x devices), baseline
    useful_ratio_fused: float
    memory_stats: dict[str, int]
    trip_counts: list[int]
    flops_by_type: dict[str, float] = dataclasses.field(default_factory=dict)
    flops_fused_by_type: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def dominant(self) -> str:
        return self.terms.dominant

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        for key, t in (("terms", self.terms), ("terms_fused", self.terms_fused)):
            d[key] = {
                "compute_s": t.compute_s,
                "memory_s": t.memory_s,
                "collective_s": t.collective_s,
                "dominant": t.dominant,
            }
        return d


def analyze_cell(
    *,
    arch: str,
    shape_cfg: ShapeConfig,
    cfg: ModelConfig,
    mesh_name: str,
    n_devices: int,
    count: Count,
    device_shape: ShapeConfig | None = None,
    coll_bytes: dict[str, float] | None = None,
    memory_stats: dict[str, int] | None = None,
    hw: HardwareSpec = H100,
    device_cfg: ModelConfig | None = None,
) -> CellAnalysis:
    """``count``: one device's step (``launch.dryrun``), at
    ``device_shape`` (the per-device batch; default ``shape_cfg``) and with
    ``device_cfg``'s attention heads (its share under a model split;
    default ``cfg``), which price the fused attention.
    ``coll_bytes``: its collectives' bytes by kind.  ``memory_stats``: the
    argument and output bytes per device; the temp bytes are the count's
    peak of live op outputs, and ``alias_bytes`` is 0 (the port updates the
    state and caches in place; nothing is donated)."""
    device_shape = device_shape or shape_cfg
    coll_bytes = dict(coll_bytes or {})
    coll_total = math.fsum(coll_bytes.values())
    flops_by_type = count.flops
    terms = roofline_by_type(flops_by_type, count.hbm_bytes, coll_total, hw)
    fused_by_type, hbm_fused = fused_work(count, device_cfg or cfg, device_shape)
    terms_fused = roofline_by_type(fused_by_type, hbm_fused, coll_total, hw)
    stats = dict(memory_stats or {})
    stats.update(temp_bytes=int(count.peak_live_bytes), alias_bytes=0)
    mf = model_flops(cfg, shape_cfg) + attention_flops(cfg, shape_cfg)
    flops, flops_fused = count.total_flops, math.fsum(fused_by_type.values())
    total, total_fused = flops * n_devices, flops_fused * n_devices
    return CellAnalysis(
        arch=arch,
        shape=shape_cfg.name,
        mesh=mesh_name,
        n_devices=n_devices,
        flops=flops,
        hbm_bytes=count.hbm_bytes,
        coll_bytes=coll_bytes,
        terms=terms,
        flops_fused=flops_fused,
        hbm_bytes_fused=hbm_fused,
        terms_fused=terms_fused,
        attn_flops_hlo=count.attn_flops,
        attn_hbm_hlo=count.attn_hbm_bytes,
        model_flops_global=mf,
        useful_ratio=(mf / total) if total else 0.0,
        useful_ratio_fused=(mf / total_fused) if total_fused else 0.0,
        memory_stats=stats,
        trip_counts=[cfg.n_layers],
        flops_by_type=flops_by_type,
        flops_fused_by_type=fused_by_type,
    )
