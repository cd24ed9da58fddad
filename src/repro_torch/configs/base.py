"""Config dataclasses (port of ``repro.configs.base``): the model configs,
the dry-run shapes (``ShapeConfig``, ``SHAPES``), ``ParallelismConfig``,
``ServeConfig`` and ``TrainConfig``.

Plain dataclasses with the reference's fields and defaults, so a config
converts field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.quant import QuantConfig


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 style; minicpm3)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD (arXiv:2405.21060)."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 64
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: Mamba2 backbone + shared attention block."""

    attn_every: int = 6
    concat_residual: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default d_model // n_heads
    attn_kind: Literal["gqa", "mla", "none"] = "gqa"
    norm_kind: Literal["rmsnorm", "layernorm", "none"] = "rmsnorm"
    act: Literal["silu", "gelu", "relu"] = "silu"
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    sliding_window: int | None = None
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid: HybridConfig | None = None
    frontend: Literal["patch", "audio"] | None = None
    frontend_dim: int = 0
    n_frontend_tokens: int = 0
    is_encoder: bool = False
    tie_embeddings: bool = False
    attn_bias: bool = False
    mlp_bias: bool = False
    use_rope: bool = True  # physics models use learned positions instead
    emb_scale: float = 1.0
    residual_scale: float = 1.0  # applied to each residual branch
    logit_scale: float = 1.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # legacy per-model quantization knobs; lowered onto `precision` when set
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    # declarative per-layer precision: a PrecisionPolicy or preset name
    precision: PrecisionPolicy | str | None = None
    serve_policy: str = "float"
    # paper-style extras (physics models)
    input_vec_size: int = 0
    seq_len: int = 0
    n_classes: int = 0
    pool: Literal["mean", "last", "none"] = "none"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to a multiple of 256 (the reference's TP-friendly size)."""
        return ((self.vocab_size + 255) // 256) * 256

    def param_count_estimate(self) -> int:
        """Rough 6ND-style N (for MODEL_FLOPS; the exact count is
        ``models.lm.count_params``)."""
        d, l = self.d_model, self.n_layers
        emb = self.padded_vocab_size * d
        if self.attn_kind == "mla" and self.mla is not None:
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * self.n_heads * qk
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d
            )
        elif self.attn_kind == "none":
            attn = 0
        else:
            hd = self.resolved_head_dim
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family == "hybrid" and self.ssm is not None:
            # Mamba2 backbone layers + one weight-shared attention block
            s = self.ssm
            di = s.d_inner(d)
            per_mamba = d * (2 * di + 2 * s.n_groups * s.state_dim + s.n_heads(d)) + di * d
            w = 2 * d  # the shared block works in concat(x, x_embed) width
            ff_mult = 3 if self.gated_mlp else 2
            shared = 4 * w * w + ff_mult * w * self.d_ff + w * d
            return emb + l * per_mamba + shared + (0 if self.tie_embeddings else emb)
        if self.moe is not None:
            ff_mult = 3 if self.gated_mlp else 2
            ffn = self.moe.n_experts * ff_mult * d * self.moe.d_expert
        elif self.ssm is not None and self.attn_kind == "none":
            s = self.ssm
            di = s.d_inner(d)
            ffn = d * (2 * di + 2 * s.n_groups * s.state_dim + s.n_heads(d)) + di * d
        else:
            ff_mult = 3 if self.gated_mlp else 2
            ffn = ff_mult * d * self.d_ff
        return emb + l * (attn + ffn) + (0 if self.tie_embeddings else emb)

    def active_param_count_estimate(self) -> int:
        """Active params per token (MoE: the top_k experts only)."""
        if self.moe is None:
            return self.param_count_estimate()
        dense_like = dataclasses.replace(self, moe=None, d_ff=0, gated_mlp=False)
        base = dense_like.param_count_estimate()
        ff_mult = 3 if self.gated_mlp else 2
        active_ffn = self.n_layers * self.moe.top_k * ff_mult * self.d_model * self.moe.d_expert
        return base + active_ffn


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One dry-run input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ParallelismConfig:
    """Logical-axis -> mesh-axes mapping knobs (``distributed.sharding``),
    field for field the reference's."""

    dp: bool = True  # batch over ('pod','data')
    fsdp: bool = True  # weight non-TP axis over 'data'
    tp: bool = True  # heads/mlp/vocab over 'model'
    ep: bool = True  # experts over 'model'
    sp: bool = False  # sequence over 'model' (long-context cells)
    remat: Literal["none", "minimal", "full"] = "minimal"
    grad_accum: int = 1  # microbatch accumulation (activation memory / k)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training loop's knobs (``train.loop.run_training``), field for
    field the reference's."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: Literal["cosine", "wsd", "linear"] = "cosine"
    decay_fraction: float = 0.1  # WSD decay phase fraction
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    checkpoint_every: int = 200
    keep_checkpoints: int = 3
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The serving engine's knobs (``serve.api.Engine``), field for field
    the reference's.  On a card the prefill attends through the
    hand-written kernel, the reference's Pallas row: the executor reports
    ``cache_extend=False`` there whatever this asks, and the features that
    need the cache-extending prefill program (chunked prefill, prefix-skip,
    preemption resume, ``speculative``) are disabled with the reference's
    warnings.  ``shard_decode`` splits the slots over the ranks of the
    process group (``serve.api.Engine`` on rank 0, ``serve.api.serve_worker``
    on the others); ``replicas > 1`` is ``serve.router.ReplicaRouter``."""

    max_batch: int = 8
    max_seq_len: int = 1024
    #: engine-default softmax temperature (0.0 = greedy); a request's
    #: ``SamplingParams.temperature`` overrides it
    temperature: float = 0.0
    #: serving precision: a PrecisionPolicy, a preset name or None (the
    #: model's own policy)
    policy: PrecisionPolicy | str | None = None
    # --- KV-cache layout (serve/kv_cache.py CacheManager) ---
    #: "dense" per-slot slabs of max_seq_len tokens, or "paged" block-table
    #: pages; SSM and rolling-window caches fall back to dense
    kv_layout: Literal["dense", "paged"] = "dense"
    #: tokens per page; must divide max_seq_len
    kv_page_size: int = 16
    #: physical pages in the pool; None = every slot at full length + the
    #: trash page
    kv_pages: int | None = None
    #: share full prompt pages across same-prefix requests (paged layout;
    #: refcounts, LRU retention, copy-on-write)
    kv_prefix_cache: bool = False
    #: preempt the youngest resident instead of head-of-line blocking when
    #: the pool cannot cover the queue head (paged layout)
    kv_preemption: bool = False
    # --- host-memory victim tier (paged + prefix cache) ---
    kv_host_pages: int = 0
    kv_victim_tier: bool = True
    # --- bucketed prefill + multi-step decode ---
    #: prompt-length buckets; None = powers of two up to max_seq_len,
    #: () = exact-length prefill
    prefill_buckets: tuple[int, ...] | None = None
    #: decode tokens per dispatch
    decode_steps: int = 4
    #: prompts admitted per step; 0 = every free slot
    max_prefill_per_step: int = 0
    #: chunked prefill: admit a longer prompt by its first chunk, then
    #: replay the tail interleaved with resident decode; None = off
    prefill_chunk: int | None = None
    #: the cache-extending prefill program (False on a card: the kernel prefill)
    cache_extend: bool = True
    # --- speculative decoding (needs the cache-extending program) ---
    speculative: bool = False
    spec_tokens: int = 4
    draft_config: str | None = None
    # --- SLO-aware scheduling (serve/slo.py DeadlineScheduler) ---
    #: "fifo" or "edf" (earliest deadline first)
    scheduler: Literal["fifo", "edf"] = "fifo"
    #: default per-request deadline in ms from submit; None = none
    deadline_ms: float | None = None
    #: what EDF does with a queued request past its deadline
    overdue_policy: Literal["drop", "demote", "ignore"] = "drop"
    # --- step-phase tracing (serve/phases.py) ---
    trace_phases: bool = False
    phase_ring: int = 512
    phase_mode: Literal["fenced", "overlap"] = "fenced"
    # --- pipelined loop: dispatch N+1 before collecting N ---
    async_loop: bool = False
    # --- mesh-sharded decode: the slots split over the process group's ranks ---
    shard_decode: bool = False
    # --- data-parallel replicas behind serve.router.ReplicaRouter ---
    replicas: int = 1

    def resolved_buckets(self) -> tuple[int, ...]:
        """Prefill buckets, ascending.  Auto mode: powers of two in
        [8, max_seq_len]."""
        if self.prefill_buckets is not None:
            return tuple(sorted(self.prefill_buckets))
        buckets, b = [], 8
        while b < self.max_seq_len:
            buckets.append(b)
            b *= 2
        buckets.append(self.max_seq_len)
        return tuple(buckets)
