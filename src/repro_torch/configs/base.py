"""Config dataclasses (the model half of ``repro.configs.base``).

Plain dataclasses with the reference's fields, so a config converts field
for field.  ``ServeConfig``, ``TrainConfig``, ``ParallelismConfig`` and the
dry-run shapes wait for the slices that use them.
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
