"""dbrx-132b [moe] — 40L d6144 48H (GQA kv=8) expert d_ff=10752
vocab=100352, MoE 16 experts top-4 (fine-grained).

hf:databricks/dbrx-base (the dimensions are the JAX package's, which marks
them unverified).
"""

import dataclasses

from repro_torch.configs.base import MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        attn_kind="gqa",
        norm_kind="layernorm",
        act="silu",
        gated_mlp=True,
        rope_theta=500_000.0,
        moe=MoEConfig(n_experts=16, top_k=4, d_expert=10752),
        tie_embeddings=False,
        serve_policy="int8_serve",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="dbrx-132b-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=128,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=96),
    )
