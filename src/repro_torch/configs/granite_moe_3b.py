"""granite-moe-3b-a800m [moe] — 32L d1536 24H (GQA kv=8) expert d_ff=512
vocab=49155, MoE 40 experts top-8.

hf:ibm-granite/granite-3.0-*-base family.  The spec line says "MoE 40e
top-8" while its bracket note says "32 experts top-8"; the JAX package
follows the spec line (40 experts, top-8), and so does this copy.
"""

import dataclasses

from repro_torch.configs.base import MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        attn_kind="gqa",
        norm_kind="rmsnorm",
        act="silu",
        gated_mlp=True,
        rope_theta=10000.0,
        moe=MoEConfig(n_experts=40, top_k=8, d_expert=512),
        tie_embeddings=True,
        serve_policy="int8_serve",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="granite-moe-3b-a800m-reduced",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=2,
        d_ff=32,
        vocab_size=128,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=32),
    )
