"""granite-8b [dense] — 36L d4096 32H (GQA kv=8) d_ff=14336 vocab=49152.

arXiv:2405.04324 (Granite Code Models) — llama-arch code model.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=49152,
        attn_kind="gqa",
        norm_kind="rmsnorm",
        act="silu",
        gated_mlp=True,
        rope_theta=10000.0,
        tie_embeddings=True,
        serve_policy="int8_serve",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="granite-8b-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=128,
    )
