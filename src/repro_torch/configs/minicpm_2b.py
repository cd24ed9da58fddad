"""minicpm-2b [dense] — 40L d2304 36H (kv=36, MHA) d_ff=5760 vocab=122753.

arXiv:2404.06395 — llama-like arch with muP scaling (scale_emb=12,
scale_depth=1.4, dim_model_base=256): the embedding is scaled by 12, each
residual branch by 1.4/sqrt(40) and the logits by 256/2304.  The vocab pads
to 122880.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b",
        family="dense",
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,
        d_ff=5760,
        vocab_size=122753,
        attn_kind="gqa",
        norm_kind="rmsnorm",
        act="silu",
        gated_mlp=True,
        rope_theta=10000.0,
        tie_embeddings=True,
        emb_scale=12.0,
        residual_scale=1.4 / (40 ** 0.5),
        logit_scale=256.0 / 2304.0,
        serve_policy="int8_serve",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="minicpm-2b-reduced",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab_size=128,
        residual_scale=1.4 / (2 ** 0.5),
        logit_scale=1.0,
        emb_scale=1.0,
    )
