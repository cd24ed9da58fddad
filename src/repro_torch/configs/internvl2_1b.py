"""internvl2-1b [vlm] -- 24 layers, d_model 896, 14 heads (GQA, kv 2) of 64,
d_ff 4864, vocab 151655 (arXiv:2404.16821: InternViT-300M and a Qwen2-0.5B
language model).

The vision encoder is a stub: the model takes 256 patch embeddings of width
``frontend_dim`` 1024, which ``frontend_proj`` maps into the embedding space
and puts before the text tokens.  Decode reads the image prefix from the KV
cache that prefill filled.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        attn_kind="gqa",
        norm_kind="rmsnorm",
        act="silu",
        gated_mlp=True,
        rope_theta=1_000_000.0,
        attn_bias=True,  # Qwen2's qkv bias
        frontend="patch",
        frontend_dim=1024,
        n_frontend_tokens=256,
        tie_embeddings=True,
        serve_policy="int8_serve",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="internvl2-1b-reduced",
        n_layers=2,
        d_model=56,
        n_heads=4,
        n_kv_heads=2,
        d_ff=112,
        vocab_size=128,
        frontend_dim=32,
        n_frontend_tokens=4,
    )
