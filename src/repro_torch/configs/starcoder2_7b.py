"""starcoder2-7b [dense] — 32L d4608 36H (GQA kv=4) d_ff=18432 vocab=49152.

arXiv:2402.19173 — GQA + RoPE + sliding-window attention (4096), LayerNorm,
non-gated GELU MLP, biases on attn/mlp, untied ``lm_head``.  The sliding
window gives this arch a rolling-buffer KV cache (``serve.kv_cache``):
decode costs O(window) per token.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        n_layers=32,
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        d_ff=18432,
        vocab_size=49152,
        attn_kind="gqa",
        norm_kind="layernorm",
        act="gelu",
        gated_mlp=False,
        rope_theta=1_000_000.0,
        sliding_window=4096,
        attn_bias=True,
        mlp_bias=True,
        tie_embeddings=False,
        serve_policy="int8_serve",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="starcoder2-7b-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=128,
        sliding_window=8,
    )
