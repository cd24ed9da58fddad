"""hubert-xlarge [audio] -- 48 layers, d_model 1280, 16 heads (kv 16) of 80,
d_ff 5120, vocab 504 (arXiv:2106.07447).

An encoder (bidirectional attention, no decode step).  The convolutional
feature extractor is a stub: the model takes frame embeddings of width
``frontend_dim`` 512, which ``frontend_proj`` maps to d_model, and trains on
masked-unit prediction over 504 cluster units.  RoPE stands in for HuBERT's
convolutional relative position embedding, as in the JAX package.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        attn_kind="gqa",
        norm_kind="layernorm",
        act="gelu",
        gated_mlp=False,
        attn_bias=True,
        mlp_bias=True,
        frontend="audio",
        frontend_dim=512,
        is_encoder=True,
        tie_embeddings=False,
        serve_policy="int8_serve",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="hubert-xlarge-reduced",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab_size=32,
        frontend_dim=16,
    )
