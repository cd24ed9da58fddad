"""zamba2-1.2b [hybrid] -- 38 layers, d_model 2048, 32 heads (kv 32),
d_ff 8192, vocab 32000, SSM state 64 (arXiv:2411.15242).

A Mamba2 backbone and one weight-shared transformer block (attention and a
gated MLP over concat(x, x_embed), width 2 d, then a projection back to d)
applied before the Mamba2 block of every ``attn_every``-th layer, each
application with its own KV cache: 7 applications at 38 layers.
"""

import dataclasses

from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        attn_kind="gqa",  # the shared block's
        norm_kind="rmsnorm",
        act="gelu",
        gated_mlp=True,
        rope_theta=10000.0,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=64),
        hybrid=HybridConfig(attn_every=6, concat_residual=True),
        tie_embeddings=True,
        serve_policy="int8_serve",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="zamba2-1.2b-reduced",
        n_layers=4,
        d_model=32,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab_size=128,
        ssm=SSMConfig(state_dim=8, head_dim=8, expand=2, chunk_size=16),
        hybrid=HybridConfig(attn_every=2, concat_residual=True),
    )
