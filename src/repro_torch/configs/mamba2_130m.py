"""mamba2-130m [ssm] -- 24 layers, d_model 768, attention-free, vocab 50280,
SSM state 128 (arXiv:2405.21060, SSD).

No softmax attention: the paper's streaming MHA and LUT softmax do not
apply; quantized projections and the staged RMSNorm do.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=1,  # unused (attention-free)
        n_kv_heads=1,
        d_ff=0,
        vocab_size=50280,
        attn_kind="none",
        norm_kind="rmsnorm",
        act="silu",
        gated_mlp=False,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=64),
        tie_embeddings=True,
        serve_policy="int8_serve",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="mamba2-130m-reduced",
        n_layers=2,
        d_model=32,
        vocab_size=128,
        ssm=SSMConfig(state_dim=16, head_dim=8, expand=2, chunk_size=16),
    )
