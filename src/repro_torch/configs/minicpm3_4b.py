"""minicpm3-4b [dense, MLA] — 62L d2560 40H (kv=40) d_ff=6400 vocab=73448.

MLA (multi-head latent attention) per hf:openbmb/MiniCPM3-4B:
q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head=64.
MiniCPM muP-style scaling: scale_emb=12, scale_depth=1.4, dim_model_base=256.
The KV cache is one packed latent of 256 + 32 values per token and layer,
shared by the 40 heads.
"""

import dataclasses

from repro_torch.configs.base import MLAConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_ff=6400,
        vocab_size=73448,
        head_dim=64,
        attn_kind="mla",
        mla=MLAConfig(
            q_lora_rank=768,
            kv_lora_rank=256,
            qk_nope_head_dim=64,
            qk_rope_head_dim=32,
            v_head_dim=64,
        ),
        norm_kind="rmsnorm",
        act="silu",
        gated_mlp=True,
        rope_theta=10000.0,
        tie_embeddings=True,
        emb_scale=12.0,
        residual_scale=1.4 / (62 ** 0.5),
        logit_scale=256.0 / 2560.0,
        serve_policy="int8_serve",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="minicpm3-4b-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        head_dim=16,
        mla=MLAConfig(
            q_lora_rank=32,
            kv_lora_rank=16,
            qk_nope_head_dim=8,
            qk_rope_head_dim=8,
            v_head_dim=8,
        ),
        residual_scale=1.4 / (2 ** 0.5),
        logit_scale=1.0,
        emb_scale=1.0,
    )
