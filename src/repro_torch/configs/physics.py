"""The paper's three physics models (Table I).

| Parameter        | Engine | B-tagging | GW  |
| Seq. Length      | 50     | 15        | 100 |
| Input Vec. Size  | 1      | 6         | 2   |
| Transf. Blocks   | 3      | 3         | 2   |
| Hidden Vec. Size | 16     | 64        | 32  |
| Output Vec. Size | 2      | 3         | 1   |

Head count is not specified in the paper; head_dim=8 (h = d/8).  The engine
model has no normalization layer (Sec. V-A); the others use layer norm.
"""

from repro_torch.configs.base import ModelConfig


def _physics(name, seq, in_vec, blocks, d, n_classes, norm) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="dense",
        n_layers=blocks,
        d_model=d,
        n_heads=d // 8,
        n_kv_heads=d // 8,
        d_ff=2 * d,
        vocab_size=0,
        attn_kind="gqa",
        norm_kind=norm,
        act="relu",
        gated_mlp=False,
        mlp_bias=True,
        attn_bias=True,
        use_rope=False,  # learned positional embedding instead
        is_encoder=True,
        input_vec_size=in_vec,
        seq_len=seq,
        n_classes=n_classes,
        pool="mean",
        dtype="float32",
        serve_policy="paper_vu13p",
    )


def engine_anomaly() -> ModelConfig:
    return _physics("engine_anomaly", 50, 1, 3, 16, 2, "none")


def btagging() -> ModelConfig:
    return _physics("btagging", 15, 6, 3, 64, 3, "layernorm")


def gw() -> ModelConfig:
    return _physics("gw", 100, 2, 2, 32, 1, "layernorm")
