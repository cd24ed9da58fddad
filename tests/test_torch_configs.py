"""The port's configs (physics, mamba2-130m, the dense GQA family, the MoE
family, minicpm3-4b, zamba2-1.2b, internvl2-1b and hubert-xlarge) equal
the JAX package's field for field."""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_NAMES as jax_arch_names  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.configs import ARCH_NAMES, PHYSICS_NAMES, get_config  # noqa: E402

DENSE = ["granite-8b", "minicpm-2b", "starcoder2-7b"]
MOE = ["granite-moe-3b-a800m", "dbrx-132b"]
OTHERS = ["zamba2-1.2b", "internvl2-1b", "hubert-xlarge"]  # hybrid, VLM, audio


@pytest.mark.parametrize("name", ["engine_anomaly", "btagging", "gw"])
def test_physics_config_fields_equal(name):
    ref, ours = jax_get_config(name), get_config(name)
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(ref)
    ]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.resolved_head_dim == ref.resolved_head_dim == 8


def test_registry_names_and_unported():
    """Every config of the JAX package's registry has its counterpart, field
    for field, published and reduced; only unknown names are refused."""
    assert PHYSICS_NAMES == ["engine_anomaly", "btagging", "gw"]
    assert sorted(ARCH_NAMES) == sorted(jax_arch_names) == sorted(
        DENSE + MOE + ["mamba2-130m", "minicpm3-4b"] + OTHERS)
    for name in DENSE + MOE + ["minicpm3-4b"] + OTHERS:
        for reduced in (False, True):
            ref, ours = jax_get_config(name, reduced), get_config(name, reduced)
            assert [f.name for f in dataclasses.fields(ours)] == [
                f.name for f in dataclasses.fields(ref)]
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
            assert ours.resolved_head_dim == ref.resolved_head_dim
    assert get_config("hubert-xlarge").resolved_head_dim == 80
    assert get_config("zamba2-1.2b").hybrid.attn_every == 6
    assert get_config("internvl2-1b", reduced=True).dtype == "float32"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-model")


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("reduced", [False, True])
def test_dense_config_fields_equal(name, reduced):
    ref, ours = jax_get_config(name, reduced), get_config(name, reduced)
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(ref)
    ]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.dtype == ("float32" if reduced else "bfloat16")
    assert ours.padded_vocab_size == ref.padded_vocab_size
    assert ours.resolved_head_dim == ref.resolved_head_dim
    if name == "minicpm-2b" and not reduced:
        assert ours.padded_vocab_size == 122880 and ours.emb_scale == 12.0
        assert ours.residual_scale == 1.4 / 40 ** 0.5 and ours.logit_scale == 256 / 2304
    if name == "starcoder2-7b":
        assert ours.sliding_window == (8 if reduced else 4096) and ours.rope_theta == 1e6
        assert not ours.tie_embeddings and ours.attn_bias and ours.mlp_bias


@pytest.mark.parametrize("reduced", [False, True])
def test_minicpm3_4b_config_fields_equal(reduced):
    """The MLA model, field for field, with its latent widths."""
    ref, ours = jax_get_config("minicpm3-4b", reduced), get_config("minicpm3-4b", reduced)
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(ref)
    ]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.attn_kind == "mla" and ours.serve_policy == "int8_serve"
    assert ours.dtype == ("float32" if reduced else "bfloat16")
    assert ours.padded_vocab_size == ref.padded_vocab_size
    if not reduced:
        m = ours.mla
        assert (ours.n_layers, ours.d_model, ours.n_heads, ours.d_ff) == (62, 2560, 40, 6400)
        assert (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim,
                m.v_head_dim) == (768, 256, 64, 32, 64)


@pytest.mark.parametrize("reduced", [False, True])
def test_mamba2_130m_config_fields_equal(reduced):
    ref, ours = jax_get_config("mamba2-130m", reduced), get_config("mamba2-130m", reduced)
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(ref)
    ]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.dtype == ("float32" if reduced else "bfloat16")
    assert ours.padded_vocab_size == ref.padded_vocab_size
    assert ours.padded_vocab_size == (256 if reduced else 50432)
    s, rs = ours.ssm, ref.ssm
    assert s.d_inner(ours.d_model) == rs.d_inner(ref.d_model)
    assert s.n_heads(ours.d_model) == rs.n_heads(ref.d_model) == (8 if reduced else 24)
