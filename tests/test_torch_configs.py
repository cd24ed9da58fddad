"""The port's physics configs equal the JAX package's field for field."""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.configs import PHYSICS_NAMES, get_config  # noqa: E402


@pytest.mark.parametrize("name", ["engine_anomaly", "btagging", "gw"])
def test_physics_config_fields_equal(name):
    ref, ours = jax_get_config(name), get_config(name)
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(ref)
    ]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.resolved_head_dim == ref.resolved_head_dim == 8


def test_registry_names_and_unported():
    assert PHYSICS_NAMES == ["engine_anomaly", "btagging", "gw"]
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        get_config("granite-8b")


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
