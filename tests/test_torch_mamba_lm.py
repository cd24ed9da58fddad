"""The port's Mamba2 LM path (``repro_torch.models.lm`` forward / prefill /
decode_step on the ``ssm`` family, ``models.ssm.mamba_apply``,
``serve.kv_cache``, ``convert.caches_from_numpy``) against the JAX package,
on the same parameters (numpy from a seed, carried across with
``params_from_numpy``) and the same tokens.

Two sizes: ``mamba2-130m-reduced`` (d 32, P 8, N 16, chunk 16) and the
published SSM widths with 2 layers and a short vocab (d 768, 24 heads of
P 64, N 128, chunk 64).  Tolerance 2e-4 absolute on logits and caches, as
``tests/test_ssm.py`` (float32 sums in other orders; the chunked scan
against the step recurrence), and greedy tokens identical.  The random
embedding table is N(0, 0.1^2), which keeps the logits O(1-10) as a real
LM's: the error of either package's float32 logits grows with their scale
(with a N(0, 0.5^2) table, logits up to 168, the JAX package's own float32
logits differ from its float64 ones by 1.7e-4, the port's by 1.1e-4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import numpy_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import HybridConfig, MoEConfig, get_config  # noqa: E402
from repro_torch.convert import caches_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import blocks, lm, ssm  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402

ATOL = 2e-4
POLICIES = ["float", "int8_serve"]


def _configs(size, policy="float"):
    """(JAX config, port config) in float32."""
    if size == "reduced":
        jcfg = jax_get_config("mamba2-130m", reduced=True)
        tcfg = get_config("mamba2-130m", reduced=True)
    else:  # the published widths, 2 layers, a short vocab
        kw = dict(n_layers=2, vocab_size=500, dtype="float32")
        jcfg = dataclasses.replace(jax_get_config("mamba2-130m"), **kw)
        tcfg = dataclasses.replace(get_config("mamba2-130m"), **kw)
    return (dataclasses.replace(jcfg, precision=policy),
            dataclasses.replace(tcfg, precision=policy))


def _params(jcfg, seed):
    """numpy parameters, transformed by the JAX package's precision plan."""
    raw = numpy_tree(jlm.param_spec(jcfg), seed)
    plan = jprec.resolve_model_plan(jcfg)
    return jax.tree.map(np.asarray, jprec.apply_plan_to_params(raw, plan))


_jfwd = jax.jit(jlm.forward, static_argnums=(1,), static_argnames=("mode",))
_jprefill = jax.jit(jlm.prefill, static_argnums=(1,))
_jdecode = jax.jit(jlm.decode_step, static_argnums=(1,))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _close(ours, ref, atol=ATOL):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=atol, rtol=0),
                 _np(ours), _np(ref))


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def test_softplus_is_logaddexp_beyond_the_torch_threshold():
    x = np.array([-30.0, -1.0, 0.0, 5.0, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_array_equal(ssm._softplus(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(x))))


@pytest.mark.parametrize("l", [1, 2, 7])
def test_causal_conv_matches_reference(l):
    rng = np.random.default_rng(l)
    x = rng.normal(size=(2, l, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    ours = ssm._causal_conv(*(torch.from_numpy(t) for t in (x, w, b)))
    ref = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_mamba_apply_train_prefill_decode(size):
    jcfg, tcfg = _configs(size)
    pj = numpy_tree(jssm.mamba_spec(jcfg), seed=1)
    pt = params_from_numpy(pj, "cpu")
    l = jcfg.ssm.chunk_size
    x = np.random.default_rng(2).normal(size=(2, l + 1, jcfg.d_model)).astype(np.float32)

    out, none = ssm.mamba_apply(pt, tcfg, torch.from_numpy(x[:, :l]), mode="train")
    ref, _ = jssm.mamba_apply(pj, jcfg, jnp.asarray(x[:, :l]), mode="train")
    assert none is None
    _close(out, ref)

    cache = ssm.mamba_init_cache(tcfg, 2, device="cpu")
    jcache = jssm.mamba_init_cache(jcfg, 2)
    out, cache = ssm.mamba_apply(pt, tcfg, torch.from_numpy(x[:, :l]), mode="prefill", cache=cache)
    ref, jcache = jssm.mamba_apply(pj, jcfg, jnp.asarray(x[:, :l]), mode="prefill", cache=jcache)
    _close(out, ref)
    _close(cache, jcache)
    out, cache = ssm.mamba_apply(pt, tcfg, torch.from_numpy(x[:, l:]), mode="decode", cache=cache)
    ref, jcache = jssm.mamba_apply(pj, jcfg, jnp.asarray(x[:, l:]), mode="decode", cache=jcache)
    _close(out, ref)
    _close(cache, jcache)


def test_prefill_cache_tail_is_left_padded_pre_conv_input():
    """l < width - 1: the conv tail is the pre-conv xbc, zero-padded on the left."""
    jcfg, tcfg = _configs("reduced")
    pj = numpy_tree(jssm.mamba_spec(jcfg), seed=3)
    x = np.random.default_rng(4).normal(size=(2, 2, jcfg.d_model)).astype(np.float32)
    _, cache = ssm.mamba_apply(params_from_numpy(pj, "cpu"), tcfg, torch.from_numpy(x),
                               mode="prefill", cache=ssm.mamba_init_cache(tcfg, 2, device="cpu"))
    _, jcache = jssm.mamba_apply(pj, jcfg, jnp.asarray(x), mode="prefill",
                                 cache=jssm.mamba_init_cache(jcfg, 2))
    assert torch.equal(cache["conv_state"][:, 0], torch.zeros_like(cache["conv_state"][:, 0]))
    _close(cache, jcache)


# ---------------------------------------------------------------------------
# the LM entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("policy", POLICIES)
def test_forward_prefill_decode_match_reference(size, policy):
    jcfg, tcfg = _configs(size, policy)
    params = _params(jcfg, seed=len(policy))
    tparams = params_from_numpy(params, "cpu")
    q, b, extra = jcfg.ssm.chunk_size, 2, 3
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (b, 2 * q)).astype(np.int32)

    logits, _, aux = lm.forward(tparams, tcfg, {"tokens": toks}, device="cpu")
    ref, _, _ = _jfwd(params, jcfg, {"tokens": jnp.asarray(toks)}, mode="train")
    assert logits.shape == (b, 2 * q, tcfg.padded_vocab_size) and aux["text_offset"] == 0
    _close(logits, ref)
    assert (logits[..., tcfg.vocab_size:] == -1e9).all()

    caches = lm.init_caches(tcfg, b, 2 * q, device="cpu")
    jcaches = jlm.init_caches(jcfg, b, 2 * q, dtype=jnp.float32)
    last, caches = lm.prefill(tparams, tcfg, {"tokens": toks[:, :q]}, caches, device="cpu")
    jlast, jcaches = _jprefill(params, jcfg, {"tokens": jnp.asarray(toks[:, :q])}, jcaches)
    _close(last, jlast)
    _close(caches, jcaches)
    for i in range(extra):
        tok, pos = toks[:, q + i: q + i + 1], np.full((b,), q + i, np.int32)
        last, caches = lm.decode_step(tparams, tcfg, tok, pos, caches, device="cpu")
        jlast, jcaches = _jdecode(params, jcfg, jnp.asarray(tok), jnp.asarray(pos), jcaches)
        _close(last, jlast)
        _close(caches, jcaches)
        _close(last, ref[:, q + i])  # continuity: decode == the one-pass forward


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_greedy_tokens_identical_to_reference(size):
    jcfg, tcfg = _configs(size)
    params = _params(jcfg, seed=7)
    tparams = params_from_numpy(params, "cpu")
    b, s, steps = 2, 12, 8
    prompt = np.random.default_rng(8).integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)

    last, caches = lm.prefill(tparams, tcfg, {"tokens": prompt},
                              lm.init_caches(tcfg, b, s + steps, device="cpu"), device="cpu")
    jlast, jcaches = _jprefill(params, jcfg, {"tokens": jnp.asarray(prompt)},
                               jlm.init_caches(jcfg, b, s + steps, dtype=jnp.float32))
    ours, theirs = [], []
    for i in range(steps):
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        jtok = jnp.argmax(jlast, -1)[:, None].astype(jnp.int32)
        ours.append(tok.numpy())
        theirs.append(np.asarray(jtok))
        pos = np.full((b,), s + i, np.int32)
        last, caches = lm.decode_step(tparams, tcfg, tok, pos, caches, device="cpu")
        jlast, jcaches = _jdecode(params, jcfg, jtok, jnp.asarray(pos), jcaches)
    np.testing.assert_array_equal(np.concatenate(ours, 1), np.concatenate(theirs, 1))


def test_prefill_decode_continuity():
    """tests/test_ssm.py's check on the port alone: prefill a prompt, decode
    token by token, match the one-pass forward."""
    _, cfg = _configs("reduced")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b, s, extra = 2, 12, 4
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (b, s + extra), generator=gen)
    full, _, _ = lm.forward(params, cfg, {"tokens": toks[:, :16]}, device="cpu")
    last, caches = lm.prefill(params, cfg, {"tokens": toks[:, :s]},
                              lm.init_caches(cfg, b, s + extra, device="cpu"), device="cpu")
    torch.testing.assert_close(last, full[:, s - 1], atol=ATOL, rtol=0)
    for i in range(extra):
        last, caches = lm.decode_step(params, cfg, toks[:, s + i: s + i + 1],
                                      torch.full((b,), s + i), caches, device="cpu")
        torch.testing.assert_close(last, full[:, s + i], atol=ATOL, rtol=0)


def test_caches_from_numpy_round_trip():
    """The JAX package's caches after its prefill, carried across, decode to
    the same logits and caches as the reference's next step."""
    jcfg, tcfg = _configs("reduced")
    params = _params(jcfg, seed=9)
    tparams = params_from_numpy(params, "cpu")
    toks = np.random.default_rng(10).integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    _, jcaches = _jprefill(params, jcfg, {"tokens": jnp.asarray(toks[:, :16])},
                           jlm.init_caches(jcfg, 2, 17, dtype=jnp.float32))
    caches = caches_from_numpy(jax.tree.map(np.asarray, jcaches), "cpu")
    spec = kv_cache.abstract_caches(tcfg, 2, 17)
    for k, (shape, dtype) in spec["layers"].items():
        assert caches["layers"][k].shape == shape and caches["layers"][k].dtype == dtype
    _close(caches, jcaches, atol=0)
    pos = np.full((2,), 16, np.int32)
    last, new = lm.decode_step(tparams, tcfg, toks[:, 16:], pos, caches, device="cpu")
    jlast, jnew = _jdecode(params, jcfg, jnp.asarray(toks[:, 16:]), jnp.asarray(pos), jcaches)
    _close(last, jlast)
    _close(new, jnew)
    with pytest.raises(ValueError, match="not a cache tree"):
        caches_from_numpy({"layers": {"k": np.zeros(1)}, "shared": {}}, "cpu")


def test_caller_caches_left_unchanged():
    _, cfg = _configs("reduced")
    params = lm.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(3))
    caches = lm.init_caches(cfg, 2, 9, device="cpu")
    _, filled = lm.prefill(params, cfg, {"tokens": toks[:, :8]}, caches, device="cpu")
    assert all(float(t.abs().max()) == 0.0 for t in caches["layers"].values())
    before = {k: v.clone() for k, v in filled["layers"].items()}
    _, new = lm.decode_step(params, cfg, toks[:, 8:], torch.full((2,), 8), filled, device="cpu")
    for k, v in filled["layers"].items():
        assert torch.equal(v, before[k])
        assert not torch.equal(new["layers"][k], v)
        assert new["layers"][k].data_ptr() != v.data_ptr()


def test_prefill_length_must_fit_the_chunk():
    """chunk = min(chunk_size, l) and l % chunk == 0, as the reference."""
    _, cfg = _configs("reduced")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros(1, 20, dtype=torch.int64)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        lm.prefill(params, cfg, {"tokens": toks}, lm.init_caches(cfg, 1, 20, device="cpu"),
                   device="cpu")
    with pytest.raises(ValueError, match="positions"):
        lm.forward(params, cfg, {"tokens": toks[:, :1]}, mode="decode", device="cpu")


# ---------------------------------------------------------------------------
# specs, caches, registry
# ---------------------------------------------------------------------------


def _shapes(spec):
    if isinstance(spec, dict):
        return {k: _shapes(v) for k, v in spec.items()}
    return tuple(spec.shape)


@pytest.mark.parametrize("reduced", [False, True])
def test_param_spec_and_count_match_reference(reduced):
    jcfg, tcfg = jax_get_config("mamba2-130m", reduced), get_config("mamba2-130m", reduced)
    assert _shapes(lm.param_spec(tcfg)) == _shapes(jlm.param_spec(jcfg))
    assert lm.count_params(tcfg) == jlm.count_params(jcfg)
    if not reduced:
        assert lm.count_params(tcfg) == 129_100_224


def test_init_params_dtypes_and_seed():
    cfg = dataclasses.replace(get_config("mamba2-130m", reduced=True), dtype="bfloat16")
    a = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert a["embed"]["table"].dtype == torch.bfloat16
    mamba = a["blocks"]["mamba"]
    assert mamba["in_proj"]["kernel"].dtype == torch.bfloat16
    assert all(mamba[k].dtype == torch.float32 for k in ("A_log", "dt_bias", "D"))
    assert torch.equal(a["embed"]["table"], b["embed"]["table"])


@pytest.mark.parametrize("batch", [1, 3])
def test_cache_spec_matches_reference(batch):
    jcfg, tcfg = jax_get_config("mamba2-130m"), get_config("mamba2-130m")
    ours = kv_cache.abstract_caches(tcfg, batch, 64)
    ref = jlm.abstract_caches(jcfg, batch, 64, jnp.bfloat16)
    assert set(ours) == set(ref) == {"layers"}
    for k, (shape, dtype) in ours["layers"].items():
        assert shape == ref["layers"][k].shape
        assert dtype == torch.float32 and ref["layers"][k].dtype == jnp.float32


def test_unported_families_raise():
    """The other families are ported too: the hybrid blocks (Mamba2 with the
    shared block, tests/test_torch_hybrid.py), the moe block, the int8 KV
    cache and the MLA latent caches (tests/test_torch_moe.py,
    tests/test_torch_int8_kv.py, tests/test_torch_mla.py).  What stays
    refused: a rolling sliding-window buffer in the paged layout."""
    mamba = get_config("mamba2-130m", reduced=True)
    hybrid = dataclasses.replace(mamba, family="hybrid", n_heads=4, n_kv_heads=4,
                                 hybrid=HybridConfig(attn_every=2))
    assert blocks.block_spec(hybrid).keys() == blocks.block_spec(mamba).keys()
    moe = dataclasses.replace(get_config("gw"), moe=MoEConfig(4, 2, 16))
    assert blocks.block_kind(moe) == "moe"
    assert set(blocks.block_spec(moe)["ffn"]) == {"router", "w_up", "w_down"}
    quantized = kv_cache.abstract_caches(get_config("granite-8b"), 1, 16, quantized=True)
    assert quantized["layers"]["k"][1] == torch.int8
    assert quantized["layers"]["k_scale"] == ((36, 1, 8, 16), torch.float32)
    # the hybrid caches: the Mamba2 state per layer and the shared block's
    # float K/V per application, never int8 (the reference's)
    caches = kv_cache.abstract_caches(hybrid, 1, 16, quantized=True)
    assert set(caches) == {"layers", "shared"}
    assert caches["layers"] == kv_cache.abstract_caches(mamba, 1, 16)["layers"]
    assert caches["shared"]["k"] == ((1, 1, 4, 16, 16), torch.bfloat16)
    with pytest.raises(ValueError, match="rolling sliding-window"):
        kv_cache.abstract_caches(get_config("starcoder2-7b"), 1, 8192, layout="paged",
                                 page_size=8, num_pages=4)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _configs("reduced")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros(1, 4, dtype=torch.int64)
    dense = get_config("granite-8b", reduced=True)
    dparams = lm.init_params(dense, torch.Generator().manual_seed(0), device="cpu")
    dcaches = lm.init_caches(dense, 1, 8, torch.float32, device="cpu")
    for call in (lambda: lm.forward(params, cfg, {"tokens": toks}),
                 lambda: lm.init_caches(cfg, 1, 8),
                 lambda: lm.init_params(cfg, torch.Generator().manual_seed(0)),
                 lambda: lm.init_caches(dense, 1, 8),
                 lambda: lm.prefill(dparams, dense, {"tokens": toks}, dcaches),
                 lambda: lm.decode_step(dparams, dense, toks[:, :1], torch.zeros(1), dcaches)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
