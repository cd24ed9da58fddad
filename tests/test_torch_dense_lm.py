"""The port's dense GQA LM path (``repro_torch.models.lm`` forward / prefill /
decode_step on the ``dense`` family, RoPE in ``models.layers``,
``models.attention.gqa_apply`` over a dense or rolling KV cache,
``serve.kv_cache``, ``convert.caches_from_numpy``) against the JAX package,
on the same parameters (numpy from a seed, transformed by the JAX package's
precision plan, carried across with ``params_from_numpy``) and the same
tokens.

Sizes: the reduced granite-8b (4/2 heads x 16), minicpm-2b (4 x 12) and
starcoder2-7b (4/2 x 16, window 8, untied head) configs, and a granite-like
mid-size config with the real head_dim 128 (d 512, 4/2 heads, d_ff 1024,
vocab 512, 2 layers).  Tolerance 2e-4 absolute on logits and caches (float32
sums in other orders; the reference's own tests hold prefill and decode to
5e-4 against a full forward, ``tests/test_serving.py``), the rolling buffer's
long decode to 1e-3 against a full forward as ``tests/test_serving.py`` does,
and greedy tokens identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import numpy_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import caches_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import attention, layers, lm  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402

ATOL = 2e-4
ROLLING_ATOL = 1e-3
NAMES = ["granite-8b", "minicpm-2b", "starcoder2-7b"]
POLICIES = ["float", "int8_serve"]
# granite-like, with the published head_dim 128
MID = dict(d_model=512, n_heads=4, n_kv_heads=2, d_ff=1024, vocab_size=512, n_layers=2)


def _configs(name, policy="float", **overrides):
    """(JAX config, port config), reduced, in float32."""
    jcfg = dataclasses.replace(jax_get_config(name, reduced=True), precision=policy, **overrides)
    tcfg = dataclasses.replace(get_config(name, reduced=True), precision=policy, **overrides)
    return jcfg, tcfg


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


def _tokens(jcfg, shape, seed):
    return np.random.default_rng(seed).integers(0, jcfg.vocab_size, shape).astype(np.int32)


def _greedy(jcfg, tcfg, params, prompt, steps, max_len, jkernel=None):
    """Greedy tokens (b, steps) of both packages, each fed its own tokens."""
    tparams = params_from_numpy(params, "cpu")
    b, s = prompt.shape
    last, caches = lm.prefill(tparams, tcfg, {"tokens": prompt},
                              lm.init_caches(tcfg, b, max_len, torch.float32, device="cpu"),
                              device="cpu")
    jcaches = jlm.init_caches(jcfg, b, max_len, dtype=jnp.float32)
    if jkernel is None:
        jlast, jcaches = _jprefill(params, jcfg, {"tokens": jnp.asarray(prompt)}, jcaches)
    else:  # eager: the kernel dict is not hashable
        jlast, jcaches = jlm.prefill(params, jcfg, {"tokens": jnp.asarray(prompt)}, jcaches,
                                     kernel=jkernel)
    _close(last, jlast)
    ours, theirs = [], []
    for i in range(steps):
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        jtok = jnp.argmax(jlast, -1)[:, None].astype(jnp.int32)
        ours.append(tok.numpy())
        theirs.append(np.asarray(jtok))
        pos = np.full((b,), s + i, np.int32)
        last, caches = lm.decode_step(tparams, tcfg, tok, pos, caches, device="cpu")
        jlast, jcaches = _jdecode(params, jcfg, jtok, jnp.asarray(pos), jcaches)
    return np.concatenate(ours, 1), np.concatenate(theirs, 1)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim", [12, 16, 128])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_freqs_match_reference(head_dim, theta):
    np.testing.assert_allclose(layers.rope_freqs(head_dim, theta).numpy(),
                               np.asarray(jlayers.rope_freqs(head_dim, theta)), rtol=1e-6)


@pytest.mark.parametrize("where", ["train", "decode", "extend"])
@pytest.mark.parametrize("head_dim", [16, 128])
def test_apply_rope_matches_reference(where, head_dim):
    """positions (S,) in train/prefill, (B, 1, 1) in decode, (B, 1, S) in
    extend, against x (B, H, S, D); positions up to 4100 (a long prompt)."""
    rng = np.random.default_rng(head_dim)
    b, h, s = 2, 3, 1 if where == "decode" else 7
    x = rng.normal(size=(b, h, s, head_dim)).astype(np.float32)
    pos = {"train": rng.integers(0, 4100, (s,)),
           "decode": rng.integers(0, 4100, (b, 1, 1)),
           "extend": rng.integers(0, 4100, (b, 1, s))}[where].astype(np.int32)
    ours = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    assert ours.shape == x.shape and ours.is_contiguous()
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=5e-6, rtol=0)
    half = layers.apply_rope(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(pos), 1e4)
    assert half.dtype == torch.bfloat16  # rotated in float32, cast back


# ---------------------------------------------------------------------------
# attention over a cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_gqa_apply_prefill_decode_match_reference(name):
    jcfg, tcfg = _configs(name)
    pj = numpy_tree(jattn.gqa_spec(jcfg), seed=11)
    pt = params_from_numpy(pj, "cpu")
    b, s, max_len = 2, 12, 16
    x = np.random.default_rng(12).normal(size=(b, s + 2, jcfg.d_model)).astype(np.float32)
    cache = kv_cache.init_attention_cache(tcfg, b, max_len, torch.float32, device="cpu")
    jcache = jkv.init_attention_cache(jcfg, b, max_len, jnp.float32)
    pos = np.arange(s, dtype=np.int32)
    out, cache = attention.gqa_apply(pt, tcfg, torch.from_numpy(x[:, :s]), torch.from_numpy(pos),
                                     mode="prefill", cache=cache)
    ref, jcache = jattn.gqa_apply(pj, jcfg, jnp.asarray(x[:, :s]), jnp.asarray(pos),
                                  mode="prefill", cache=jcache)
    _close(out, ref)
    _close(cache, jcache)
    for i in range(2):
        p = np.full((b,), s + i, np.int32)
        xi = x[:, s + i: s + i + 1]
        out, cache = attention.gqa_apply(pt, tcfg, torch.from_numpy(xi), torch.from_numpy(p),
                                         mode="decode", cache=cache)
        ref, jcache = jattn.gqa_apply(pj, jcfg, jnp.asarray(xi), jnp.asarray(p),
                                      mode="decode", cache=jcache)
        _close(out, ref)
        _close(cache, jcache)


@pytest.mark.parametrize("rolling", [False, True])
def test_decode_attend_matches_reference(rolling):
    rng = np.random.default_rng(3)
    b, hq, hkv, length, d = 3, 8, 2, 10, 16
    q = rng.normal(size=(b, hq, 1, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, hkv, length, d)).astype(np.float32) for _ in range(2))
    valid = rng.random((b, length)) < 0.6
    valid[:, 0] = True
    ours = attention._decode_attend(*(torch.from_numpy(t) for t in (q, k, v, valid)))
    ref = jattn._decode_attend(*(jnp.asarray(t) for t in (q, k, v, valid)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_unported_attention_paths_raise():
    """What the reference refuses, the port refuses: ``extend`` over a
    rolling sliding-window buffer (the reference's ValueError) and without
    positions.  The cache-extending ``extend`` mode itself, the int8 KV
    cache, MLA and the patch and audio frontends are ported
    (tests/test_torch_cache_extend.py, tests/test_torch_int8_kv.py,
    tests/test_torch_mla.py, tests/test_torch_frontends.py)."""
    jcfg, tcfg = _configs("granite-8b")
    pt = params_from_numpy(numpy_tree(jattn.gqa_spec(jcfg), 0), "cpu")
    x = torch.zeros(1, 2, tcfg.d_model)
    rolling = kv_cache.init_attention_cache(dataclasses.replace(tcfg, sliding_window=2), 1, 4,
                                            torch.float32, device="cpu")
    with pytest.raises(ValueError, match="position-addressed"):
        attention.gqa_apply(pt, tcfg, x, torch.zeros(1, 2, dtype=torch.int32), mode="extend",
                            cache=rolling)
    cache = kv_cache.init_attention_cache(tcfg, 1, 4, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="positions"):
        attention.gqa_apply(pt, tcfg, x, mode="extend", cache=cache)
    qcache = kv_cache.init_attention_cache(tcfg, 1, 4, torch.float32, quantized=True,
                                           device="cpu")
    attention.gqa_apply(pt, tcfg, x, mode="prefill", cache=qcache)
    assert qcache["k"].dtype == torch.int8 and bool((qcache["k_scale"][:, :, :2] > 0).all())
    for frontend in ("patch", "audio"):
        kw = dict(frontend=frontend, frontend_dim=32)
        spec = lm.param_spec(dataclasses.replace(tcfg, **kw))
        assert _shapes(spec) == _shapes(jlm.param_spec(dataclasses.replace(jcfg, **kw)))
        assert ("embed" in spec) == (frontend == "patch")
    with pytest.raises(ValueError, match="positions"):
        attention.gqa_apply(pt, tcfg, x[:, :1], mode="decode", cache=cache)


# ---------------------------------------------------------------------------
# the LM entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("policy", POLICIES)
def test_forward_prefill_decode_match_reference(name, policy):
    jcfg, tcfg = _configs(name, policy)
    params = _params(jcfg, seed=len(name) + len(policy))
    tparams = params_from_numpy(params, "cpu")
    b, s, extra = 2, 12, 4
    toks = _tokens(jcfg, (b, s + extra), seed=5)

    logits, _, aux = lm.forward(tparams, tcfg, {"tokens": toks}, device="cpu")
    ref, _, _ = _jfwd(params, jcfg, {"tokens": jnp.asarray(toks)}, mode="train")
    assert logits.shape == (b, s + extra, tcfg.padded_vocab_size) and aux["text_offset"] == 0
    _close(logits, ref)
    assert (logits[..., tcfg.vocab_size:] == -1e9).all()

    caches = lm.init_caches(tcfg, b, s + extra, torch.float32, device="cpu")
    jcaches = jlm.init_caches(jcfg, b, s + extra, dtype=jnp.float32)
    last, caches = lm.prefill(tparams, tcfg, {"tokens": toks[:, :s]}, caches, device="cpu")
    jlast, jcaches = _jprefill(params, jcfg, {"tokens": jnp.asarray(toks[:, :s])}, jcaches)
    _close(last, jlast)
    _close(caches, jcaches)
    for i in range(extra):
        tok, pos = toks[:, s + i: s + i + 1], np.full((b,), s + i, np.int32)
        last, caches = lm.decode_step(tparams, tcfg, tok, pos, caches, device="cpu")
        jlast, jcaches = _jdecode(params, jcfg, jnp.asarray(tok), jnp.asarray(pos), jcaches)
        _close(last, jlast)
        _close(caches, jcaches)
        if policy == "float":  # continuity: decode == the one-pass forward
            _close(last, ref[:, s + i])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("policy", POLICIES)
def test_greedy_tokens_identical_to_reference(name, policy):
    jcfg, tcfg = _configs(name, policy)
    params = _params(jcfg, seed=7)
    prompt = _tokens(jcfg, (2, 12), seed=8)
    ours, theirs = _greedy(jcfg, tcfg, params, prompt, steps=8, max_len=20)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("prompt_len", [6, 12])
def test_rolling_buffer_long_decode_matches_reference(prompt_len):
    """starcoder2-7b-reduced (window 8) decoded to 24 tokens: the rolling
    buffer, its slot positions included, equals the reference's after every
    step, and the logits match a full forward under the same window."""
    jcfg, tcfg = _configs("starcoder2-7b")
    params = _params(jcfg, seed=13)
    tparams = params_from_numpy(params, "cpu")
    total = 24
    toks = _tokens(jcfg, (1, total), seed=14)
    full, _, _ = lm.forward(tparams, tcfg, {"tokens": toks}, device="cpu")
    caches = lm.init_caches(tcfg, 1, total, torch.float32, device="cpu")
    jcaches = jlm.init_caches(jcfg, 1, total, dtype=jnp.float32)
    assert set(caches["layers"]) == {"k", "v", "slot_pos"}
    assert caches["layers"]["k"].shape[3] == jcfg.sliding_window == 8
    last, caches = lm.prefill(tparams, tcfg, {"tokens": toks[:, :prompt_len]}, caches,
                              device="cpu")
    jlast, jcaches = _jprefill(params, jcfg, {"tokens": jnp.asarray(toks[:, :prompt_len])},
                               jcaches)
    np.testing.assert_array_equal(caches["layers"]["slot_pos"].numpy(),
                                  np.asarray(jcaches["layers"]["slot_pos"]))
    _close(caches, jcaches)
    for i in range(prompt_len, total):
        pos = np.full((1,), i, np.int32)
        last, caches = lm.decode_step(tparams, tcfg, toks[:, i: i + 1], pos, caches, device="cpu")
        jlast, jcaches = _jdecode(params, jcfg, jnp.asarray(toks[:, i: i + 1]), jnp.asarray(pos),
                                  jcaches)
        np.testing.assert_array_equal(caches["layers"]["slot_pos"].numpy(),
                                      np.asarray(jcaches["layers"]["slot_pos"]))
        _close(caches, jcaches)
        _close(last, jlast)
        _close(last, full[:, i], atol=ROLLING_ATOL)


def test_mid_size_head_dim_128_matches_reference():
    """The published head_dim 128 through RoPE, the prefill attend and the
    decode attend: logits, caches and greedy tokens."""
    jcfg, tcfg = _configs("granite-8b", **MID)
    assert tcfg.resolved_head_dim == 128
    params = _params(jcfg, seed=21)
    tparams = params_from_numpy(params, "cpu")
    b, s = 2, 16
    toks = _tokens(jcfg, (b, s + 1), seed=22)
    caches = lm.init_caches(tcfg, b, s + 1, torch.float32, device="cpu")
    jcaches = jlm.init_caches(jcfg, b, s + 1, dtype=jnp.float32)
    last, caches = lm.prefill(tparams, tcfg, {"tokens": toks[:, :s]}, caches, device="cpu")
    jlast, jcaches = _jprefill(params, jcfg, {"tokens": jnp.asarray(toks[:, :s])}, jcaches)
    _close(last, jlast)
    _close(caches, jcaches)
    pos = np.full((b,), s, np.int32)
    last, caches = lm.decode_step(tparams, tcfg, toks[:, s:], pos, caches, device="cpu")
    jlast, jcaches = _jdecode(params, jcfg, jnp.asarray(toks[:, s:]), jnp.asarray(pos), jcaches)
    _close(last, jlast)
    _close(caches, jcaches)
    ours, theirs = _greedy(jcfg, tcfg, params, toks[:, :s], steps=6, max_len=s + 6)
    np.testing.assert_array_equal(ours, theirs)


def test_prefill_matches_the_pallas_kernel_in_interpret_mode():
    """The JAX side's prefill attend through its Pallas kernel (interpret
    mode, as the JAX package's kernel tests run it on the CPU)."""
    jcfg, tcfg = _configs("granite-8b")
    params = _params(jcfg, seed=31)
    prompt = _tokens(jcfg, (2, 12), seed=32)
    ours, theirs = _greedy(jcfg, tcfg, params, prompt, steps=4, max_len=16,
                           jkernel={"use_pallas": True, "interpret": True})
    np.testing.assert_array_equal(ours, theirs)


def test_caller_caches_left_unchanged():
    for name in ("granite-8b", "starcoder2-7b"):  # dense slab and rolling buffer
        _, cfg = _configs(name)
        params = lm.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 13), generator=torch.Generator().manual_seed(3))
        caches = lm.init_caches(cfg, 2, 16, torch.float32, device="cpu")
        empty = {k: v.clone() for k, v in caches["layers"].items()}
        _, filled = lm.prefill(params, cfg, {"tokens": toks[:, :12]}, caches, device="cpu")
        for k, v in caches["layers"].items():
            assert torch.equal(v, empty[k])
        before = {k: v.clone() for k, v in filled["layers"].items()}
        _, new = lm.decode_step(params, cfg, toks[:, 12:], torch.full((2,), 12), filled,
                                device="cpu")
        for k, v in filled["layers"].items():
            assert torch.equal(v, before[k])
            assert not torch.equal(new["layers"][k], v)
            assert new["layers"][k].data_ptr() != v.data_ptr()


# ---------------------------------------------------------------------------
# specs, caches, parameters
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int32: jnp.int32}


@pytest.mark.parametrize("name,reduced,max_len", [
    ("granite-8b", False, 2112), ("minicpm-2b", False, 512), ("starcoder2-7b", False, 2048),
    ("starcoder2-7b", False, 8192), ("granite-8b", True, 64), ("starcoder2-7b", True, 64),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_abstract_caches_match_reference(name, reduced, max_len, dtype):
    ours = kv_cache.abstract_caches(get_config(name, reduced), 3, max_len, dtype)
    ref = jkv.abstract_caches(jax_get_config(name, reduced), 3, max_len, _DTYPES[dtype])
    assert set(ours) == set(ref) == {"layers"}
    assert set(ours["layers"]) == set(ref["layers"])
    for k, (shape, dt) in ours["layers"].items():
        assert shape == ref["layers"][k].shape
        assert _DTYPES[dt] == ref["layers"][k].dtype
    rolling = name == "starcoder2-7b" and max_len > get_config(name, reduced).sliding_window
    assert ("slot_pos" in ours["layers"]) == rolling
    caches = kv_cache.init_caches(get_config("starcoder2-7b", True), 2, 64, dtype, device="cpu")
    assert (caches["layers"]["slot_pos"] == -1).all() and not caches["layers"]["k"].any()


@pytest.mark.parametrize("name", ["granite-8b", "starcoder2-7b"])
def test_caches_from_numpy_round_trip(name):
    """The JAX package's caches after its prefill, carried across, decode to
    the same logits and caches as the reference's next step."""
    jcfg, tcfg = _configs(name)
    params = _params(jcfg, seed=9)
    tparams = params_from_numpy(params, "cpu")
    toks = _tokens(jcfg, (2, 13), seed=10)
    _, jcaches = _jprefill(params, jcfg, {"tokens": jnp.asarray(toks[:, :12])},
                           jlm.init_caches(jcfg, 2, 16, dtype=jnp.float32))
    caches = caches_from_numpy(jax.tree.map(np.asarray, jcaches), "cpu")
    for k, (shape, dtype) in kv_cache.abstract_caches(tcfg, 2, 16, torch.float32)["layers"].items():
        assert caches["layers"][k].shape == shape and caches["layers"][k].dtype == dtype
    _close(caches, jcaches, atol=0)
    pos = np.full((2,), 12, np.int32)
    last, new = lm.decode_step(tparams, tcfg, toks[:, 12:], pos, caches, device="cpu")
    jlast, jnew = _jdecode(params, jcfg, jnp.asarray(toks[:, 12:]), jnp.asarray(pos), jcaches)
    _close(last, jlast)
    _close(new, jnew)
    with pytest.raises(ValueError, match="not a cache tree"):
        caches_from_numpy({"layers": {"k": np.zeros(1), "v": np.zeros(1),
                                      "k_scale": np.zeros(1)}}, "cpu")


def _shapes(spec):
    if isinstance(spec, dict):
        return {k: _shapes(v) for k, v in spec.items()}
    return tuple(spec.shape)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("reduced", [False, True])
def test_param_spec_and_count_match_reference(name, reduced):
    jcfg, tcfg = jax_get_config(name, reduced), get_config(name, reduced)
    assert _shapes(lm.param_spec(tcfg)) == _shapes(jlm.param_spec(jcfg))
    assert lm.count_params(tcfg) == jlm.count_params(jcfg)
    assert ("lm_head" in lm.param_spec(tcfg)) == (name == "starcoder2-7b")


def test_init_params_is_the_same_tree_leaf_by_leaf():
    """Drawing leaf by leaf gives the tree of one draw after another from the
    same CPU generator, each leaf in its own dtype."""
    cfg = dataclasses.replace(get_config("starcoder2-7b", reduced=True), dtype="bfloat16")
    a = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(0)
    spec = lm.param_spec(cfg)
    leaves = {}
    lm.params_lib.map_leaves(lambda p, s: leaves.setdefault(p, s), spec)
    for path in sorted(leaves):
        s = leaves[path]
        t = a
        for key in path:
            t = t[key]
        assert t.dtype == s.dtype == torch.bfloat16 and t.shape == s.shape
        if s.init in ("zeros", "ones"):
            continue
        scale = s.init_scale or (1.0 / s.shape[-2]) ** 0.5
        assert torch.equal(t, (torch.randn(s.shape, generator=gen) * scale).to(s.dtype))
