"""The port's hybrid family (zamba2-1.2b: Mamba2 blocks and the Zamba2
shared attention block) against the JAX package, on the CPU, on the same
parameters (numpy from a seed, carried across with ``params_from_numpy``)
and the same tokens.

- ``blocks.shared_attn_apply`` in train, prefill and decode: within 1e-5;
- ``lm.forward`` on zamba2-1.2b-reduced within 1e-5 of the logits' scale,
  max(1, max |logit|): the Mamba2 scan sums in other orders (the port's
  in-chunk prefix sums are float64, tests/test_torch_mamba_lm.py);
- prefill then decode against the one-pass forward at 5e-4, as
  ``tests/test_serving.py::test_prefill_decode_matches_full_forward``;
- the hybrid caches: shapes, dtypes and logical axes as the reference's,
  the reference's filled caches carried across by ``caches_from_numpy``;
- the serving engine's greedy streams equal to the JAX engine's exactly,
  dense and paged (which falls back to dense, as the reference's), under
  ``float`` and ``int8_serve`` (whose KV cache never applies to the family);
- ``int8_serve`` on the parameters (``shared_attn`` takes the plan's
  ``shared`` slot) bitwise, and the plan's ``shared_quant`` hook.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import numpy_tree, one_torch_thread  # noqa: E402, F401
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ServeConfig as JServeConfig  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.convert import caches_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core import precision  # noqa: E402
from repro_torch.models import blocks, lm  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "zamba2-1.2b"


def _configs(policy="float"):
    jcfg, tcfg = jax_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    return (dataclasses.replace(jcfg, precision=policy),
            dataclasses.replace(tcfg, precision=policy))


def _params(jcfg, seed):
    """numpy parameters, transformed by the JAX package's precision plan
    (which acts on jax arrays: numpy leaves pass through it unchanged)."""
    raw = jax.tree.map(jnp.asarray, numpy_tree(jlm.param_spec(jcfg), seed))
    plan = jprec.resolve_model_plan(jcfg)
    return jax.tree.map(np.asarray, jprec.apply_plan_to_params(raw, plan))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _close(ours, ref, atol):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=atol, rtol=0),
                 _np(ours), _np(ref))


def _close_lm(ours, ref):
    """Within 1e-5 max(1, max |ref|) leaf by leaf, the vocab padding's -1e9
    left out of the scale: the LM-level tolerance (module docstring)."""
    def check(a, b):
        real = np.where(b <= -1e9, 0.0, b)
        np.testing.assert_allclose(a, b, atol=1e-5 * max(1.0, float(np.abs(real).max())), rtol=0)

    jax.tree.map(check, _np(ours), _np(ref))


def _shapes(spec):
    if isinstance(spec, dict):
        return {k: _shapes(v) for k, v in spec.items()}
    return tuple(spec.shape)


# ---------------------------------------------------------------------------
# the shared block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_shared_attn_spec_and_cfg_match_reference(reduced):
    jcfg, tcfg = jax_get_config(ARCH, reduced), get_config(ARCH, reduced)
    assert _shapes(blocks.shared_attn_spec(tcfg)) == _shapes(jblocks.shared_attn_spec(jcfg))
    acfg, jacfg = blocks.shared_attn_cfg(tcfg), jblocks.shared_attn_cfg(jcfg)
    assert acfg.resolved_head_dim == jacfg.resolved_head_dim == (16 if reduced else 128)
    assert acfg.attn_kind == "gqa" and acfg.ssm is None and acfg.sliding_window is None
    assert lm.n_shared_apps(tcfg) == jlm.n_shared_apps(jcfg) == (2 if reduced else 7)
    assert _shapes(lm.param_spec(tcfg)) == _shapes(jlm.param_spec(jcfg))
    assert lm.count_params(tcfg) == jlm.count_params(jcfg)


def test_shared_attn_apply_train_prefill_decode():
    jcfg, tcfg = _configs()
    pj = numpy_tree(jblocks.shared_attn_spec(jcfg), seed=1)
    pt = params_from_numpy(pj, "cpu")
    rng = np.random.default_rng(2)
    b, s, d = 2, 9, jcfg.d_model
    x = rng.normal(size=(b, s + 1, d)).astype(np.float32)
    xe = rng.normal(size=(b, s + 1, d)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)

    out, none = blocks.shared_attn_apply(pt, tcfg, torch.from_numpy(x[:, :s]),
                                         torch.from_numpy(xe[:, :s]), torch.from_numpy(pos))
    ref, _ = jblocks.shared_attn_apply(pj, jcfg, jnp.asarray(x[:, :s]), jnp.asarray(xe[:, :s]),
                                       jnp.asarray(pos))
    assert none is None and out.shape == (b, s, d)
    _close(out, ref, 1e-5)

    acfg, jacfg = blocks.shared_attn_cfg(tcfg), jblocks.shared_attn_cfg(jcfg)
    cache = kv_cache.init_attention_cache(acfg, b, s + 1, torch.float32, device="cpu")
    jcache = jkv.init_attention_cache(jacfg, b, s + 1, jnp.float32)
    out, cache = blocks.shared_attn_apply(pt, tcfg, torch.from_numpy(x[:, :s]),
                                          torch.from_numpy(xe[:, :s]), torch.from_numpy(pos),
                                          mode="prefill", cache=cache)
    ref, jcache = jblocks.shared_attn_apply(pj, jcfg, jnp.asarray(x[:, :s]),
                                            jnp.asarray(xe[:, :s]), jnp.asarray(pos),
                                            mode="prefill", cache=jcache)
    _close(out, ref, 1e-5)
    _close(cache, jcache, 1e-5)
    dpos = np.full((b,), s, np.int32)
    out, cache = blocks.shared_attn_apply(pt, tcfg, torch.from_numpy(x[:, s:]),
                                          torch.from_numpy(xe[:, s:]), torch.from_numpy(dpos),
                                          mode="decode", cache=cache)
    ref, jcache = jblocks.shared_attn_apply(pj, jcfg, jnp.asarray(x[:, s:]),
                                            jnp.asarray(xe[:, s:]), jnp.asarray(dpos),
                                            mode="decode", cache=jcache)
    _close(out, ref, 1e-5)
    _close(cache, jcache, 1e-5)


# ---------------------------------------------------------------------------
# the LM entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["float", "int8_serve"])
def test_forward_matches_reference(policy):
    jcfg, tcfg = _configs(policy)
    params = _params(jcfg, seed=3)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    logits, caches, aux = lm.forward(params_from_numpy(params, "cpu"), tcfg, {"tokens": toks},
                                     device="cpu")
    ref, _, jaux = jlm.forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    assert caches is None and aux["text_offset"] == jaux["text_offset"] == 0
    _close_lm(logits, ref)
    assert (logits[..., tcfg.vocab_size:] == -1e9).all()


def test_prefill_decode_matches_full_forward():
    """As tests/test_serving.py::test_prefill_decode_matches_full_forward:
    prefill 12 tokens, decode 4, each within 5e-4 of the one-pass forward;
    and step for step within the LM-level tolerance of the JAX package's prefill and decode,
    both shared applications' K/V caches included."""
    jcfg, tcfg = _configs()
    params = _params(jcfg, seed=5)
    tparams = params_from_numpy(params, "cpu")
    b, s, extra = 2, 12, 4
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (b, s + extra)).astype(np.int32)
    full, _, _ = lm.forward(tparams, tcfg, {"tokens": toks}, device="cpu")
    caches = lm.init_caches(tcfg, b, s + extra, torch.float32, device="cpu")
    jcaches = jlm.init_caches(jcfg, b, s + extra, dtype=jnp.float32)
    last, caches = lm.prefill(tparams, tcfg, {"tokens": toks[:, :s]}, caches, device="cpu")
    jlast, jcaches = jlm.prefill(params, jcfg, {"tokens": jnp.asarray(toks[:, :s])}, jcaches)
    torch.testing.assert_close(last, full[:, s - 1], atol=5e-4, rtol=0)
    _close_lm(last, jlast)
    _close_lm(caches, jcaches)
    assert float(caches["shared"]["k"][1, :, :, s - 1].abs().max()) > 0  # the second application
    for i in range(extra):
        pos = np.full((b,), s + i, np.int32)
        last, caches = lm.decode_step(tparams, tcfg, toks[:, s + i: s + i + 1], pos, caches,
                                      device="cpu")
        jlast, jcaches = jlm.decode_step(params, jcfg, jnp.asarray(toks[:, s + i: s + i + 1]),
                                         jnp.asarray(pos), jcaches)
        torch.testing.assert_close(last, full[:, s + i], atol=5e-4, rtol=0)
        _close_lm(last, jlast)
        _close_lm(caches, jcaches)


def test_caller_caches_left_unchanged_and_in_place_writes():
    _, cfg = _configs()
    params = lm.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(3))
    caches = lm.init_caches(cfg, 2, 9, torch.float32, device="cpu")
    _, filled = lm.prefill(params, cfg, {"tokens": toks[:, :8]}, caches, device="cpu")
    assert all(float(t.abs().max()) == 0.0 for g in caches.values() for t in g.values())
    before = {g: {k: v.clone() for k, v in leaves.items()} for g, leaves in filled.items()}
    _, new = lm.decode_step(params, cfg, toks[:, 8:], torch.full((2,), 8), filled, device="cpu")
    for g, leaves in filled.items():
        for k, v in leaves.items():
            assert torch.equal(v, before[g][k])
            assert not torch.equal(new[g][k], v)
    own = {g: {k: v.clone() for k, v in leaves.items()} for g, leaves in filled.items()}
    ptrs = {(g, k): v.data_ptr() for g, leaves in own.items() for k, v in leaves.items()}
    _, out = lm.forward(params, cfg, {"tokens": toks[:, 8:]}, mode="decode", caches=own,
                        positions=torch.full((2,), 8), device="cpu", in_place=True)[:2]
    assert out is own and all(out[g][k].data_ptr() == p for (g, k), p in ptrs.items())
    for g, leaves in new.items():
        for k, v in leaves.items():
            assert torch.equal(out[g][k], v)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("batch", [1, 3])
def test_cache_shapes_and_axes_match_reference(reduced, batch):
    jcfg, tcfg = jax_get_config(ARCH, reduced), get_config(ARCH, reduced)
    ours = kv_cache.abstract_caches(tcfg, batch, 64, torch.bfloat16)
    ref = jlm.abstract_caches(jcfg, batch, 64, jnp.bfloat16)
    assert set(ours) == set(ref) == {"layers", "shared"}
    for group in ref:
        assert set(ours[group]) == set(ref[group])
        for k, (shape, dtype) in ours[group].items():
            assert shape == ref[group][k].shape
            assert str(dtype).removeprefix("torch.") == str(ref[group][k].dtype)
    assert ours["shared"]["k"][0] == (lm.n_shared_apps(tcfg), batch, tcfg.n_kv_heads, 64,
                                      2 * tcfg.d_model // tcfg.n_heads)
    # the int8 KV cache never applies to the shared block, as the reference's
    q = kv_cache.abstract_caches(tcfg, batch, 64, torch.float32, quantized=True)
    assert q["shared"]["k"][1] == torch.float32 and set(q["shared"]) == {"k", "v"}
    assert (kv_cache.cache_logical_axes(tcfg) == jkv.cache_logical_axes(jcfg)
            == jlm.cache_logical_axes(jcfg))
    # a paged layout asks nothing of the Mamba2 state, and the shared caches
    # are dense whatever the layout, as the reference's
    paged = kv_cache.abstract_caches(tcfg, batch, 64, torch.bfloat16, layout="paged",
                                     page_size=16, num_pages=9)
    assert paged == ours


@pytest.mark.parametrize("name,quantized,layout", [
    ("granite-8b", False, "dense"), ("granite-8b", True, "paged"), ("starcoder2-7b", True, "dense"),
    ("minicpm3-4b", True, "paged"), ("minicpm3-4b", False, "dense"), ("mamba2-130m", False, "dense"),
])
def test_cache_logical_axes_match_reference(name, quantized, layout):
    assert (kv_cache.cache_logical_axes(get_config(name, True), quantized, layout)
            == jkv.cache_logical_axes(jax_get_config(name, True), quantized, layout))


def test_caches_from_numpy_round_trip():
    """The JAX package's hybrid caches after its prefill, carried across,
    decode to the same logits and caches as the reference's next step."""
    jcfg, tcfg = _configs()
    params = _params(jcfg, seed=9)
    tparams = params_from_numpy(params, "cpu")
    toks = np.random.default_rng(10).integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    _, jcaches = jlm.prefill(params, jcfg, {"tokens": jnp.asarray(toks[:, :16])},
                             jlm.init_caches(jcfg, 2, 17, dtype=jnp.float32))
    caches = caches_from_numpy(jax.tree.map(np.asarray, jcaches), "cpu")
    spec = kv_cache.abstract_caches(tcfg, 2, 17, torch.float32)
    for group, leaves in spec.items():
        for k, (shape, dtype) in leaves.items():
            assert caches[group][k].shape == shape and caches[group][k].dtype == dtype
    _close(caches, jcaches, 0)
    pos = np.full((2,), 16, np.int32)
    last, new = lm.decode_step(tparams, tcfg, toks[:, 16:], pos, caches, device="cpu")
    jlast, jnew = jlm.decode_step(params, jcfg, jnp.asarray(toks[:, 16:]), jnp.asarray(pos),
                                  jcaches)
    _close_lm(last, jlast)
    _close_lm(new, jnew)
    with pytest.raises(ValueError, match="not a cache tree"):
        caches_from_numpy({"layers": dict(caches["layers"]), "shared": {"k": np.zeros(1)}},
                          "cpu")


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


def test_int8_serve_shared_quant_bitwise():
    """int8_serve's plan on the hybrid parameters: ``shared_attn`` takes the
    ``shared`` slot's int8 quantize-dequantize, bitwise the reference's; the
    runtime hook ``shared_quant`` has the reference's fields."""
    jcfg, tcfg = _configs("int8_serve")
    raw = numpy_tree(jlm.param_spec(jcfg), seed=11)
    jplan = jprec.resolve_model_plan(jcfg)
    plan = precision.resolve_model_plan(tcfg)
    ref = jax.tree.map(np.asarray, jprec.apply_plan_to_params(jax.tree.map(jnp.asarray, raw),
                                                              jplan))
    ours = precision.apply_plan_to_params(params_from_numpy(raw, "cpu"), plan)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), _np(ours), ref)
    w = ours["shared_attn"]["attn"]["wq"]["kernel"]
    assert not torch.equal(w, torch.from_numpy(raw["shared_attn"]["attn"]["wq"]["kernel"]))
    for ours_q, ref_q in ((plan.shared_quant(), jplan.shared_quant()),
                          (plan.embed_quant(), jplan.embed_quant())):
        assert ours_q.mode == ref_q.mode
        assert (ours_q.weight_cfg is None) == (ref_q.weight_cfg is None)
        assert (ours_q.act_cfg is None) == (ref_q.act_cfg is None)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

BASE = dict(max_batch=3, max_seq_len=64, prefill_buckets=(8, 16, 32), decode_steps=3)
ENGINE_CASES = {
    "dense": {},
    "paged-falls-back": dict(kv_layout="paged", kv_page_size=8),
    "int8_serve-dense": dict(policy="int8_serve"),
    "int8_serve-paged-falls-back": dict(policy="int8_serve", kv_layout="paged", kv_page_size=8),
}
TEL_KEYS = ("prefill_compiles", "decode_compiles", "prefill_dispatches", "tokens_generated",
            "prompts_admitted", "disabled_features", "kv_bytes", "kv_layout")


def _prompts():
    """Eight prompts the exact-length prefill takes: up to a chunk (16), or
    two."""
    rng = np.random.default_rng(1)
    lengths = [3, 16, 9, 32, 5, 16, 12, 32]
    return [[int(t) for t in rng.integers(0, 128, n)] for n in lengths]


@pytest.fixture(scope="module")
def engine_model():
    jcfg = jax_get_config(ARCH, reduced=True)
    raw = numpy_tree(jlm.param_spec(jcfg), 0)
    return jcfg, jax.tree.map(jnp.asarray, raw), get_config(ARCH, reduced=True), \
        params_from_numpy(raw, "cpu")


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_streams_match_reference(engine_model, case):
    """Greedy streams, finish reasons, telemetry and warnings equal to the
    JAX engine's; paged falls back to dense silently (the same tokens as
    dense); no KV cache is int8; exact-length prefill (no buckets) makes
    one prefill program per prompt length and one decode program."""
    jcfg, jparams, tcfg, tparams = engine_model
    sc_kw = ENGINE_CASES[case]
    budgets = [4 + (3 * i) % 8 for i in range(8)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jeng = JEngine(jcfg, jparams, JServeConfig(**BASE, **sc_kw))
    jh = [jeng.submit(p, max_new_tokens=n) for p, n in zip(_prompts(), budgets)]
    jres = jeng.generate()
    ref_warn = [str(w.message) for w in caught if w.category is RuntimeWarning]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = Engine(tcfg, tparams, ServeConfig(**BASE, **sc_kw), device="cpu")
    th = [eng.submit(p, max_new_tokens=n) for p, n in zip(_prompts(), budgets)]
    res = eng.generate()
    warn = [str(w.message) for w in caught if w.category is RuntimeWarning]
    tokens = [res[h.uid].generated for h in th]
    assert tokens == [jres[h.uid].generated for h in jh]
    assert [len(t) for t in tokens] == budgets
    assert [eng.finish_reason(h) for h in th] == [jeng.finish_reason(h) for h in jh]
    tel, jtel = eng.telemetry, jeng.telemetry
    assert {k: tel[k] for k in TEL_KEYS} == {k: jtel[k] for k in TEL_KEYS}
    assert warn == ref_warn
    ex = eng.executor
    assert ex.kv_layout == "dense" and not ex.quant_cache and ex.buckets == ()
    assert set(ex.caches) == {"layers", "shared"}
    assert all(t.dtype == torch.float32 for t in ex.caches["shared"].values())
    # exact-length prefill: one program per prompt length, as the reference's
    assert tel["prefill_compiles"] == len({len(p) for p in _prompts()})
    assert tel["decode_compiles"] == 1
    ex.cache_mgr.check_invariants()
