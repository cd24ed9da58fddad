"""The port's multi-head latent attention (``attention.mla_apply``, the MLA
latent caches and minicpm3-4b) against the JAX package, on reduced
minicpm3-4b in float32 with the same parameters (numpy from a seed,
``params_from_numpy``) and inputs on both sides, the reference with its
Pallas kernels off as its own tests run it.

Covered: ``mla_apply`` in train, prefill and decode over the dense and the
paged latent caches, float and int8, with the materialized and the absorbed
decode; the latent quantizer; the latent cache specs of the four layouts
and ``caches_from_numpy`` of them; ``apply_plan_to_params`` under
int8_serve on MLA params; greedy decoding through ``lm.prefill`` /
``decode_step``; the absorbed decode against the materialized one;
``lm.loss_fn`` and its gradients.

Tolerances: attention outputs and the caches' float leaves within 1e-5
absolute (float32 sums in other orders; rtol 0); the quantizer's codes and
scales bitwise on the same latent; through ``mla_apply`` the codes equal
(the same roundings of latents that differ by float32 ulps, and no seed here
puts one at a rounding tie) and the scales within 1e-5; the int8_serve
params bitwise; greedy tokens identical; logits through the whole LM at the
dense LM tests' 2e-4; absorbed against materialized within 2e-4, the bound
of ``tests/test_models_smoke.py::test_mla_absorb_decode_equivalent``; the
loss to 1e-6 relative and each gradient leaf within 1e-5 max(1, max |g|),
the bound of ``tests/test_torch_train_grads.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

from _torch_parity import numpy_tree, one_torch_thread  # noqa: E402, F401
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import caches_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core import precision  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402
from repro_torch.train import value_and_grad  # noqa: E402

NAME = "minicpm3-4b"
ATOL = 1e-5
LM_ATOL = 2e-4
ABSORB_ATOL = 2e-4
GRAD_REL = 1e-5
LAYOUTS = ("dense", "paged")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return (tree.float() if tree.dtype == torch.bfloat16 else tree).numpy()
    return np.asarray(tree)


def _close(ours, ref, atol=ATOL):
    """Float leaves within ``atol`` (rtol 0), integer leaves (codes, page
    tables) equal."""
    ours, ref = _np(ours), _np(ref)
    if not isinstance(ref, dict):
        ours, ref = {"out": ours}, {"out": ref}
    assert set(ours) == set(ref)
    for k in ours:
        if isinstance(ours[k], dict):
            _close(ours[k], ref[k], atol)
        elif np.issubdtype(ref[k].dtype, np.integer):
            assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k
        else:
            assert ours[k].shape == ref[k].shape, k
            np.testing.assert_allclose(ours[k], ref[k], atol=atol, rtol=0, err_msg=k)


def _configs(**overrides):
    jcfg = dataclasses.replace(jax_get_config(NAME, reduced=True), **overrides)
    tcfg = dataclasses.replace(get_config(NAME, reduced=True), **overrides)
    return jcfg, tcfg


def _layout_kw(layout, page_size=4, num_pages=9):
    return dict(layout="paged", page_size=page_size, num_pages=num_pages) if layout == "paged" \
        else {}


# ------------------------------------------------------------------- specs --


def test_mla_spec_matches_reference():
    jcfg, tcfg = _configs()
    ref = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                       jparams.abstract_params(jattn.attention_spec(jcfg)))
    spec = attention.attention_spec(tcfg)
    assert set(spec) == set(ref) == {
        "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b", "wv_b", "wo"}
    for name, leaves in spec.items():
        for leaf, s in leaves.items():
            assert (tuple(s.shape), str(s.dtype).removeprefix("torch.")) == ref[name][leaf]


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_latent_cache_specs_match_reference(layout, quantized):
    """The per-layer spec and the stacked one equal
    ``repro.serve.kv_cache``'s shapes and dtypes; the zero caches equal."""
    jcfg, tcfg = _configs()
    kw = _layout_kw(layout)
    ours = kv_cache.attention_cache_spec(tcfg, 3, 16, torch.float32, quantized=quantized, **kw)
    ref = jkv.attention_cache_spec(jcfg, 3, 16, jnp.float32, quantized=quantized, **kw)
    assert {k: (shape, str(dt).removeprefix("torch.")) for k, (shape, dt) in ours.items()} == {
        k: (s.shape, str(s.dtype)) for k, s in ref.items()}
    width = jcfg.mla.kv_lora_rank + jcfg.mla.qk_rope_head_dim
    assert ours["latent"][0][-1] == width
    names = {"latent"} | ({"latent_scale"} if quantized else set()) | (
        {"page_table"} if layout == "paged" else set())
    stacked = kv_cache.abstract_caches(tcfg, 3, 16, torch.float32, quantized, **kw)
    assert set(stacked["layers"]) == names
    zeros = kv_cache.init_caches(tcfg, 3, 16, torch.float32, quantized, device="cpu", **kw)
    _close(zeros, jkv.init_caches(jcfg, 3, 16, jnp.float32, quantized, **kw), atol=0)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_caches_from_numpy_takes_the_latent_layouts(layout, quantized):
    jcfg, tcfg = _configs()
    kw = _layout_kw(layout)
    rng = np.random.default_rng(3)
    jc = jax.tree.map(np.asarray, jkv.init_caches(jcfg, 2, 16, jnp.float32, quantized, **kw))
    jc["layers"] = {k: (v if k == "page_table" else
                        rng.integers(-128, 128, v.shape).astype(v.dtype) if v.dtype == np.int8
                        else rng.normal(size=v.shape).astype(v.dtype))
                    for k, v in jc["layers"].items()}
    ours = caches_from_numpy(jc, "cpu")
    for k, (shape, dt) in kv_cache.abstract_caches(tcfg, 2, 16, torch.float32, quantized,
                                                   **kw)["layers"].items():
        assert ours["layers"][k].shape == shape and ours["layers"][k].dtype == dt
    _close(ours, jc, atol=0)


# --------------------------------------------------------------- quantizer --


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_latent_quantizer_is_bitwise_the_reference(dtype):
    """``_kv_quantize`` over a (b, s, width) latent is the reference's inline
    per-token quantizer (``src/repro/models/attention.py``, mla_apply):
    codes and scales bitwise, over magnitudes from 1e-9 (the 1e-8 floor) to
    1e3 and a row of exact halves (rounding ties, half to even on both)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 24)) * 10.0 ** rng.integers(-9, 4, (2, 9, 1))
    x[0, 0] = 0.0
    x[0, 1] = np.arange(24) - 11.5  # amax 11.5: many .5 quotients
    x = x.astype(np.float32)
    codes, scale = attention._kv_quantize(torch.from_numpy(x).to(getattr(torch, dtype)))
    latent = jnp.asarray(x).astype(getattr(jnp, dtype))
    # the reference's expression, as mla_apply writes it
    l_scale = jnp.maximum(jnp.max(jnp.abs(latent), axis=-1), 1e-8) / 127.0
    l_store = jnp.clip(jnp.round(latent / l_scale[..., None]), -128, 127).astype(jnp.int8)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    assert scale.shape == (2, 9)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(l_store))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(l_scale.astype(jnp.float32)))


# -------------------------------------------------------- mla_apply itself --


def _attention_case(**overrides):
    jcfg, tcfg = _configs(**overrides)
    pj = numpy_tree(jattn.attention_spec(jcfg), seed=21)
    return jcfg, tcfg, pj, params_from_numpy(pj, "cpu")


def test_mla_apply_train_matches_reference():
    jcfg, tcfg, pj, pt = _attention_case()
    x = np.random.default_rng(22).normal(size=(2, 13, jcfg.d_model)).astype(np.float32)
    out, cache = attention.mla_apply(pt, tcfg, torch.from_numpy(x))
    ref, _ = jattn.mla_apply(pj, jcfg, jnp.asarray(x), jnp.arange(13))
    assert cache is None
    _close(out, ref)
    # attention_apply dispatches on attn_kind
    out2, _ = attention.attention_apply(pt, tcfg, torch.from_numpy(x), mode="train")
    assert torch.equal(out, out2)


@pytest.mark.parametrize("absorb", [False, True], ids=["materialized", "absorbed"])
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_mla_apply_dense_prefill_decode_matches_reference(quantized, absorb):
    """A prefill then decode steps over the dense latent cache: the outputs
    and every cache leaf (codes equal, scales within 1e-5).  ``absorb``
    reaches both sides through ``kernel["mla_absorb"]``."""
    jcfg, tcfg, pj, pt = _attention_case()
    b, s, max_len = 2, 11, 16
    kernel = {"mla_absorb": absorb}
    x = np.random.default_rng(23).normal(size=(b, s + 3, jcfg.d_model)).astype(np.float32)
    cache = kv_cache.init_attention_cache(tcfg, b, max_len, torch.float32, quantized=quantized,
                                          device="cpu")
    jcache = jkv.init_attention_cache(jcfg, b, max_len, jnp.float32, quantized=quantized)
    pos = np.arange(s, dtype=np.int32)
    out, cache = attention.mla_apply(pt, tcfg, torch.from_numpy(x[:, :s]), torch.from_numpy(pos),
                                     mode="prefill", cache=cache, kernel=kernel)
    ref, jcache = jattn.mla_apply(pj, jcfg, jnp.asarray(x[:, :s]), jnp.asarray(pos),
                                  mode="prefill", cache=jcache, kernel=kernel)
    _close(out, ref)
    _close(cache, jcache)
    for i in range(3):
        p = np.array([s + i, s - 2 + i], np.int32)  # rows at different positions
        xi = x[:, s + i: s + i + 1]
        out, cache = attention.mla_apply(pt, tcfg, torch.from_numpy(xi), torch.from_numpy(p),
                                         mode="decode", cache=cache, kernel=kernel)
        ref, jcache = jattn.mla_apply(pj, jcfg, jnp.asarray(xi), jnp.asarray(p),
                                      mode="decode", cache=jcache, kernel=kernel)
        _close(out, ref)
        _close(cache, jcache)


@pytest.mark.parametrize("absorb", [False, True], ids=["materialized", "absorbed"])
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_mla_apply_paged_decode_matches_reference(quantized, absorb):
    """Decode steps into latent page pools through a shuffled page table,
    against the reference's paged decode; then the gathered views."""
    jcfg, tcfg, pj, pt = _attention_case()
    b, ps, per_slot, s = 2, 4, 4, 7
    rng = np.random.default_rng(24)
    kw = dict(layout="paged", page_size=ps, num_pages=b * per_slot + 1)
    cache = kv_cache.init_attention_cache(tcfg, b, ps * per_slot, torch.float32,
                                          quantized=quantized, device="cpu", **kw)
    jcache = jkv.init_attention_cache(jcfg, b, ps * per_slot, jnp.float32, quantized=quantized,
                                      **kw)
    width = jcfg.mla.kv_lora_rank + jcfg.mla.qk_rope_head_dim
    assert cache["latent"].shape == (b * per_slot + 1, ps, width)
    table = (1 + rng.permutation(b * per_slot)).reshape(b, per_slot).astype(np.int32)
    cache["page_table"][:] = torch.from_numpy(table)
    jcache = dict(jcache, page_table=jnp.asarray(table))
    kernel = {"mla_absorb": absorb}
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    for i in range(s):
        p = np.array([i, min(i + 5, ps * per_slot - 1)], np.int32)
        out, cache = attention.mla_apply(pt, tcfg, torch.from_numpy(x[:, i:i + 1]),
                                         torch.from_numpy(p), mode="decode", cache=cache,
                                         kernel=kernel)
        ref, jcache = jattn.mla_apply(pj, jcfg, jnp.asarray(x[:, i:i + 1]), jnp.asarray(p),
                                      mode="decode", cache=jcache, kernel=kernel)
        _close(out, ref)
        _close(cache, jcache)
    _close(kv_cache.paged_decode_view(cache), jkv.paged_decode_view(jcache))


def test_int8_prefill_attends_the_dequantized_latent():
    """Prefill over the int8 latent cache scores the dequantized codes: its
    output differs from the float cache's prefill (the round trip shows) by
    no more than that round trip's size."""
    _, tcfg, _, pt = _attention_case()
    x = torch.from_numpy(np.random.default_rng(25).normal(size=(2, 9, tcfg.d_model))
                         .astype(np.float32))
    qcache = kv_cache.init_attention_cache(tcfg, 2, 16, torch.float32, quantized=True,
                                           device="cpu")
    out, qcache = attention.mla_apply(pt, tcfg, x, mode="prefill", cache=qcache)
    fcache = kv_cache.init_attention_cache(tcfg, 2, 16, torch.float32, device="cpu")
    float_out, fcache = attention.mla_apply(pt, tcfg, x, mode="prefill", cache=fcache)
    lat = qcache["latent"][:, :9].float() * qcache["latent_scale"][:, :9, None]
    assert qcache["latent"].dtype == torch.int8 and float(lat.abs().max()) > 0
    torch.testing.assert_close(lat, fcache["latent"][:, :9], atol=float(
        qcache["latent_scale"].max()) / 2 + 1e-7, rtol=0)
    assert not torch.equal(out, float_out)
    torch.testing.assert_close(out, float_out, atol=5e-2, rtol=0)


def test_bf16_weights_promote_against_the_float32_latent():
    """A bfloat16 model over float32 and int8 latent caches, as the engine
    runs it: the projections of the float32 latent take the weights up to
    float32 (never the latent down), the int8 prefill attends in float32,
    and each result comes back in bfloat16; both decode forms agree with
    the float32 weights' run within bfloat16's rounding."""
    _, tcfg, pj, pt = _attention_case()
    pb = params_from_numpy(jax.tree.map(lambda a: a.astype(jnp.bfloat16), pj), "cpu")
    x = torch.from_numpy(np.random.default_rng(26).normal(size=(2, 10, tcfg.d_model))
                         .astype(np.float32))
    for quantized in (False, True):
        for absorb in (False, True):
            outs = {}
            for tag, p, xx in (("f32", pt, x), ("bf16", pb, x.bfloat16())):
                cache = kv_cache.init_attention_cache(tcfg, 2, 12, torch.float32,
                                                      quantized=quantized, device="cpu")
                out, cache = attention.mla_apply(p, tcfg, xx[:, :9], mode="prefill", cache=cache)
                assert out.dtype == xx.dtype
                pos = torch.tensor([9, 9], dtype=torch.int32)
                dec, _ = attention.mla_apply(p, tcfg, xx[:, 9:], pos, mode="decode", cache=cache,
                                             kernel={"mla_absorb": absorb})
                assert dec.dtype == xx.dtype
                outs[tag] = (out.float(), dec.float())
            for a, b in zip(outs["f32"], outs["bf16"]):
                torch.testing.assert_close(b, a, atol=0.1, rtol=0.05)


def test_extend_raises_naming_its_step():
    """The mode errors of ``mla_apply``: extend and decode need explicit
    positions, and a paged cache takes no prefill (extend itself is held to
    the reference in tests/test_torch_cache_extend.py)."""
    jcfg, tcfg, pj, pt = _attention_case()
    cache = kv_cache.init_attention_cache(tcfg, 1, 8, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="extend requires explicit"):
        attention.mla_apply(pt, tcfg, torch.zeros(1, 2, tcfg.d_model), mode="extend",
                            cache=cache)
    with pytest.raises(ValueError, match="positions"):
        attention.mla_apply(pt, tcfg, torch.zeros(1, 1, tcfg.d_model), mode="decode",
                            cache=cache)
    paged = kv_cache.init_attention_cache(tcfg, 1, 8, torch.float32, device="cpu",
                                          **_layout_kw("paged"))
    with pytest.raises(ValueError, match="decode and extend writes only"):
        attention.mla_apply(pt, tcfg, torch.zeros(1, 2, tcfg.d_model), mode="prefill",
                            cache=paged)


# ---------------------------------------------------------------- the LM --


def test_int8_serve_params_are_bitwise_the_reference():
    """``apply_plan_to_params`` under int8_serve on minicpm3-4b's params:
    every weight matrix (the latent projections included) quantized and
    dequantized bitwise as the reference's; the norm scales untouched."""
    jcfg, tcfg = _configs(precision="int8_serve")
    raw = numpy_tree(jlm.param_spec(jcfg), 31)
    ref = jax.tree.map(np.asarray, jprec.apply_plan_to_params(
        jax.tree.map(jnp.asarray, raw), jprec.resolve_model_plan(jcfg)))
    ours = precision.apply_plan_to_params(params_from_numpy(raw, "cpu"),
                                          precision.resolve_model_plan(tcfg))
    _close(ours, ref, atol=0)
    attn = ours["blocks"]["attn"]
    assert not torch.equal(attn["wk_b"]["kernel"], torch.from_numpy(
        raw["blocks"]["attn"]["wk_b"]["kernel"]))
    assert torch.equal(attn["kv_norm"]["scale"], torch.from_numpy(
        raw["blocks"]["attn"]["kv_norm"]["scale"]))


def _lm_case(policy):
    jcfg, tcfg = _configs(precision=policy)
    raw = numpy_tree(jlm.param_spec(jcfg), 41)
    params = jax.tree.map(np.asarray, jprec.apply_plan_to_params(
        jax.tree.map(jnp.asarray, raw), jprec.resolve_model_plan(jcfg)))
    quantized = jprec.resolve_model_plan(jcfg).int8_kv_cache
    return jcfg, tcfg, params, params_from_numpy(params, "cpu"), quantized


@pytest.mark.parametrize("absorb", [False, True], ids=["materialized", "absorbed"])
@pytest.mark.parametrize("policy", ["float", "int8_serve"])
def test_greedy_decode_matches_reference(policy, absorb):
    """minicpm3-4b end to end through ``lm.prefill`` / ``decode_step``, dense
    latent caches (float32, or int8 under int8_serve with its int8 weights
    and the LUT softmax in prefill): logits within 2e-4, the caches as
    above, and 6 greedy tokens identical."""
    jcfg, tcfg, params, tparams, quantized = _lm_case(policy)
    kernel = {"mla_absorb": absorb}
    b, s, steps, max_len = 2, 11, 6, 20
    prompt = np.random.default_rng(42).integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    caches = lm.init_caches(tcfg, b, max_len, torch.float32, quantized, device="cpu")
    jcaches = jlm.init_caches(jcfg, b, max_len, dtype=jnp.float32, quantized=quantized)
    last, caches = lm.prefill(tparams, tcfg, {"tokens": prompt}, caches, kernel=kernel,
                              device="cpu")
    jlast, jcaches = jlm.prefill(params, jcfg, {"tokens": jnp.asarray(prompt)}, jcaches,
                                 kernel=kernel)
    _close(last, jlast, LM_ATOL)
    _close(caches, jcaches, LM_ATOL)
    for i in range(steps):
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        jtok = jnp.argmax(jlast, -1)[:, None].astype(jnp.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        pos = np.full((b,), s + i, np.int32)
        last, caches = lm.decode_step(tparams, tcfg, tok, pos, caches, kernel=kernel,
                                      device="cpu")
        jlast, jcaches = jlm.decode_step(params, jcfg, jtok, jnp.asarray(pos), jcaches,
                                         kernel=kernel)
        _close(last, jlast, LM_ATOL)
    _close(caches, jcaches, LM_ATOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_absorbed_decode_matches_materialized(quantized):
    """The port's own two decode forms, as the reference's
    ``test_mla_absorb_decode_equivalent``: the logits within 2e-4."""
    _, tcfg, _, tparams, _ = _lm_case("float")
    b, s = 2, 10
    toks = np.random.default_rng(43).integers(0, tcfg.vocab_size, (b, s + 2)).astype(np.int32)
    outs = {}
    for absorb in (False, True):
        kernel = {"mla_absorb": absorb}
        caches = lm.init_caches(tcfg, b, s + 2, torch.float32, quantized, device="cpu")
        _, caches = lm.prefill(tparams, tcfg, {"tokens": toks[:, :s]}, caches, kernel=kernel,
                               device="cpu")
        pos = np.full((b,), s, np.int32)
        outs[absorb], _ = lm.decode_step(tparams, tcfg, toks[:, s:s + 1], pos, caches,
                                         kernel=kernel, device="cpu")
    torch.testing.assert_close(outs[True], outs[False], atol=ABSORB_ATOL, rtol=0)


def test_paged_lm_decode_matches_dense():
    """``lm.decode_step`` over paged int8 latent pools (a shuffled table, the
    dense prefill inserted page by page) gives the dense caches' logits
    within 1e-5 and the same latent rows."""
    _, tcfg, _, tparams, _ = _lm_case("int8_serve")
    b, s, ps, per_slot = 2, 8, 4, 4
    toks = np.random.default_rng(44).integers(0, tcfg.vocab_size, (b, s + 3)).astype(np.int32)
    dense = lm.init_caches(tcfg, b, ps * per_slot, torch.float32, True, device="cpu")
    last, dense = lm.prefill(tparams, tcfg, {"tokens": toks[:, :s]}, dense, device="cpu")
    paged = lm.init_caches(tcfg, b, ps * per_slot, torch.float32, True, device="cpu",
                           layout="paged", page_size=ps, num_pages=b * per_slot + 1)
    table = (1 + np.random.default_rng(45).permutation(b * per_slot)).reshape(b, per_slot)
    paged["layers"]["page_table"][:] = torch.from_numpy(table.astype(np.int32))
    kv_cache.insert_prefill_paged(paged, dense, np.arange(b), ps)
    for i in range(3):
        pos = np.full((b,), s + i, np.int32)
        tok = toks[:, s + i: s + i + 1]
        ld, dense = lm.decode_step(tparams, tcfg, tok, pos, dense, device="cpu")
        lp, paged = lm.decode_step(tparams, tcfg, tok, pos, paged, device="cpu")
        torch.testing.assert_close(lp, ld, atol=ATOL, rtol=0)
    for layer in range(tcfg.n_layers):
        view = kv_cache.paged_decode_view({k: t[layer] for k, t in paged["layers"].items()})
        for name in ("latent", "latent_scale"):
            assert torch.equal(view[name][:, :s + 3], dense["layers"][name][layer][:, :s + 3])


def test_loss_and_grads_match_reference():
    jcfg, tcfg = _configs()
    params = numpy_tree(jlm.param_spec(jcfg), seed=3)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32),
             "loss_mask": (rng.random((2, 24)) < 0.8).astype(np.float32)}
    (jl, jm), jg = jax.jit(
        jax.value_and_grad(lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(params, batch)
    (tl, tm), tg = value_and_grad(lm.loss_fn, params_from_numpy(params, "cpu"), tcfg, batch,
                                  device="cpu")
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]), rtol=1e-6)

    def check(ours, ref, path=""):
        if isinstance(ref, dict):
            assert set(ours) == set(ref), path
            for k in ref:
                check(ours[k], ref[k], f"{path}/{k}")
            return
        g, r = ours.detach().numpy(), np.asarray(ref, np.float32)
        bound = GRAD_REL * max(1.0, float(np.abs(r).max()))
        assert g.shape == r.shape and float(np.abs(g - r).max()) <= bound, path

    check(tg, jg)
    assert float(np.abs(tg["blocks"]["attn"]["wkv_a"]["kernel"].numpy()).max()) > 0
