"""The port's int8 KV cache (the ``int8_serve`` datapath's cache: int8 k/v
codes with float32 per-(token, kv head) scales) against the JAX package:
``attention._kv_quantize``; ``gqa_apply`` prefill and decode over the dense,
rolling and paged quantized caches; the cache specs of the three layouts;
the device ops over the scale pools (``paged_decode_write`` / ``_view``,
``mask_cache_tail``, ``insert_prefill_dense`` / ``_paged``); copy-on-write
of every pool leaf; ``caches_from_numpy`` of the quantized layouts; and
greedy decoding through ``lm.prefill`` / ``decode_step`` on int8 caches.

Same parameters (numpy from a seed, ``params_from_numpy``) and inputs on
both sides.  Tolerances: ``_kv_quantize`` codes and scales bitwise; the
attention outputs and the caches' float leaves at the dense LM tests' 2e-4
(float32 sums in other orders), the codes equal (they are the same roundings
of k/v values that differ by float32 ulps, and no seed here puts one at a
rounding tie); greedy tokens identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import numpy_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ServeConfig as JServeConfig  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.convert import caches_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402

ATOL = 2e-4
ROLLING_WINDOW = 64


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return (tree.float() if tree.dtype == torch.bfloat16 else tree).numpy()
    return np.asarray(tree)


def _close(ours, ref, atol=ATOL):
    """Float leaves within ``atol``, integer leaves (codes, slot positions,
    page tables) equal."""
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
            np.testing.assert_allclose(ours[k], ref[k], atol=atol, rtol=0, err_msg=k)


def _configs(name, **overrides):
    jcfg = dataclasses.replace(jax_get_config(name, reduced=True), **overrides)
    tcfg = dataclasses.replace(get_config(name, reduced=True), **overrides)
    return jcfg, tcfg


# ---------------------------------------------------------------- quantizer --


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_is_bitwise_the_reference(dtype):
    """Codes and scales bitwise, over magnitudes from 1e-9 (the 1e-8 floor)
    to 1e3 and rows of exact halves (rounding ties: half to even on both)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 17, 16)) * 10.0 ** rng.integers(-9, 4, (2, 3, 17, 1))
    x[0, 0, 0] = 0.0
    x[0, 0, 1] = np.arange(16) - 7.5  # amax 7.5: scale 7.5/127, many .5 quotients
    x = x.astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    codes, scale = attention._kv_quantize(tx)
    jcodes, jscale = jattn._kv_quantize(jx)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


# --------------------------------------------------------------- cache specs --


@pytest.mark.parametrize("layout", ["dense", "rolling", "paged"])
def test_quantized_cache_specs_match_reference(layout):
    name = "starcoder2-7b" if layout == "rolling" else "granite-8b"
    jcfg, tcfg = _configs(name)
    kw = dict(layout="paged", page_size=8, num_pages=9) if layout == "paged" else {}
    ours = kv_cache.abstract_caches(tcfg, 4, 64, torch.float32, quantized=True, **kw)
    ref = jkv.abstract_caches(jcfg, 4, 64, jnp.float32, quantized=True, **kw)
    names = {"k", "v", "k_scale", "v_scale"} | {"rolling": {"slot_pos"},
                                                  "paged": {"page_table"}}.get(layout, set())
    assert set(ours["layers"]) == set(ref["layers"]) == names
    for k, (shape, dt) in ours["layers"].items():
        assert shape == ref["layers"][k].shape
        assert str(dt).removeprefix("torch.") == str(ref["layers"][k].dtype)
    zeros = kv_cache.init_caches(tcfg, 4, 64, torch.float32, quantized=True, device="cpu", **kw)
    _close(zeros, jkv.init_caches(jcfg, 4, 64, jnp.float32, quantized=True, **kw), atol=0)


# ------------------------------------------------------ attention over a cache --


def _attention_case(name, **overrides):
    jcfg, tcfg = _configs(name, **overrides)
    pj = numpy_tree(jattn.gqa_spec(jcfg), seed=21)
    return jcfg, tcfg, pj, params_from_numpy(pj, "cpu")


@pytest.mark.parametrize("layout", ["dense", "rolling"])
@pytest.mark.parametrize("softmax_mode", ["safe", "lut"])
def test_gqa_apply_over_quantized_cache_matches_reference(layout, softmax_mode):
    """A prefill then decode steps over the int8 cache: the outputs and every
    cache leaf.  Rolling: starcoder2-7b reduced with a window of 64, a prompt
    of 80 tokens over a cache of 128 positions, so the buffer wraps."""
    if layout == "rolling":
        jcfg, tcfg, pj, pt = _attention_case("starcoder2-7b", sliding_window=ROLLING_WINDOW)
        b, s, max_len = 2, 80, 128
    else:
        jcfg, tcfg, pj, pt = _attention_case("granite-8b")
        b, s, max_len = 2, 12, 16
    kernel = {"softmax_mode": softmax_mode}
    x = np.random.default_rng(22).normal(size=(b, s + 3, jcfg.d_model)).astype(np.float32)
    cache = kv_cache.init_attention_cache(tcfg, b, max_len, torch.float32, quantized=True,
                                          device="cpu")
    jcache = jkv.init_attention_cache(jcfg, b, max_len, jnp.float32, quantized=True)
    assert ("slot_pos" in cache) == (layout == "rolling")
    pos = np.arange(s, dtype=np.int32)
    out, cache = attention.gqa_apply(pt, tcfg, torch.from_numpy(x[:, :s]), torch.from_numpy(pos),
                                     mode="prefill", cache=cache, kernel=kernel)
    ref, jcache = jattn.gqa_apply(pj, jcfg, jnp.asarray(x[:, :s]), jnp.asarray(pos),
                                  mode="prefill", cache=jcache, kernel=kernel)
    _close(out, ref)
    _close(cache, jcache)
    for i in range(3):
        p = np.full((b,), s + i, np.int32)
        xi = x[:, s + i: s + i + 1]
        out, cache = attention.gqa_apply(pt, tcfg, torch.from_numpy(xi), torch.from_numpy(p),
                                         mode="decode", cache=cache, kernel=kernel)
        ref, jcache = jattn.gqa_apply(pj, jcfg, jnp.asarray(xi), jnp.asarray(p),
                                      mode="decode", cache=jcache, kernel=kernel)
        _close(out, ref)
        _close(cache, jcache)


def test_prefill_attends_the_dequantized_cache():
    """Prefill over the int8 cache scores the dequantized codes, not the
    float k/v: its output differs from the float cache's prefill (the int8
    round trip shows) by no more than that round trip's size."""
    _, tcfg, _, pt = _attention_case("granite-8b")
    x = torch.from_numpy(np.random.default_rng(23).normal(size=(2, 9, tcfg.d_model))
                         .astype(np.float32))
    cache = kv_cache.init_attention_cache(tcfg, 2, 16, torch.float32, quantized=True,
                                          device="cpu")
    out, cache = attention.gqa_apply(pt, tcfg, x, mode="prefill", cache=cache)
    float_out, _ = attention.gqa_apply(pt, tcfg, x, mode="prefill",
                                       cache=kv_cache.init_attention_cache(
                                           tcfg, 2, 16, torch.float32, device="cpu"))
    k = cache["k"][:, :, :9].float() * cache["k_scale"][:, :, :9, None]
    assert cache["k"].dtype == torch.int8 and float(k.abs().max()) > 0
    assert not torch.equal(out, float_out)  # the int8 round trip is visible
    torch.testing.assert_close(out, float_out, atol=5e-2, rtol=0)


def test_paged_decode_over_quantized_pools_matches_reference():
    """Decode steps into int8 page pools (scales head-major) through a
    shuffled page table, against the reference's paged decode."""
    jcfg, tcfg, pj, pt = _attention_case("granite-8b")
    b, ps, per_slot, s = 2, 4, 4, 6
    rng = np.random.default_rng(24)
    kw = dict(layout="paged", page_size=ps, num_pages=b * per_slot + 1)
    cache = kv_cache.init_attention_cache(tcfg, b, ps * per_slot, torch.float32, quantized=True,
                                          device="cpu", **kw)
    jcache = jkv.init_attention_cache(jcfg, b, ps * per_slot, jnp.float32, quantized=True, **kw)
    assert cache["k_scale"].shape == (b * per_slot + 1, tcfg.n_kv_heads, ps)
    table = (1 + rng.permutation(b * per_slot)).reshape(b, per_slot).astype(np.int32)
    cache["page_table"][:] = torch.from_numpy(table)
    jcache = dict(jcache, page_table=jnp.asarray(table))
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    for i in range(s):
        p = np.full((b,), i, np.int32)
        out, cache = attention.gqa_apply(pt, tcfg, torch.from_numpy(x[:, i:i + 1]),
                                         torch.from_numpy(p), mode="decode", cache=cache)
        ref, jcache = jattn.gqa_apply(pj, jcfg, jnp.asarray(x[:, i:i + 1]), jnp.asarray(p),
                                      mode="decode", cache=jcache)
        _close(out, ref)
        _close(cache, jcache)
    view = kv_cache.paged_decode_view(cache)
    _close(view, jkv.paged_decode_view(jcache))


# -------------------------------------------------------- device ops, scales --


def _quantized_stack(rng, tcfg, b, length):
    """Stacked dense int8 caches with random codes and scales, as numpy."""
    spec = kv_cache.abstract_caches(tcfg, b, length, torch.float32, quantized=True)["layers"]
    out = {}
    for k, (shape, dt) in spec.items():
        out[k] = (rng.integers(-128, 128, shape).astype(np.int8) if dt == torch.int8
                  else rng.uniform(0.01, 1.0, shape).astype(np.float32))
    return {"layers": out}


def test_mask_and_insert_carry_the_scales_as_the_reference():
    """``mask_cache_tail`` zeroes codes and scales past each length;
    ``insert_prefill_dense`` / ``_paged`` scatter both (a pad row dropped,
    shared prefix pages left alone)."""
    jcfg, tcfg = _configs("granite-8b")
    rng = np.random.default_rng(25)
    n, nb, ps, bucket, max_len = 3, 3, 4, 8, 16
    filled = _quantized_stack(rng, tcfg, n, bucket)
    lengths = np.array([5, 8, 0])
    ours = kv_cache.mask_cache_tail(caches_from_numpy(filled, "cpu"), torch.from_numpy(lengths))
    ref = jkv.mask_cache_tail(jax.tree.map(jnp.asarray, filled), jnp.asarray(lengths))
    _close(ours, ref, atol=0)
    slots = np.array([2, 0, nb])  # the last row is a pad row
    # dense: the scratch spans max_len
    big = _quantized_stack(rng, tcfg, nb, max_len)
    dense_filled = _quantized_stack(rng, tcfg, n, max_len)
    got = kv_cache.insert_prefill_dense(caches_from_numpy(big, "cpu"),
                                        caches_from_numpy(dense_filled, "cpu"), slots)
    want = jkv.insert_prefill_dense(jax.tree.map(jnp.asarray, big),
                                    jax.tree.map(jnp.asarray, dense_filled), jnp.asarray(slots))
    _close(got, want, atol=0)
    # paged: pools with a page table, one shared leading page on row 0
    pages = nb * (max_len // ps) + 1
    pool = {k: v for k, v in kv_cache.abstract_caches(
        tcfg, nb, max_len, torch.float32, quantized=True, layout="paged", page_size=ps,
        num_pages=pages)["layers"].items()}
    big = {"layers": {k: (rng.integers(-128, 128, shape).astype(np.int8) if dt == torch.int8
                          else rng.uniform(0.01, 1, shape).astype(np.float32))
                      for k, (shape, dt) in pool.items() if k != "page_table"}}
    table = (1 + rng.permutation(pages - 1)).reshape(nb, max_len // ps).astype(np.int32)
    big["layers"]["page_table"] = np.broadcast_to(table, (tcfg.n_layers,) + table.shape).copy()
    shared = np.array([1, 0, 0])
    got = kv_cache.insert_prefill_paged(caches_from_numpy(big, "cpu"),
                                        caches_from_numpy(filled, "cpu"), slots, ps, shared)
    want = jkv.insert_prefill_paged(jax.tree.map(jnp.asarray, big),
                                    jax.tree.map(jnp.asarray, filled), jnp.asarray(slots), ps,
                                    jnp.asarray(shared))
    _close(got, want, atol=0)


def test_copy_on_write_copies_every_pool_leaf():
    """A write into a shared page queues a copy; ``flush_copies`` copies the
    codes and the scales of every layer."""
    _, tcfg = _configs("granite-8b")
    sc = ServeConfig(max_batch=2, max_seq_len=16, kv_layout="paged", kv_page_size=4,
                     kv_prefix_cache=True)
    mgr = kv_cache.CacheManager(tcfg, sc, quantized=True, device="cpu")
    caches = mgr.init_device_caches()
    assert {k: t.dtype for k, t in caches["layers"].items()} == {
        "k": torch.int8, "v": torch.int8, "k_scale": torch.float32, "v_scale": torch.float32,
        "page_table": torch.int32}
    tokens = list(range(1, 9))
    mgr.admit(0, tokens, reserve_len=12)
    src = mgr._slot_pages[0][0]
    for name, t in caches["layers"].items():
        if name != "page_table":
            t[:, src] = torch.arange(t[:, src].numel()).reshape(t[:, src].shape).to(t.dtype)
    mgr.admit(1, tokens, reserve_len=12, match=mgr.match_prefix(tokens), lazy_tail=True,
              write_from=2)
    mgr.ensure(1, 4, write_from=2)  # slot 1 writes into the shared first page
    dst = mgr._slot_pages[1][0]
    assert dst != src
    mgr.flush_copies(caches)
    for name, t in caches["layers"].items():
        if name != "page_table":
            assert torch.equal(t[:, dst], t[:, src]), name
    mgr.check_invariants()


@pytest.mark.parametrize("layout", ["dense", "rolling", "paged"])
def test_caches_from_numpy_takes_the_quantized_layouts(layout):
    name = "starcoder2-7b" if layout == "rolling" else "granite-8b"
    jcfg, tcfg = _configs(name)
    kw = dict(layout="paged", page_size=8, num_pages=9) if layout == "paged" else {}
    jc = jax.tree.map(np.asarray, jkv.init_caches(jcfg, 2, 64, jnp.float32, quantized=True, **kw))
    ours = caches_from_numpy(jc, "cpu")
    for k, (shape, dt) in kv_cache.abstract_caches(tcfg, 2, 64, torch.float32, quantized=True,
                                                   **kw)["layers"].items():
        assert ours["layers"][k].shape == shape and ours["layers"][k].dtype == dt


# ------------------------------------------------------------ the LM, greedy --


@pytest.mark.parametrize("name", ["granite-8b", "granite-moe-3b-a800m"])
def test_greedy_decode_over_int8_caches_matches_reference(name):
    """``int8_serve`` end to end through ``lm.prefill`` / ``decode_step``:
    int8 weights (the plan's transform on both sides), int8 caches, the LUT
    softmax in prefill; the last-position logits within 2e-4 and the int8
    caches as above, and 6 greedy tokens identical."""
    jcfg, tcfg = _configs(name, precision="int8_serve")
    raw = numpy_tree(jlm.param_spec(jcfg), 31)
    params = jax.tree.map(np.asarray, jprec.apply_plan_to_params(
        jax.tree.map(jnp.asarray, raw), jprec.resolve_model_plan(jcfg)))
    tparams = params_from_numpy(params, "cpu")
    b, s, steps, max_len = 2, 11, 6, 24
    prompt = np.random.default_rng(32).integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    caches = lm.init_caches(tcfg, b, max_len, torch.float32, quantized=True, device="cpu")
    jcaches = jlm.init_caches(jcfg, b, max_len, dtype=jnp.float32, quantized=True)
    last, caches = lm.prefill(tparams, tcfg, {"tokens": prompt}, caches, device="cpu")
    jlast, jcaches = jlm.prefill(params, jcfg, {"tokens": jnp.asarray(prompt)}, jcaches)
    _close(last, jlast)
    _close(caches, jcaches)
    for i in range(steps):
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        jtok = jnp.argmax(jlast, -1)[:, None].astype(jnp.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        pos = np.full((b,), s + i, np.int32)
        last, caches = lm.decode_step(tparams, tcfg, tok, pos, caches, device="cpu")
        jlast, jcaches = jlm.decode_step(params, jcfg, jtok, jnp.asarray(pos), jcaches)
        _close(last, jlast)
    _close(caches, jcaches)


def test_executor_builds_int8_caches_as_the_reference():
    """Under ``int8_serve`` the executor's caches are int8 codes plus float32
    scales, leaf for leaf the reference's, in both layouts."""
    from repro.serve import Engine as JEngine
    from repro_torch.serve import Engine

    jcfg, tcfg = _configs("granite-8b")
    raw = numpy_tree(jlm.param_spec(jcfg), 0)
    for kw in ({}, dict(kv_layout="paged", kv_page_size=8)):
        base = dict(max_batch=2, max_seq_len=32, policy="int8_serve", **kw)
        ours = Engine(tcfg, params_from_numpy(raw, "cpu"), ServeConfig(**base), device="cpu")
        ref = JEngine(jcfg, jax.tree.map(jnp.asarray, raw), JServeConfig(**base))
        assert ours.executor.quant_cache and ref.executor.quant_cache
        _close(ours.executor.caches, ref.executor.caches, atol=0)
        assert ours.telemetry["kv_bytes"] == ref.telemetry["kv_bytes"]
