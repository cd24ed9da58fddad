"""The port's serving engine (``repro_torch.serve.api.Engine`` over
``executor``, ``scheduler`` and ``kv_cache``) against the JAX package's
``repro.serve.Engine``, both on the CPU, on the same parameters (numpy from
a seed) and the same requests.

The requests mix prompt lengths across the prefill buckets, share a
16-token (two-page) prefix on half of them, and stop on eos or on their
``max_new_tokens``.  The greedy token streams must be identical:
- reduced granite-8b, dense; paged; paged + prefix cache + preemption +
  chunked prefill (over a pool that forces preemption);
- reduced starcoder2-7b with its window of 8 (rolling buffer, exact-length
  prefill);
- reduced mamba2-130m (SSM state, exact-length prefill, dense fallback);
- under ``int8_serve`` (int8 weights, the int8 KV cache, the LUT softmax in
  prefill): reduced granite-8b and granite-moe-3b-a800m, dense and paged,
  as ``tests/test_kv_cache.py::test_dense_paged_token_identical``'s
  ``("granite-8b", "int8_serve")`` case, and granite-8b paged + prefix cache
  + preemption + chunked prefill, where prefill-skip, preemption-resume and
  chunking replay through the cache-extending prefill program on both
  sides;
- reduced minicpm3-4b (MLA, the packed latent caches) under ``float`` and
  ``int8_serve`` (int8 latent codes with per-token scales), dense, paged and
  paged + prefix cache, where ``bit_exact`` is False on both sides (as the
  reference's for MLA) and prefix hits skip their prefill through the
  extend program.
Telemetry (program counts, dispatches, preemptions, prefill tokens saved,
prefix hits, disabled features) is equal too, and the program budget
``prefill_compiles + decode_compiles <= len(buckets) + 2`` holds.

Also: the port's CPU prefill last-position logits are bitwise its decode
path's for the same token (what makes ``bit_exact`` True on the CPU);
``caps`` equal the reference's field for field; ``cancel`` frees pages at
once; the caches are written in place and each decode dispatch makes one
device-to-host copy; the engine defaults to the card.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import numpy_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ServeConfig as JServeConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import Engine, SamplingParams, ServingEngine  # noqa: E402

BASE = dict(max_batch=3, max_seq_len=64, prefill_buckets=(8, 16, 32), decode_steps=3)
CASES = {
    "granite-dense": ("granite-8b", {}),
    "granite-paged": ("granite-8b", dict(kv_layout="paged", kv_page_size=8)),
    "granite-paged-prefix-preempt-chunk": (
        "granite-8b", dict(kv_layout="paged", kv_page_size=8, kv_pages=12, kv_prefix_cache=True,
                           kv_preemption=True, prefill_chunk=8)),
    "starcoder-rolling": ("starcoder2-7b", {}),
    "mamba2": ("mamba2-130m", {}),
}
TEL_KEYS = ("prefill_compiles", "decode_compiles", "prefill_dispatches", "tokens_generated",
            "preemptions", "prefill_tokens_saved", "prefix_tokens_shared", "prefix_hits",
            "prompts_admitted", "disabled_features", "pages_in_use", "kv_bytes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast, and leaves
    the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """{arch: (JAX config, JAX params, port config, port params)}."""
    out = {}
    for arch in ("granite-8b", "starcoder2-7b", "mamba2-130m", "granite-moe-3b-a800m",
                 "minicpm3-4b"):
        jcfg = jax_get_config(arch, reduced=True)
        raw = numpy_tree(jlm.param_spec(jcfg), 0)
        out[arch] = (jcfg, jax.tree.map(jnp.asarray, raw), get_config(arch, reduced=True),
                     params_from_numpy(raw, "cpu"))
    return out


def _prompts(arch):
    """Eight prompts: mixed lengths, a shared two-page prefix on every other
    one; mamba2's exact-length prefill takes up to a chunk (16) or a
    multiple of it."""
    rng = np.random.default_rng(1)
    pre = [int(t) for t in rng.integers(0, 128, 16)]
    prompts = []
    for i in range(8):
        p = [int(t) for t in rng.integers(0, 128, int(rng.integers(3, 30)))]
        prompts.append(pre + p[:12] if i % 2 else p)
    if arch == "mamba2-130m":
        prompts = [p[:16] if len(p) < 32 else p[:32] for p in prompts]
    return prompts


def _reference(models, arch, sc_kw, sampling, **ref_kw):
    jcfg, jparams, _, _ = models[arch]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = JEngine(jcfg, jparams, JServeConfig(**BASE, **sc_kw, **ref_kw))
    handles = [eng.submit(p, JSamplingParams(**s)) for p, s in zip(_prompts(arch), sampling)]
    res = eng.generate()
    return ([res[h.uid].generated for h in handles], [eng.finish_reason(h) for h in handles],
            eng.telemetry, [str(w.message) for w in caught if w.category is RuntimeWarning])


def _ours(models, arch, sc_kw, sampling):
    _, _, tcfg, tparams = models[arch]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = Engine(tcfg, tparams, ServeConfig(**BASE, **sc_kw), device="cpu")
    handles = [eng.submit(p, SamplingParams(**s)) for p, s in zip(_prompts(arch), sampling)]
    res = eng.generate()
    eng.executor.cache_mgr.check_invariants()
    return ([res[h.uid].generated for h in handles], [eng.finish_reason(h) for h in handles],
            eng.telemetry, [str(w.message) for w in caught if w.category is RuntimeWarning], eng)


@pytest.fixture(scope="module")
def sampling(models):
    """Per-arch request knobs: budgets 4-11, and on three requests an eos
    id taken from a probe run's stream (its 3rd token), so eos fires."""
    out = {}
    for arch in models:
        budgets = [4 + (3 * i) % 8 for i in range(8)]
        probe, _, _, _ = _reference(models, arch, {}, [dict(max_new_tokens=b) for b in budgets])
        out[arch] = [dict(max_new_tokens=b, eos_id=probe[i][2] if i in (1, 4, 6) else None)
                     for i, b in enumerate(budgets)]
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_streams_match_reference(models, sampling, case):
    arch, sc_kw = CASES[case]
    ref_tokens, ref_reasons, ref_tel, ref_warn = _reference(models, arch, sc_kw, sampling[arch])
    tokens, reasons, tel, warn, eng = _ours(models, arch, sc_kw, sampling[arch])
    assert tokens == ref_tokens
    assert reasons == ref_reasons and "eos" in reasons and "length" in reasons
    assert {k: tel[k] for k in TEL_KEYS} == {k: ref_tel[k] for k in TEL_KEYS}
    assert warn == ref_warn
    buckets = eng.executor.buckets
    if buckets:
        assert tel["prefill_compiles"] + tel["decode_compiles"] <= len(buckets) + 2
    assert tel["decode_compiles"] == 1
    if "preempt" in case:
        assert tel["preemptions"] > 0 and tel["prefill_tokens_saved"] > 0


INT8_CASES = {
    "granite-dense": ("granite-8b", {}),
    "granite-paged": ("granite-8b", dict(kv_layout="paged", kv_page_size=8)),
    "granite-moe-dense": ("granite-moe-3b-a800m", {}),
    "granite-moe-paged": ("granite-moe-3b-a800m", dict(kv_layout="paged", kv_page_size=8)),
    # a prefix-cache hit reads its first tenant's KV, which the MoE's drops
    # make depend on the tokens batched with it: the same on both sides
    "granite-moe-paged-prefix": ("granite-moe-3b-a800m", dict(kv_layout="paged", kv_page_size=8,
                                                              kv_prefix_cache=True)),
    "granite-paged-prefix-preempt-chunk": CASES["granite-paged-prefix-preempt-chunk"],
}


@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_serve_streams_match_reference(models, sampling, case):
    """``ServeConfig(policy="int8_serve")``: the greedy streams, finish
    reasons, telemetry and warnings equal the JAX engine's, both with the
    cache-extending prefill program; the caches are int8, ``bit_exact`` is
    False as the reference's, and the program budget holds."""
    arch, sc_kw = INT8_CASES[case]
    sc_kw = dict(sc_kw, policy="int8_serve")
    ref_tokens, ref_reasons, ref_tel, ref_warn = _reference(models, arch, sc_kw, sampling[arch])
    tokens, reasons, tel, warn, eng = _ours(models, arch, sc_kw, sampling[arch])
    assert tokens == ref_tokens
    assert reasons == ref_reasons and "length" in reasons
    assert {k: tel[k] for k in TEL_KEYS} == {k: ref_tel[k] for k in TEL_KEYS}
    assert warn == ref_warn
    ex = eng.executor
    assert ex.quant_cache and not ex.bit_exact and ex.kernel["softmax_mode"] == "lut"
    assert ex.caches["layers"]["k"].dtype == torch.int8
    assert tel["prefill_compiles"] + tel["decode_compiles"] <= len(ex.buckets) + 2
    assert tel["decode_compiles"] == 1 and tel["extend_compiles"] <= 1
    if "preempt" in case:  # skip, resume replay and chunking, through the extend program
        assert tel["prefill_tokens_saved"] > 0 and tel["extend_dispatches"] > 0 and not warn


MLA_LAYOUTS = {
    "dense": {},
    "paged": dict(kv_layout="paged", kv_page_size=8),
    "paged-prefix": dict(kv_layout="paged", kv_page_size=8, kv_prefix_cache=True),
}


@pytest.mark.parametrize("layout", list(MLA_LAYOUTS))
@pytest.mark.parametrize("policy", ["float", "int8_serve"])
def test_mla_streams_match_reference(models, sampling, policy, layout):
    """minicpm3-4b through the engine, configured as
    ``test_int8_serve_streams_match_reference``: the greedy streams, finish
    reasons, telemetry and warnings equal the JAX engine's (both with the
    cache-extending program); the caches are the packed latent (int8 codes
    and per-token scales under int8_serve), ``bit_exact`` is False as the
    reference's for MLA, and the program budget holds."""
    sc_kw = dict(MLA_LAYOUTS[layout], policy=policy)
    arch = "minicpm3-4b"
    ref_tokens, ref_reasons, ref_tel, ref_warn = _reference(models, arch, sc_kw, sampling[arch])
    tokens, reasons, tel, warn, eng = _ours(models, arch, sc_kw, sampling[arch])
    assert tokens == ref_tokens
    assert reasons == ref_reasons and "length" in reasons
    assert {k: tel[k] for k in TEL_KEYS} == {k: ref_tel[k] for k in TEL_KEYS}
    assert warn == ref_warn
    ex = eng.executor
    assert not ex.bit_exact and ex.quant_cache == (policy == "int8_serve")
    want = {"latent"} | ({"latent_scale"} if ex.quant_cache else set()) | (
        {"page_table"} if "paged" in layout else set())
    assert set(ex.caches["layers"]) == want
    assert ex.caches["layers"]["latent"].dtype == (torch.int8 if ex.quant_cache
                                                   else torch.float32)
    assert tel["prefill_compiles"] + tel["decode_compiles"] <= len(ex.buckets) + 2
    assert tel["decode_compiles"] == 1
    if "prefix" in layout:  # hits skip their prefill: the tail replays through extend
        assert tel["prefix_hits"] > 0 and tel["prefill_tokens_saved"] > 0


def test_int8_serve_caps_match_reference(models):
    """``bit_exact`` and ``cache_extend`` as the reference's, field for
    field: bit_exact False under int8 KV and the LUT softmax, cache_extend
    True on the CPU (the reference's jnp path) and False when switched off.
    minicpm3-4b (MLA) under its own policy too."""
    for arch in ("granite-8b", "granite-moe-3b-a800m", "minicpm3-4b"):
        jcfg, jparams, cfg, params = models[arch]
        for kw in ({}, dict(kv_layout="paged", kv_page_size=8, kv_prefix_cache=True)):
            for extend in (True, False):
                sc = dict(BASE, policy="int8_serve", cache_extend=extend, **kw)
                with warnings.catch_warnings():  # prefill-skip off without extend
                    warnings.simplefilter("ignore", RuntimeWarning)
                    ours = Engine(cfg, params, ServeConfig(**sc), device="cpu").executor.caps
                    ref = JEngine(jcfg, jparams, JServeConfig(**sc)).executor.caps
                assert not ours.bit_exact and ours.cache_extend == extend
                assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_cpu_prefill_logits_are_bitwise_the_decode_paths(models):
    """Prefill of n tokens (right-padded in a bucket) against prefill of
    n - 1 then one decode step, over a dense and a paged cache: the last
    position's logits are bitwise equal, which is what the executor's
    ``bit_exact`` (True on the CPU) asserts for teacher-forced replay."""
    _, _, cfg, params = models["granite-8b"]
    rng = np.random.default_rng(2)
    b, bucket, n, max_len = 3, 32, 13, 64
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, bucket)).astype(np.int64))
    logits, _, _ = lm.forward(params, cfg, {"tokens": toks}, mode="prefill",
                              caches=lm.init_caches(cfg, b, max_len, torch.float32, device="cpu"),
                              device="cpu")
    head = toks.clone()
    head[:, n - 1:] = 0
    _, filled, _ = lm.forward(params, cfg, {"tokens": head}, mode="prefill",
                              caches=lm.init_caches(cfg, b, max_len, torch.float32, device="cpu"),
                              device="cpu")
    for t in filled["layers"].values():
        t[:, :, :, n - 1:] = 0
    pos = torch.full((b,), n - 1, dtype=torch.int32)
    dense, _ = lm.decode_step(params, cfg, toks[:, n - 1:n], pos, filled, device="cpu")
    assert torch.equal(dense, logits[:, n - 1])
    ps, per_slot = 8, max_len // 8
    paged = lm.init_caches(cfg, b, max_len, torch.float32, device="cpu", layout="paged",
                           page_size=ps, num_pages=b * per_slot + 1)
    table = torch.arange(1, b * per_slot + 1, dtype=torch.int32).reshape(b, per_slot)
    paged["layers"]["page_table"][:] = table
    for name in ("k", "v"):  # the dense prefix, page by page
        pages = filled["layers"][name].reshape(cfg.n_layers, b, cfg.n_kv_heads, per_slot, ps, -1)
        paged["layers"][name][:, table.long()] = pages.movedim(3, 2)
    out, _ = lm.decode_step(params, cfg, toks[:, n - 1:n], pos, paged, device="cpu")
    assert torch.equal(out, logits[:, n - 1])


def test_caps_match_reference(models):
    """Float granite-8b on the CPU: ``caps`` equal the reference's field for
    field, ``bit_exact`` and ``cache_extend`` True."""
    _, _, cfg, params = models["granite-8b"]
    jcfg, jparams = models["granite-8b"][:2]
    for kw in ({}, dict(kv_layout="paged", kv_page_size=8, kv_prefix_cache=True)):
        ours = Engine(cfg, params, ServeConfig(**BASE, **kw), device="cpu").executor.caps
        ref = JEngine(jcfg, jparams, JServeConfig(**BASE, **kw)).executor.caps
        assert ours.bit_exact and ours.cache_extend
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_unhonorable_knobs_warn_as_the_reference(models):
    """The same configuration asks for the same things the engine cannot
    honor: the same RuntimeWarnings and ``disabled_features``; the same
    configuration errors."""
    _, _, cfg, params = models["granite-8b"]
    jcfg, jparams = models["granite-8b"][:2]
    kw = dict(kv_prefix_cache=True, kv_preemption=True)  # dense layout: both inert
    with pytest.warns(RuntimeWarning) as ours:
        eng = Engine(cfg, params, ServeConfig(**BASE, **kw), device="cpu")
    with pytest.warns(RuntimeWarning) as ref:
        jeng = JEngine(jcfg, jparams, JServeConfig(**BASE, **kw))
    assert [str(w.message) for w in ours] == [str(w.message) for w in ref]
    assert eng.telemetry["disabled_features"] == jeng.telemetry["disabled_features"]
    _, _, mcfg, mparams = models["mamba2-130m"]
    with pytest.raises(ValueError, match="bucketable"):
        Engine(mcfg, mparams, ServeConfig(**BASE, prefill_chunk=8), device="cpu")
    with pytest.raises(ValueError, match="edf"):
        Engine(cfg, params, ServeConfig(**BASE, scheduler="priority"), device="cpu")


def test_cancel_mid_generation_frees_pages(models):
    _, _, cfg, params = models["granite-8b"]
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_seq_len=64, decode_steps=2,
                                          kv_layout="paged", kv_page_size=8), device="cpu")
    mgr = eng.executor.cache_mgr
    h_long = eng.submit([1, 2, 3, 4, 5, 6, 7, 8, 9], max_new_tokens=40)
    h_short = eng.submit([11, 2, 6], max_new_tokens=5)
    stream = eng.stream(h_long)
    got = [next(stream), next(stream)]  # mid-generation
    pages_before = mgr.pages_in_use
    assert pages_before > 0
    assert eng.cancel(h_long)
    mgr.check_invariants()
    assert mgr.pages_in_use < pages_before
    assert eng.finish_reason(h_long) == "cancelled" and eng.result(h_long).cancelled
    rest = list(stream)
    assert len(got) + len(rest) <= len(eng.result(h_long).generated)
    assert len(eng.generate()[h_short.uid].generated) == 5
    assert mgr.pages_in_use == 0
    assert not eng.cancel(h_long)


def test_stream_matches_generate_and_the_shim(models):
    _, _, cfg, params = models["granite-8b"]
    sc = ServeConfig(**BASE)
    prompts = _prompts("granite-8b")[:4]
    eng = Engine(cfg, params, sc, device="cpu")
    handles = [eng.submit(p, max_new_tokens=6) for p in prompts]
    streamed = [[ev.token for ev in eng.stream(h)] for h in handles]
    eng2 = Engine(cfg, params, sc, device="cpu")
    res = eng2.generate(prompts, max_new_tokens=6)
    assert streamed == [res[u].generated for u in sorted(res)]
    eng3 = Engine(cfg, params, sc, device="cpu")
    events = list(eng3.stream(eng3.submit(prompts[0], max_new_tokens=6)))
    assert [ev.index for ev in events] == list(range(6))
    assert events[-1].finished and events[-1].finish_reason == "length"
    assert all(a.ts <= b.ts for a, b in zip(events, events[1:]))
    with pytest.warns(DeprecationWarning):
        shim = ServingEngine(cfg, params, sc, device="cpu")
    uids = [shim.submit(p, 6) for p in prompts]
    out = shim.run()
    assert [out[u].generated for u in uids] == streamed


def test_caches_are_written_in_place_with_one_copy_back_per_decode(models, monkeypatch):
    _, _, cfg, params = models["granite-8b"]
    eng = Engine(cfg, params, ServeConfig(**BASE, kv_layout="paged", kv_page_size=8),
                 device="cpu")
    ptrs = {k: t.data_ptr() for k, t in eng.executor.caches["layers"].items()}
    eng.submit(_prompts("granite-8b")[0], max_new_tokens=12)
    eng.step()  # the prefill and a first decode dispatch
    calls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: calls.append(1) or
                        real(self, *a, **k))
    eng.step()  # decode only: decode_steps tokens, one copy back
    assert len(calls) == 1
    assert {k: t.data_ptr() for k, t in eng.executor.caches["layers"].items()} == ptrs


def test_hybrid_family_is_served_under_int8_serve():
    """int8_serve, its MLA latent caches and the hybrid family's caches are
    ported: a zamba2-1.2b-reduced engine under int8_serve takes int8 weights
    and keeps its caches float (the Mamba2 state and the shared block's
    K/V), as the reference's executor; paged falls back to dense
    (tests/test_torch_hybrid.py holds its streams to the JAX engine's)."""
    cfg = get_config("zamba2-1.2b", reduced=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(cfg, params, ServeConfig(**BASE, policy="int8_serve", kv_layout="paged"),
                 device="cpu")
    ex = eng.executor
    assert ex.plan.int8_weights and ex.plan.int8_kv_cache and not ex.quant_cache
    assert ex.kv_layout == "dense" and not ex.bucketable
    assert set(ex.caches) == {"layers", "shared"}
    assert all(t.dtype == torch.float32 for g in ex.caches.values() for t in g.values())
    out = eng.generate([[1, 2, 3], [4, 5, 6, 7]], max_new_tokens=3)
    assert all(len(r.generated) == 3 for r in out.values())


def test_the_engine_defaults_to_the_card(models, monkeypatch):
    _, _, cfg, params = models["granite-8b"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, ServeConfig(**BASE))
