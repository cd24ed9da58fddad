"""The port's cache-extending prefill (``attention`` ``mode="extend"``, the
window writes of ``serve.kv_cache`` and the executor's extend program)
against the JAX package's, on the CPU, on the same numpy parameters.

- ``gqa_apply`` / ``mla_apply`` in ``extend`` mode over a populated dense
  or paged cache, with the ``safe`` and the LUT softmax, with and without
  the int8 KV cache: the outputs within 1e-5 and the written cache rows
  equal (int8 codes exactly), windows of per-row lengths with masked
  entries at the sentinel position.
- The reference's ``tests/test_cache_extend.py`` parity matrix on MLA,
  int8-KV and LUT + int8-KV: chunked prefill (dense and paged), prefix-skip
  on a full-coverage hit (no prefill dispatch) and preemption resume give
  exactly the JAX engine's greedy streams, and the port's own whole-prompt
  streams.  Each JAX engine runs once per case (module-scoped memo).
- One extend shape with every knob on, the unhonorable-features warnings
  and ``disabled_features`` as the reference's, and the op counter's FLOPs
  of one extend forward equal to ``hlo_parser``'s on the reference's
  compiled forward (a gap of 0, as the train forward's).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import numpy_tree, one_torch_thread  # noqa: E402, F401
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ServeConfig as JServeConfig  # noqa: E402
from repro.core import precision as JP  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.roofline import hlo_parser  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import precision as P  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.roofline import op_counter  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.serve import kv_cache as tkv  # noqa: E402


def _policies(mod):
    kv8 = mod.PrecisionPolicy("kv8", (mod.Rule("kv_cache", mod.int8(per_channel=False)),))
    lut_kv8 = mod.PrecisionPolicy("lut_kv8", (
        mod.Rule("layers.*.attn.softmax", mod.lut8()),
        mod.Rule("kv_cache", mod.int8(per_channel=False)),
    ))
    return {None: None, "kv8": kv8, "lut_kv8": lut_kv8}


OURS_POL, JAX_POL = _policies(P), _policies(JP)
#: the datapaths the reference's bit-exact gate excluded (its DATAPATHS)
DATAPATHS = {"mla": ("minicpm3-4b", None), "int8kv": ("granite-8b", "kv8"),
             "lut_int8kv": ("granite-8b", "lut_kv8")}
BASE = dict(max_batch=2, max_seq_len=64, decode_steps=3, prefill_buckets=(8, 16, 32))


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("granite-8b", "minicpm3-4b"):
        jcfg = jax_get_config(arch, reduced=True)
        raw = numpy_tree(jlm.param_spec(jcfg), 7)
        out[arch] = (jcfg, jax.tree.map(jnp.asarray, raw), get_config(arch, reduced=True),
                     params_from_numpy(raw, "cpu"))
    return out


def _prompts(vocab, lengths=(20, 11), seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab - 1, n)] for n in lengths]


def _gen(eng, prompts, n_new):
    handles = [eng.submit(list(p), max_new_tokens=n_new) for p in prompts]
    res = eng.generate()
    return [res[h.uid].generated for h in handles]


def _engines(models, datapath, **kw):
    """(JAX engine, port engine) of one datapath and ServeConfig, warnings
    recorded on both."""
    arch, pol = DATAPATHS[datapath]
    jcfg, jparams, tcfg, tparams = models[arch]
    sc = dict(BASE, **kw)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        ref = JEngine(jcfg, jparams, JServeConfig(**sc, policy=JAX_POL[pol]))
        ours = Engine(tcfg, tparams, ServeConfig(**sc, policy=OURS_POL[pol]), device="cpu")
    return ref, ours


@pytest.fixture(scope="module")
def ref_streams(models):
    """Memo of the JAX engines' greedy streams, one run per case."""
    memo = {}

    def get(datapath, prompts, n_new, **kw):
        key = (datapath, tuple(map(tuple, prompts)), n_new, tuple(sorted(kw.items())))
        if key not in memo:
            ref, _ = _engines(models, datapath, **kw)
            memo[key] = (_gen(ref, prompts, n_new), ref.telemetry)
        return memo[key]

    return get


# ------------------------------------------------------- module outputs --


def _history(rng, cache: dict) -> dict:
    """Random cache content (int8 codes, positive scales, normal floats)."""
    out = {}
    for k, t in cache.items():
        if k == "page_table":
            continue
        if t.dtype == torch.int8:
            out[k] = rng.integers(-127, 128, t.shape).astype(np.int8)
        elif "scale" in k:
            out[k] = rng.uniform(0.001, 0.02, t.shape).astype(np.float32)
        else:
            out[k] = rng.normal(size=t.shape).astype(np.float32)
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("softmax", ["safe", "lut"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("arch", ["granite-8b", "minicpm3-4b"], ids=["gqa", "mla"])
def test_extend_attention_matches_reference(models, arch, layout, softmax, quantized):
    """A window of 8 per row at per-row starts (one row's window straddles
    pages, masked tails at the ``max_seq_len`` sentinel) over a populated
    cache: the block output within 1e-5 of the reference's, the written
    rows equal (trash page aside)."""
    jcfg, _, tcfg, _ = models[arch]
    raw = numpy_tree(jatt.attention_spec(jcfg), 3)
    jp, tp = jax.tree.map(jnp.asarray, raw), params_from_numpy(raw, "cpu")
    b, length, w = 3, 32, 8
    rng = np.random.default_rng(11)
    x = (0.5 * rng.normal(size=(b, w, tcfg.d_model))).astype(np.float32)
    starts, lens = np.array([0, 5, 20]), np.array([8, 3, 6])
    pos = starts[:, None] + np.arange(w)[None]
    pos = np.where(np.arange(w)[None] < lens[:, None], pos, length).astype(np.int32)
    kw = dict(layout="paged", page_size=4, num_pages=b * 8 + 1) if layout == "paged" else {}
    jc = jkv.init_attention_cache(jcfg, b, length, jnp.float32, quantized=quantized, **kw)
    tc = tkv.init_attention_cache(tcfg, b, length, torch.float32, quantized=quantized,
                                  device="cpu", **kw)
    if layout == "paged":  # a permuted table, so pages and positions disagree
        table = rng.permutation(np.arange(1, b * 8 + 1)).astype(np.int32).reshape(b, 8)
        jc["page_table"] = jnp.asarray(table)
        tc["page_table"].copy_(torch.from_numpy(table))
    for k, v in _history(rng, tc).items():
        jc[k] = jnp.asarray(v)
        tc[k].copy_(torch.from_numpy(v))
    knob = {"softmax_mode": softmax}
    jo, jnew = jatt.attention_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), mode="extend",
                                    cache=jc, kernel=knob)
    to, tnew = attention.attention_apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                                         mode="extend", cache=tc, kernel=knob)
    assert tnew is tc  # written in place
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=1e-5)
    for k in tc:
        ours, ref = tc[k].numpy(), np.asarray(jnew[k])
        if layout == "paged" and k != "page_table":  # the trash page takes pad writes
            ours, ref = ours[1:], ref[1:]
        if ours.dtype == np.int8 or k == "page_table":
            np.testing.assert_array_equal(ours, ref, err_msg=k)
        else:
            np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6, err_msg=k)


def test_window_writes_match_reference():
    """``dense_window_write`` / ``paged_window_write`` alone: the same
    scattered rows as the reference's on every leaf shape (head-major k / v
    and scales, the latent and its scales), sentinels dropped / trashed."""
    rng = np.random.default_rng(5)
    b, w, length, ps = 3, 6, 16, 4
    pos = np.array([[0, 1, 2, 3, 4, 5], [7, 8, 9, 16, 16, 16], [15, 16, 16, 16, 16, 16]],
                   np.int32)
    shapes = {"k": (b, 2, length, 8), "k_scale": (b, 2, length), "latent": (b, length, 5),
              "latent_scale": (b, length)}
    for name, shape in shapes.items():
        head = name.startswith("k")
        upd_shape = shape[:2] + (w,) + shape[3:] if head else (b, w) + shape[2:]
        upd = rng.normal(size=upd_shape).astype(np.float32)
        dense = rng.normal(size=shape).astype(np.float32)
        ref = jkv.dense_window_write({name: jnp.asarray(dense)}, {name: jnp.asarray(upd)},
                                     jnp.asarray(pos))
        ours = tkv.dense_window_write({name: torch.from_numpy(dense.copy())},
                                      {name: torch.from_numpy(upd)}, torch.from_numpy(pos))
        np.testing.assert_array_equal(ours[name].numpy(), np.asarray(ref[name]))
        n_pages = b * length // ps + 1
        pool_shape = ((n_pages, 2, ps) + shape[3:]) if head else (n_pages, ps) + shape[2:]
        pool = rng.normal(size=pool_shape).astype(np.float32)
        table = rng.permutation(np.arange(1, n_pages)).astype(np.int32).reshape(b, length // ps)
        ref = jkv.paged_window_write({name: jnp.asarray(pool), "page_table": jnp.asarray(table)},
                                     {name: jnp.asarray(upd)}, jnp.asarray(pos))
        ours = tkv.paged_window_write({name: torch.from_numpy(pool.copy()),
                                       "page_table": torch.from_numpy(table)},
                                      {name: torch.from_numpy(upd)}, torch.from_numpy(pos))
        np.testing.assert_array_equal(ours[name].numpy()[1:], np.asarray(ref[name])[1:])


# -------------------------------------------------------- engine parity --


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("datapath", list(DATAPATHS))
def test_chunked_prefill_parity(models, ref_streams, datapath, layout):
    """Chunked admission (chunk 8): the later chunks ride the extend program
    on both sides; the port's streams equal the JAX engine's and the port's
    own whole-prompt streams, and the 20-token prompt never makes its
    whole-length bucket shape."""
    arch = DATAPATHS[datapath][0]
    prompts = _prompts(models[arch][2].vocab_size)
    kw = dict(kv_layout="paged", kv_page_size=8) if layout == "paged" else {}
    ref, _ = ref_streams(datapath, prompts, 6, prefill_chunk=8, **kw)
    _, whole = _engines(models, datapath, cache_extend=False, **kw)
    _, chunked = _engines(models, datapath, prefill_chunk=8, **kw)
    assert _gen(chunked, prompts, 6) == ref
    assert _gen(whole, prompts, 6) == ref
    tel = chunked.telemetry
    assert chunked.scheduler.chunk_len == 8 and tel["extend_dispatches"] >= 1
    assert tel["disabled_features"] == [] and tel["extend_compiles"] == 1
    assert (2, 32) not in chunked.executor._prefill_shapes


@pytest.mark.parametrize("datapath", list(DATAPATHS))
def test_prefix_skip_full_coverage_skips_prefill(models, datapath):
    """A warm full-coverage hit dispatches no prompt prefill: the shared
    pages are mapped and the unwritten tail rides the extend program; the
    warm stream equals the cold one, on both sides alike."""
    arch = DATAPATHS[datapath][0]
    prompt = _prompts(models[arch][2].vocab_size, lengths=(16,))[0]  # two full pages
    streams = []
    for eng in _engines(models, datapath, kv_layout="paged", kv_page_size=8,
                        kv_prefix_cache=True):
        cold = _gen(eng, [prompt], 6)
        before = eng.telemetry["prefill_dispatches"]
        warm = _gen(eng, [prompt], 6)
        tel = eng.telemetry
        assert warm == cold and tel["prefill_dispatches"] == before
        assert tel["prefill_tokens_saved"] > 0
        eng.executor.cache_mgr.check_invariants()
        streams.append((cold, warm, tel["prefill_tokens_saved"], tel["extend_dispatches"]))
    assert streams[0] == streams[1]


@pytest.mark.parametrize("datapath", list(DATAPATHS))
def test_preemption_resume_parity(models, ref_streams, datapath):
    """An oversubscribed pool (5 pages of 8) preempts the youngest
    resident; its resume replays the prompt through the extend program and
    the generated tail through decode.  The port's paged stream equals the
    JAX engine's and the port's dense stream."""
    prompts = ([7, 8, 9], [1, 2, 3])
    kw = dict(max_seq_len=32, kv_layout="paged", kv_page_size=8, kv_pages=5,
              kv_preemption=True)
    ref, ref_tel = ref_streams(datapath, prompts, 20, **kw)
    _, paged = _engines(models, datapath, **kw)
    _, dense = _engines(models, datapath, max_seq_len=32)
    assert _gen(paged, prompts, 20) == ref == _gen(dense, prompts, 20)
    tel = paged.telemetry
    assert tel["preemptions"] >= 1 and tel["preemptions"] == ref_tel["preemptions"]
    assert tel["disabled_features"] == []
    paged.executor.cache_mgr.check_invariants()


def test_one_extend_shape_with_everything_on(models, ref_streams):
    """MLA with chunking, prefix sharing and preemption on at once: at most
    len(buckets) prefill shapes, one decode and ONE extend shape, and the
    streams of the JAX engine."""
    _, _, tcfg, tparams = models["minicpm3-4b"]
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, tcfg.vocab_size - 1, n)]
               for n in (3, 5, 9, 12, 17, 23, 30)]
    prompts += [list(prompts[0])]  # one full-coverage repeat
    kw = dict(max_batch=4, prefill_buckets=(8, 16), prefill_chunk=8, kv_layout="paged",
              kv_page_size=8, kv_prefix_cache=True, kv_preemption=True)
    ref, _ = ref_streams("mla", prompts, 5, **kw)
    _, eng = _engines(models, "mla", **kw)
    assert _gen(eng, prompts, 5) == ref
    tel, ex = eng.telemetry, eng.executor
    assert len(ex._prefill_shapes) == tel["prefill_compiles"] <= len(ex.buckets)
    assert tel["decode_compiles"] == 1 and tel["extend_compiles"] == 1
    assert ex._extend_shapes == {(4, 8)} and tel["extend_dispatches"] >= 1
    assert tel["prefill_compiles"] + tel["decode_compiles"] + tel["extend_compiles"] <= (
        len(ex.buckets) + 2)


def test_unhonorable_features_warn_and_report(models):
    """With the extend program switched off, MLA cannot honor chunking,
    prefill-skip or preemption: the same RuntimeWarnings and
    ``disabled_features`` as the reference's, and the engine still serves;
    with it on, nothing is disabled on either side."""
    kw = dict(prefill_chunk=8, kv_layout="paged", kv_page_size=8, kv_prefix_cache=True,
              kv_preemption=True)
    arch = "minicpm3-4b"
    jcfg, jparams, tcfg, tparams = models[arch]
    with pytest.warns(RuntimeWarning) as caught_ref:
        ref = JEngine(jcfg, jparams, JServeConfig(**BASE, cache_extend=False, **kw))
    with pytest.warns(RuntimeWarning) as caught:
        eng = Engine(tcfg, tparams, ServeConfig(**BASE, cache_extend=False, **kw), device="cpu")
    assert [str(w.message) for w in caught] == [str(w.message) for w in caught_ref]
    disabled = eng.telemetry["disabled_features"]
    assert disabled == ref.telemetry["disabled_features"]
    joined = " ".join(disabled)
    assert "prefill_chunk" in joined and "kv_preemption" in joined and "prefill-skip" in joined
    assert len(_gen(eng, [list(range(1, 20))], 4)[0]) == 4
    assert eng.scheduler.chunk_len is None and eng.telemetry["extend_dispatches"] == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        on = Engine(tcfg, tparams, ServeConfig(**BASE, **kw), device="cpu")
    assert on.telemetry["disabled_features"] == [] and on.executor.cache_extend
    gcfg, gparams = models["granite-8b"][2:]
    with pytest.raises(ValueError, match="bucketable"):
        Engine(get_config("mamba2-130m", reduced=True),
               lm.init_params(get_config("mamba2-130m", reduced=True),
                              torch.Generator().manual_seed(0), device="cpu"),
               ServeConfig(max_batch=2, max_seq_len=64, prefill_chunk=8), device="cpu")


@pytest.mark.parametrize("arch", ["granite-8b", "minicpm3-4b"])
def test_counter_flops_of_an_extend_forward_match_the_hlo_parser(models, arch):
    """One extend forward (batch 2, window 8, a 32-token dense cache): the
    op counter's FLOPs on the CPU equal ``hlo_parser``'s total on the
    reference's compiled forward, attention volume included (a gap of 0)."""
    b, w, length = 2, 8, 32
    jcfg, _, tcfg, tparams = models[arch]
    caches = jax.eval_shape(lambda: jkv.init_caches(jcfg, b, length, jnp.float32))

    def fwd(p, tokens, positions, c):
        return jlm.forward(p, jcfg, {"tokens": tokens}, mode="extend", caches=c,
                           positions=positions)[0]

    compiled = jax.jit(fwd).lower(
        jlm.abstract_params(jcfg), jax.ShapeDtypeStruct((b, w), jnp.int32),
        jax.ShapeDtypeStruct((b, w), jnp.int32), caches).compile()
    ref = hlo_parser.total_cost(compiled.as_text(), default_trip_count=jcfg.n_layers)
    tokens = torch.zeros(b, w, dtype=torch.int64)
    positions = torch.arange(w, dtype=torch.int32)[None].expand(b, w) + 4
    _, count = op_counter.count(lm.forward, tparams, tcfg, {"tokens": tokens}, mode="extend",
                                caches=lm.init_caches(tcfg, b, length, torch.float32,
                                                      device="cpu"),
                                positions=positions, device="cpu")
    assert count.total_flops == ref.flops
    assert count.attn_flops == ref.attn_flops > 0
