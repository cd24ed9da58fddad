"""The port's speculative decoding, n-best fan-out and replica seed salting
against the JAX package's (the speculative and n-best parts of
``tests/test_sampling_spec.py``), on the CPU, on the same numpy parameters.

- Greedy speculative decoding through the extend program: the streams are
  bitwise the plain engine's and the JAX speculative engine's, dense and
  paged, with a self-draft (every proposal accepted, as the reference's)
  and with a perturbed copy of the target as the draft, its params
  converted for both sides (the two packages' init keys differ); a seeded
  sampled stream
  through the speculative engine equals the plain engine's.
- The gate: without the extend program speculation warns as the
  reference's and is off; a draft of another vocabulary is an error; a
  ``draft_config`` names a config of the port's registry.
- n-best: greedy siblings equal each other, the ``n=1`` stream and the JAX
  engine's, with the same fork telemetry; seeded siblings diverge and
  repeat; dense engines admit siblings as plain prefills.
- Replica salt: unseeded sampled streams differ across replicas and repeat
  per router seed; a seeded stream is the same on any replica.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import numpy_tree, one_torch_thread  # noqa: E402, F401
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ServeConfig as JServeConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import Engine, ReplicaRouter, SamplingParams  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GREEDY_PROMPT = [5, 9, 3]
SAMPLED_PROMPT = [2, 4, 6, 8, 1]
PROMPTS = (GREEDY_PROMPT, SAMPLED_PROMPT, [7, 7, 1, 2])
SAMPLED = SamplingParams(max_new_tokens=6, temperature=0.9, top_k=12, top_p=0.95, seed=7)


def _params(noise=0.0):
    """granite-8b-reduced from seed 3; with ``noise``, every leaf moved by
    that much of a second seed's draw (a draft that mostly agrees)."""
    jcfg = jax_get_config("granite-8b", reduced=True)
    raw = numpy_tree(jlm.param_spec(jcfg), 3)
    if noise:
        other = numpy_tree(jlm.param_spec(jcfg), 4)
        raw = jax.tree.map(lambda a, b: (a + noise * b).astype(a.dtype), raw, other)
    return (jcfg, jax.tree.map(jnp.asarray, raw), get_config("granite-8b", reduced=True),
            params_from_numpy(raw, "cpu"))


@pytest.fixture(scope="module")
def model():
    return _params()


@pytest.fixture(scope="module")
def draft_model():
    """The target perturbed: a draft that disagrees with it now and then."""
    return _params(0.3)


def _serve(**kw):
    base = dict(max_batch=2, max_seq_len=64, prefill_buckets=(8, 16), decode_steps=3,
                temperature=0.0)
    base.update(kw)
    return base


def _run(eng, prompts=PROMPTS, sp=None, max_new=6):
    handles = [eng.submit(list(p), sp or type_sp(eng)(max_new_tokens=max_new)) for p in prompts]
    fin = eng.generate()
    return [fin[h.uid].generated for h in handles], [fin[h.uid] for h in handles]


def type_sp(eng):
    return SamplingParams if isinstance(eng, Engine) else JSamplingParams


# ------------------------------------------------- speculative decoding --


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_greedy_bitwise_identical(model, layout):
    """Self-draft: every proposal accepted; the streams are the plain
    engine's and the JAX speculative engine's."""
    jcfg, jparams, cfg, params = model
    kw = dict(kv_layout=layout, kv_page_size=8)
    want, _ = _run(Engine(cfg, params, ServeConfig(**_serve(**kw)), device="cpu"))
    spec = Engine(cfg, params, ServeConfig(**_serve(speculative=True, spec_tokens=4, **kw)),
                  device="cpu")
    got, reqs = _run(spec)
    ref_eng = JEngine(jcfg, jparams, JServeConfig(**_serve(speculative=True, spec_tokens=4,
                                                           **kw)))
    ref, _ = _run(ref_eng)
    assert got == want == ref
    tel, rtel = spec.telemetry, ref_eng.telemetry
    assert tel["spec_dispatches"] > 0 and tel["draft_tokens_proposed"] > 0
    assert tel["draft_tokens_accepted"] == tel["draft_tokens_proposed"]
    for k in ("spec_dispatches", "draft_tokens_proposed", "draft_tokens_accepted",
              "extend_dispatches", "tokens_generated"):
        assert tel[k] == rtel[k], k
    assert sum(r.draft_proposed for r in reqs) == tel["draft_tokens_proposed"]
    assert sum(r.draft_accepted for r in reqs) == tel["draft_tokens_accepted"]
    assert tel["extend_compiles"] == 1


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_with_another_draft_matches_reference(model, draft_model, layout):
    """A perturbed draft, converted for both sides: some proposals
    rejected, the correction token shipped, and the streams, the acceptance
    counts and the draft's prefill shapes are the JAX engine's."""
    jcfg, jparams, cfg, params = model
    djcfg, djparams, dcfg, dparams = draft_model
    kw = dict(kv_layout=layout, kv_page_size=8, speculative=True, spec_tokens=3)
    want, _ = _run(Engine(cfg, params, ServeConfig(**_serve(kv_layout=layout, kv_page_size=8)),
                          device="cpu"))
    spec = Engine(cfg, params, ServeConfig(**_serve(**kw)), draft=(dcfg, dparams), device="cpu")
    got, _ = _run(spec)
    ref_eng = JEngine(jcfg, jparams, JServeConfig(**_serve(**kw)), draft=(djcfg, djparams))
    ref, _ = _run(ref_eng)
    assert got == want == ref
    tel, rtel = spec.telemetry, ref_eng.telemetry
    assert 0 < tel["draft_tokens_accepted"] < tel["draft_tokens_proposed"]
    for k in ("spec_dispatches", "draft_tokens_proposed", "draft_tokens_accepted",
              "draft_prefill_compiles"):
        assert tel[k] == rtel[k], k


def test_spec_sampled_stream_matches_plain_engine(model):
    """The correction token is the target's own position-keyed sample, so a
    seeded request's stream through the speculative engine is the plain
    engine's."""
    _, _, cfg, params = model
    plain = Engine(cfg, params, ServeConfig(**_serve()), device="cpu")
    spec = Engine(cfg, params, ServeConfig(**_serve(speculative=True, spec_tokens=4)),
                  device="cpu")
    want, _ = _run(plain, [SAMPLED_PROMPT], SAMPLED)
    got, _ = _run(spec, [SAMPLED_PROMPT], SAMPLED)
    assert got == want and spec.telemetry["spec_dispatches"] > 0


def test_spec_requires_cache_extend(model):
    jcfg, jparams, cfg, params = model
    caught = []
    for build in (lambda: Engine(cfg, params, ServeConfig(**_serve(speculative=True,
                                                                   cache_extend=False)),
                                 device="cpu"),
                  lambda: JEngine(jcfg, jparams, JServeConfig(**_serve(speculative=True,
                                                                       cache_extend=False)))):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            eng = build()
        caught.append([str(x.message) for x in w if x.category is RuntimeWarning])
        assert eng.executor.draft is None
    assert caught[0] == caught[1] and "speculative" in caught[0][0]
    eng = Engine(cfg, params, ServeConfig(**_serve(speculative=True, cache_extend=False)),
                 device="cpu")
    assert len(_run(eng, [GREEDY_PROMPT], max_new=4)[0][0]) == 4


def test_spec_draft_vocab_mismatch_and_registry_draft(model):
    _, _, cfg, params = model
    bad = dataclasses.replace(cfg, name="bad-vocab", vocab_size=cfg.vocab_size + 1)
    with pytest.raises(ValueError, match="vocab"):
        Engine(cfg, params, ServeConfig(**_serve(speculative=True)), draft=(bad, params),
               device="cpu")
    eng = Engine(cfg, params, ServeConfig(**_serve(speculative=True,
                                                   draft_config="granite-8b")), device="cpu")
    d = eng.executor.draft
    assert d.cfg.name == "granite-8b-reduced" and d.params is not eng.executor.params
    assert d.params["embed"]["table"].device.type == "cpu"
    got, _ = _run(eng)
    want, _ = _run(Engine(cfg, params, ServeConfig(**_serve()), device="cpu"))
    assert got == want


# ----------------------------------------------------- n-best fan-out --


def _nbest(**kw):
    return _serve(max_batch=4, kv_layout="paged", kv_page_size=8, **kw)


def test_n_best_greedy_matches_reference(model):
    """Greedy siblings fork off the first one's pages: each equals the n=1
    stream, and the streams and fork telemetry are the JAX engine's."""
    jcfg, jparams, cfg, params = model
    single, _ = _run(Engine(cfg, params, ServeConfig(**_nbest()), device="cpu"),
                     [SAMPLED_PROMPT])
    out = []
    for eng, sp in ((Engine(cfg, params, ServeConfig(**_nbest()), device="cpu"),
                     SamplingParams(max_new_tokens=6)),
                    (JEngine(jcfg, jparams, JServeConfig(**_nbest())),
                     JSamplingParams(max_new_tokens=6))):
        hh = eng.submit(SAMPLED_PROMPT, sp, n=3)
        fin = eng.generate()
        tel = eng.telemetry
        out.append(([fin[h.uid].generated for h in hh], tel["forks"], tel["gen_pages_shared"],
                     tel["prefill_dispatches"]))
    assert out[0] == out[1]
    streams, forks, shared, prefills = out[0]
    assert streams == single * 3 and forks == 2 and shared > 0 and prefills == 1


def test_n_best_siblings_share_generation_pages(model):
    _, _, cfg, params = model
    eng = Engine(cfg, params, ServeConfig(**_nbest()), device="cpu")
    hh = eng.submit(SAMPLED_PROMPT, SamplingParams(max_new_tokens=6, temperature=0.8, seed=11),
                    n=3)
    assert isinstance(hh, list) and len(hh) == 3
    fin = eng.generate()
    outs = [fin[h.uid].generated for h in hh]
    assert all(len(o) == 6 for o in outs) and len({tuple(o) for o in outs}) == 3
    eng.executor.cache_mgr.check_invariants()
    tel = eng.telemetry
    assert tel["forks"] == 2 and tel["gen_pages_shared"] > 0 and tel["prefill_dispatches"] == 1


def test_n_best_is_deterministic(model):
    _, _, cfg, params = model

    def run():
        eng = Engine(cfg, params, ServeConfig(**_nbest()), device="cpu")
        hh = eng.submit(SAMPLED_PROMPT,
                        SamplingParams(max_new_tokens=6, temperature=0.8, seed=11), n=3)
        fin = eng.generate()
        return [fin[h.uid].generated for h in hh]

    assert run() == run()


def test_n_best_falls_back_without_pages(model):
    _, _, cfg, params = model
    eng = Engine(cfg, params, ServeConfig(**_serve(max_batch=4)), device="cpu")
    hh = eng.submit(SAMPLED_PROMPT, SamplingParams(max_new_tokens=5, temperature=0.8, seed=11),
                    n=2)
    fin = eng.generate()
    assert len({tuple(fin[h.uid].generated) for h in hh}) == 2
    assert eng.telemetry["forks"] == 0 and eng.telemetry["prefill_dispatches"] == 1


def test_submit_validates_sampling_and_n(model):
    _, _, cfg, params = model
    eng = Engine(cfg, params, ServeConfig(**_serve()), device="cpu")
    for bad in (dict(temperature=-0.5), dict(top_p=0.0), dict(top_k=-1), dict(seed=-3)):
        with pytest.raises(ValueError):
            eng.submit([1, 2], SamplingParams(**bad))
    with pytest.raises(ValueError):
        eng.submit([1, 2], n=0)


# -------------------------------------------------------- replica salt --


def test_replicas_draw_distinct_unseeded_streams(model):
    _, _, cfg, params = model
    sp = SamplingParams(max_new_tokens=8, temperature=1.0)

    def run():
        router = ReplicaRouter(cfg, params, ServeConfig(**_serve(replicas=2)), seed=5,
                               device="cpu")
        h0, h1 = router.submit(list(SAMPLED_PROMPT), sp), router.submit(list(SAMPLED_PROMPT), sp)
        assert {router.replica_of(h0), router.replica_of(h1)} == {0, 1}
        fin = router.generate()
        return fin[h0.uid].generated, fin[h1.uid].generated

    a = run()
    assert a[0] != a[1] and run() == a


def test_seeded_stream_is_replica_independent(model):
    _, _, cfg, params = model
    outs = []
    for replica in (0, 5):
        eng = Engine(cfg, params, ServeConfig(**_serve()), seed=9, replica=replica, device="cpu")
        outs.append(_run(eng, [SAMPLED_PROMPT], SAMPLED)[0])
    assert outs[0] == outs[1]
