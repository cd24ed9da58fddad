"""The port's pipelined engine loop, ``shard_decode`` and the replica
router against the JAX package's (port of ``tests/test_async_engine.py``),
on the CPU, on the same numpy parameters.

- Async greedy streams equal the synchronous loop's and the JAX async
  engine's on GQA float, MLA float and int8-KV GQA, dense and paged; under
  forced preemption too (the in-flight tokens of a preempted slot are
  discarded at collect and regenerated after resume).
- Mid-flight cancel, EDF drops on a virtual clock (deterministic and equal
  to the synchronous loop's totals), TokenEvents stamped with the dispatch
  clock, the in-flight marks and the admit_seq discard, the overlap tracer
  (no fences) and the fenced tracer's warning.
- ``shard_decode`` in a one-process gloo group: params and every cache pool
  are DTensors whose local tensors the engine runs on, streams equal the
  unsharded engine's, one decode shape (several ranks:
  ``tests/test_torch_shard_decode.py``).
- The program count with everything on at once, and the router: streams of
  one engine and of the JAX router, least-loaded admission, stream and
  cancel delegation.
"""

import dataclasses
import tempfile
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
from repro.models import lm as jlm  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import ReplicaRouter as JRouter  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import precision as P  # noqa: E402
from repro_torch.serve import Engine, ReplicaRouter, SamplingParams, StepClock  # noqa: E402
from repro_torch.serve import workloads  # noqa: E402
from repro_torch.serve.phases import PHASES, OverlapTracer, make_tracer  # noqa: E402
from repro_torch.serve.scheduler import Slot  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

POLICIES = {None: (None, None),
            "kv8": (P.PrecisionPolicy("kv8", (P.Rule("kv_cache", P.int8(per_channel=False)),)),
                    JP.PrecisionPolicy("kv8", (JP.Rule("kv_cache", JP.int8(per_channel=False)),)))}
PROMPTS = ([5, 9, 3, 7], [11, 2, 6], [1, 2, 3, 4, 5, 6, 7, 8, 9], [4, 4], [8, 1, 6, 2, 9])


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("granite-8b", "minicpm3-4b"):
        jcfg = jax_get_config(arch, reduced=True)
        raw = numpy_tree(jlm.param_spec(jcfg), 17)
        out[arch] = (jcfg, jax.tree.map(jnp.asarray, raw), get_config(arch, reduced=True),
                     params_from_numpy(raw, "cpu"))
    return out


@pytest.fixture(scope="module")
def granite(models):
    return models["granite-8b"][2:]


@pytest.fixture(scope="module")
def one_rank_group():
    """A gloo process group of this process alone, for ``shard_decode``."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", rank=0, world_size=1)
        yield
        dist.destroy_process_group()


def _serve(**kw):
    base = dict(max_batch=2, max_seq_len=64, prefill_buckets=(8, 16, 32), decode_steps=3,
                temperature=0.0)
    base.update(kw)
    return base


def _generate(eng, prompts=PROMPTS, max_new=8):
    handles = [eng.submit(list(p), max_new_tokens=max_new) for p in prompts]
    fin = eng.generate()
    return [tuple(fin[h.uid].generated) for h in handles]


def _ours(cfg, params, sc, **kw):
    return Engine(cfg, params, ServeConfig(**sc), device="cpu", **kw)


# ------------------------------------------------- token-identity matrix --


@pytest.mark.parametrize("arch,policy", [("granite-8b", None), ("minicpm3-4b", None),
                                         ("granite-8b", "kv8")], ids=["gqa", "mla", "int8kv"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_async_greedy_identical_to_sync_and_reference(models, arch, policy, layout):
    jcfg, jparams, cfg, params = models[arch]
    ours_pol, ref_pol = POLICIES[policy]
    kw = dict(kv_layout=layout, kv_page_size=8)
    sync = _generate(_ours(cfg, params, _serve(policy=ours_pol, **kw)))
    eng = _ours(cfg, params, _serve(async_loop=True, policy=ours_pol, **kw))
    pipe = _generate(eng)
    ref = _generate(JEngine(jcfg, jparams, JServeConfig(**_serve(async_loop=True,
                                                                 policy=ref_pol, **kw))))
    assert pipe == sync == ref
    assert eng.executor.async_loop and eng._inflight is not None
    assert eng.telemetry["decode_compiles"] == 1


def test_async_identical_under_forced_preemption(models):
    """A pool too small for two residents forces preemption cycles: async
    streams equal the sync loop's and the JAX async engine's."""
    jcfg, jparams, cfg, params = models["granite-8b"]
    kw = dict(max_seq_len=32, decode_steps=2, kv_layout="paged", kv_page_size=8, kv_pages=5,
              kv_prefix_cache=True, kv_preemption=True)
    prompts = [[3 + i, 1, 4] for i in range(4)]
    sref = _ours(cfg, params, _serve(**kw))
    sync = _generate(sref, prompts, 20)
    eng = _ours(cfg, params, _serve(async_loop=True, **kw))
    pipe = _generate(eng, prompts, 20)
    jeng = JEngine(jcfg, jparams, JServeConfig(**_serve(async_loop=True, **kw)))
    assert pipe == sync == _generate(jeng, prompts, 20)
    assert sref.telemetry["preemptions"] > 0 and eng.telemetry["preemptions"] > 0
    assert eng.telemetry["preemptions"] == jeng.telemetry["preemptions"]
    eng.executor.cache_mgr.check_invariants()


def test_async_runs_are_deterministic(granite):
    sc = _serve(async_loop=True, kv_layout="paged", kv_page_size=8)
    assert _generate(_ours(*granite, sc)) == _generate(_ours(*granite, sc))


def test_async_sampled_matches_sync(granite):
    """Seeded sampled streams ride the carry too: async equals sync."""
    sp = SamplingParams(max_new_tokens=8, temperature=0.9, top_k=12, seed=3)
    outs = []
    for async_loop in (False, True):
        eng = _ours(*granite, _serve(async_loop=async_loop))
        hs = [eng.submit(list(p), sp) for p in PROMPTS]
        fin = eng.generate()
        outs.append([fin[h.uid].generated for h in hs])
    assert outs[0] == outs[1]


# ------------------------------------------------------ stale boundaries --


def test_mid_flight_cancel_discards_inflight_tokens(granite):
    eng = _ours(*granite, _serve(async_loop=True, kv_layout="paged", kv_page_size=8))
    ha = eng.submit(list(PROMPTS[0]), max_new_tokens=12)
    hb = eng.submit(list(PROMPTS[1]), max_new_tokens=12)
    for _ in range(3):  # the prefill and a couple of pipelined decode steps
        eng.step()
    gen_at_cancel = len(eng.request(ha).generated)
    assert eng.cancel(ha) and eng.finish_reason(ha) == "cancelled"
    fin = eng.generate()
    assert len(eng.request(ha).generated) <= gen_at_cancel + 1
    assert hb.uid in fin and len(fin[hb.uid].generated) == 12
    eng.executor.cache_mgr.check_invariants()
    assert not eng.has_work


def test_edf_drops_identical_and_deterministic(granite):
    """EDF drops touch queued requests only: a seeded Poisson workload on a
    virtual clock completes and drops alike across two async runs and
    matches the synchronous loop's totals."""
    cfg = granite[0]

    def run(async_loop):
        eng = _ours(*granite, _serve(async_loop=async_loop, scheduler="edf"), clock=StepClock())
        events = workloads.poisson(rate=100.0, n=24, vocab_size=cfg.vocab_size, seed=3,
                                   prompt_len=(3, 10), max_new_tokens=6, deadline_s=(0.05, 0.6))
        return workloads.replay(eng, events, step_cost=0.02)

    def virtual(rep):
        d = rep.as_dict()
        d.pop("host_wall_s")
        return d

    sync, a, b = run(False), run(True), run(True)
    assert virtual(a) == virtual(b) and a.per_request == b.per_request
    assert (a.requests, a.completed, a.dropped, a.tokens) == (sync.requests, sync.completed,
                                                             sync.dropped, sync.tokens)


def test_token_events_stamped_with_dispatch_clock(granite):
    def run():
        clock = StepClock()
        eng = _ours(*granite, _serve(async_loop=True), clock=clock)
        events = []
        for ev in eng.stream(eng.submit(list(PROMPTS[0]), max_new_tokens=6)):
            events.append((ev.token, ev.index, ev.ts))
            clock.advance(0.01)
        return events

    assert run() == run()


def test_inflight_marks_track_uncollected_dispatch(granite):
    assert Slot().inflight is False
    eng = _ours(*granite, _serve(async_loop=True))
    eng.submit(list(PROMPTS[0]), max_new_tokens=8)
    eng.step()
    eng.step()
    marked = [i for i, s in enumerate(eng.executor.slots) if s.inflight]
    assert marked == list(eng._inflight.decode_set) and marked
    eng.generate()
    assert not any(s.inflight for s in eng.executor.slots)


def test_preempted_inflight_tokens_are_discarded_at_collect(granite):
    eng = _ours(*granite, _serve(async_loop=True))
    eng.submit(list(PROMPTS[0]), max_new_tokens=12)
    eng.step()
    eng.step()  # a decode dispatch is now in flight
    inflight = eng._inflight
    assert inflight is not None and inflight.decode_set
    idx = inflight.decode_set[0]
    req = eng.executor.slots[idx].request
    before = len(req.generated)
    eng.executor.slots[idx].admit_seq += 1  # a same-slot re-admission of the same request
    out = eng.executor.collect(inflight)
    eng._inflight = None
    assert len(req.generated) == before
    assert not any(t[0] == req.uid for t in out.tokens)


# ---------------------------------------------------------- overlap mode --


def test_overlap_tracer_never_fences_and_reports_overlap(granite):
    eng = _ours(*granite, _serve(async_loop=True, trace_phases=True, phase_mode="overlap"))
    assert isinstance(eng._tracer, OverlapTracer)
    eng.generate([list(p) for p in PROMPTS[:3]], max_new_tokens=6)
    assert eng._tracer.fences == 0
    s = eng.telemetry["phases"]
    assert s["device_overlap_s"] > 0.0 and 0.0 <= s["overlap_efficiency"] <= 1.0
    assert "host_bubble_s" in s
    for rec in eng._tracer.records():
        assert set(rec) <= set(PHASES) | {"wall", "collect", "overlap"}


def test_make_tracer_mode_dispatch():
    assert isinstance(make_tracer(True, mode="overlap"), OverlapTracer)
    assert make_tracer(True, mode="fenced").collect_phase == "sample"
    assert make_tracer(False, mode="overlap").collect_phase == "sample"
    with pytest.raises(ValueError, match="phase_mode"):
        make_tracer(True, mode="bogus")


def test_fenced_tracer_with_async_loop_warns(models, granite):
    jcfg, jparams = models["granite-8b"][:2]
    kw = _serve(async_loop=True, trace_phases=True, phase_mode="fenced")
    with pytest.warns(UserWarning, match="serializing the async_loop") as ours:
        _ours(*granite, kw)
    with pytest.warns(UserWarning) as ref:
        JEngine(jcfg, jparams, JServeConfig(**kw))
    assert [str(w.message) for w in ours] == [str(w.message) for w in ref]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _ours(*granite, _serve(async_loop=True, trace_phases=True, phase_mode="overlap"))


# --------------------------------------------------- mesh-sharded decode --


def test_shard_decode_places_dtensors(granite, one_rank_group):
    """A one-rank host mesh: params and every cache pool DTensors, the
    engine's tensors their local shards (the same storage), streams equal
    the unsharded engine's, one decode shape."""
    from torch.distributed.tensor import DTensor

    kw = dict(kv_layout="paged", kv_page_size=8)
    plain = _generate(_ours(*granite, _serve(**kw)))
    eng = _ours(*granite, _serve(shard_decode=True, async_loop=True, **kw))
    assert _generate(eng) == plain
    ex = eng.executor
    assert ex.mesh is not None and ex.cache_mgr.table_sharding is not None
    for group, leaves in ex.placed["caches"].items():
        for name, t in leaves.items():
            assert isinstance(t, DTensor)
            assert t.to_local().data_ptr() == ex.caches[group][name].data_ptr()
    ex.cache_mgr.write_table(ex.caches)  # a table rebuild lands in the placed table
    assert torch.equal(ex.placed["caches"]["layers"]["page_table"].to_local()[0],
                       torch.from_numpy(ex.cache_mgr._table))
    n = 0
    for t in jax.tree.leaves(ex.placed["params"], is_leaf=lambda x: isinstance(x, DTensor)):
        assert isinstance(t, DTensor)
        n += 1
    assert n > 0 and eng.telemetry["decode_compiles"] == 1


def test_program_count_with_everything_enabled(granite, one_rank_group):
    """Async loop, sharded decode, the overlap tracer, EDF, prefix cache,
    preemption, chunked prefill, speculative decoding, mixed per-request
    sampling and n-best forks together: at most len(buckets) prefill
    shapes, one decode and one extend shape on the target; the draft at
    most len(buckets) prefill shapes."""
    cfg = granite[0]
    eng = _ours(*granite, _serve(async_loop=True, shard_decode=True, trace_phases=True,
                                 phase_mode="overlap", scheduler="edf", kv_layout="paged",
                                 kv_page_size=8, kv_prefix_cache=True, kv_preemption=True,
                                 prefill_chunk=8, speculative=True, spec_tokens=3),
                clock=StepClock())
    events = workloads.poisson(rate=50.0, n=12, vocab_size=cfg.vocab_size, seed=0,
                               max_new_tokens=6, deadline_s=(0.5, 5.0), shared_prefix=8)
    workloads.replay(eng, events, step_cost=0.1)
    eng.submit([5, 9, 3], SamplingParams(max_new_tokens=4))
    eng.submit([2, 4, 6, 8], SamplingParams(max_new_tokens=4, temperature=0.9, top_k=12,
                                            top_p=0.95, seed=7))
    eng.submit([7, 7, 1], SamplingParams(max_new_tokens=4, temperature=0.7, seed=11), n=2)
    eng.generate()
    ex, tel = eng.executor, eng.telemetry
    assert tel["prefill_compiles"] == len(ex._prefill_shapes) <= len(ex.buckets)
    assert tel["decode_compiles"] <= 1 and tel["extend_compiles"] <= 1
    assert ex.draft is not None and len(ex.draft._prefill_shapes) <= len(ex.buckets)
    assert tel["draft_tokens_proposed"] > 0 and tel["forks"] > 0
    assert eng._tracer.fences == 0
    ex.cache_mgr.check_invariants()


# ---------------------------------------------------------- replica router --


def test_router_greedy_identical_to_one_engine_and_reference(models, granite):
    jcfg, jparams = models["granite-8b"][:2]
    want = _generate(_ours(*granite, _serve()), max_new=6)
    router = ReplicaRouter(*granite, ServeConfig(**_serve(replicas=2, async_loop=True)),
                           device="cpu")
    assert _generate(router, max_new=6) == want
    jrouter = JRouter(jcfg, jparams, JServeConfig(**_serve(replicas=2, async_loop=True)))
    assert _generate(jrouter, max_new=6) == want
    assert router.telemetry["prompts_admitted"] == jrouter.telemetry["prompts_admitted"]
    assert [router.replica_of(h) for h in range(1, 6)] == [
        jrouter.replica_of(h) for h in range(1, 6)]


def test_router_least_loaded_admission_balances(granite):
    router = ReplicaRouter(*granite, ServeConfig(**_serve(replicas=3)), device="cpu")
    handles = [router.submit(list(PROMPTS[i % len(PROMPTS)]), max_new_tokens=4)
               for i in range(9)]
    placed = [router.replica_of(h) for h in handles]
    assert [placed.count(i) for i in range(3)] == [3, 3, 3]
    router.generate()
    assert not router.has_work
    # the weights are shared by reference: one set for every replica
    w = [e.executor.params["embed"]["table"].data_ptr() for e in router.engines]
    assert len(set(w)) == 1


def test_router_stream_and_cancel_delegate(granite):
    router = ReplicaRouter(*granite, ServeConfig(**_serve(replicas=2)), device="cpu")
    ha = router.submit(list(PROMPTS[0]), max_new_tokens=5)
    hb = router.submit(list(PROMPTS[1]), max_new_tokens=5)
    events = list(router.stream(ha))
    assert [e.uid for e in events] == [ha.uid] * len(events)
    assert [e.index for e in events] == list(range(len(events))) and events[-1].finished
    assert router.cancel(hb) or router.result(hb) is not None
    router.generate()
    tel = router.telemetry
    assert tel["replicas"] == 2 and len(tel["replica_telemetry"]) == 2
    assert tel["tokens_generated"] >= len(events)
    with pytest.raises(ValueError, match="replicas"):
        ReplicaRouter(*granite, ServeConfig(**_serve(replicas=0)), device="cpu")
    nb = router.submit(list(PROMPTS[2]), max_new_tokens=3, n=2)
    assert len({router.replica_of(h) for h in nb}) == 1  # siblings stay together


def test_sync_loop_is_untouched_by_default(granite):
    eng = _ours(*granite, _serve())
    eng.generate([list(p) for p in PROMPTS[:2]], max_new_tokens=5)
    assert not eng.executor.async_loop and eng.executor._carry is None
    assert eng._inflight is None and not eng.executor._carry_valid.any()
    assert dataclasses.asdict(eng.executor.caps)["cache_extend"]
