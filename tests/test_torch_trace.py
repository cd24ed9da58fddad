"""The port's span recorder (``repro_torch.trace``), its span sites in the
serving engine and the physics forward, the phase summaries built on it
(``serve/phases.py``), and the readers that put spans beside a device
trace, on the CPU.

- Off (the default), a span site returns the shared no-op and reads no
  clock: an engine's steps and a forward under ``paper_vu13p`` make no
  span and no clock read.
- On, children lie inside their parents with own time >= 0, and every
  span of a step lies under its ``engine.step``, which carries the step's
  id; under ``async_loop`` each ``collect`` names the decode dispatch it
  waits for as its cause; a prefill span counts its rows and prompt
  tokens; ``precision`` spans run under ``paper_vu13p`` only.
- A step's phase record is the sum of its spans (collect's own time in
  ``collect_phase``, the overlap from a decode's end to its collect).
- The readers on hand-built spans and device operations: attribution by
  the launching runtime call, device time under a span, idle time by the
  innermost span, the host's share of it, the prefill padding.
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.core import precision  # noqa: E402
from repro_torch.models import lm, physics  # noqa: E402
from repro_torch.serve import Engine, SamplingParams  # noqa: E402
from repro_torch.serve.phases import OverlapTracer, PhaseTracer  # noqa: E402

PROMPTS = ([5, 9, 3, 7, 2], [11, 2, 6, 4, 4, 1, 8], [1, 2, 3])


@pytest.fixture(autouse=True)
def recording_off():
    """Every test starts and ends with nothing recording."""
    assert trace._rec is None
    yield
    if trace._kept is not None:
        trace.stop()
    assert trace._rec is None


@pytest.fixture(scope="module")
def granite():
    cfg = get_config("granite-8b", reduced=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    return cfg, params


@pytest.fixture(scope="module")
def gw():
    cfg = dataclasses.replace(get_config("gw"), precision="paper_vu13p")
    raw = physics.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    params = precision.apply_plan_to_params(raw, precision.resolve_model_plan(cfg))
    x = torch.randn(3, cfg.seq_len, cfg.input_vec_size, generator=torch.Generator().manual_seed(6))
    return cfg, params, x


def _engine(granite, **kw):
    sc = dict(max_batch=4, max_seq_len=32, prefill_buckets=(8,), decode_steps=2,
              temperature=0.0)
    sc.update(kw)
    return Engine(*granite, ServeConfig(**sc), device="cpu")


def _serve(eng, prompts=PROMPTS, max_new=5):
    for p in prompts:
        eng.submit(list(p), SamplingParams(max_new_tokens=max_new))
    eng.generate()


def _traced(fn):
    trace.start()
    try:
        fn()
    finally:
        spans = trace.stop()
    return spans


class CountingClock:
    def __init__(self):
        self.reads, self.t = 0, 1_000

    def __call__(self):
        self.reads += 1
        self.t += 10
        return self.t


# ------------------------------------------------------------ off and on --


def test_off_makes_no_span_and_reads_no_clock(granite, gw, monkeypatch):
    clock = CountingClock()
    monkeypatch.setattr(trace, "_clock", clock)
    first_id = next(trace._ids)
    assert trace.span("prefill", cause=3, rows=2) is trace.NULL
    with trace.span("decode") as sp:
        sp.set(slots=4)
    assert sp is trace.NULL and sp.id == 0
    _serve(_engine(granite))
    _serve(_engine(granite, async_loop=True))
    cfg, params, x = gw
    physics.forward(params, cfg, x, device="cpu")
    assert clock.reads == 0 and trace._rec is None
    assert next(trace._ids) == first_id + 1  # no span was made


def test_spans_nest_inside_their_parents_and_their_step(granite):
    spans = _traced(lambda: _serve(_engine(granite)))
    by_id = {s.id: s for s in spans}
    names = {s.name for s in spans}
    assert {"engine.step", "schedule", "prefill", "decode", "collect", "host_prep", "launch",
            "device", "sample", "route"} <= names
    own = {s.id: s.end - s.start for s in spans}
    for s in spans:
        assert s.start <= s.end
        if s.parent:
            p = by_id[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s, p)
            own[p.id] -= s.end - s.start
    assert min(own.values()) >= 0

    def root(s):
        while s.parent:
            s = by_id[s.parent]
        return s

    steps = [s for s in spans if s.name == "engine.step"]
    assert [s.attrs["step"] for s in steps] == list(range(1, len(steps) + 1))
    assert all(root(s).name == "engine.step" for s in spans)
    for s in spans:  # a dispatch's phases lie in its dispatch span, in its step
        if s.name in ("host_prep", "launch", "device"):
            assert by_id[s.parent].name in ("prefill", "decode")


def test_async_collect_names_the_decode_it_waits_for(granite):
    spans = _traced(lambda: _serve(_engine(granite, async_loop=True)))
    by_id = {s.id: s for s in spans}
    step_of = {}
    for s in spans:
        r = s
        while r.parent:
            r = by_id[r.parent]
        step_of[s.id] = r.attrs["step"]
    collects = [s for s in spans if s.name == "collect"]
    decodes = [s for s in spans if s.name == "decode"]
    assert collects and len(collects) == len(decodes)
    assert {c.cause for c in collects} == {d.id for d in decodes}
    for c in collects:
        d = by_id[c.cause]
        assert d.name == "decode" and d.end <= c.start
        assert step_of[c.id] == step_of[d.id] + 1  # the pipelined loop collects a step later


def test_prefill_span_counts_rows_and_prompt_tokens(granite):
    eng = _engine(granite)
    spans = _traced(lambda: _serve(eng))
    (pre,) = [s for s in spans if s.name == "prefill"]
    assert pre.attrs == {"bucket": 8, "rows": 3, "max_batch": 4, "fill_tokens": 5 + 7 + 3,
                         "uids": [1, 2, 3]}
    assert trace.padding_share(spans) == pytest.approx(1 - 15 / 32)
    (sched,) = [s for s in spans if s.name == "schedule" and s.attrs["admissions"]]
    assert sched.attrs["admissions"] == 3
    decodes = [s for s in spans if s.name == "decode"]
    assert decodes[0].attrs["slots"] == 3 and decodes[0].attrs["decode_steps"] == 2
    assert sorted(decodes[0].attrs["uids"]) == [1, 2, 3]


def test_precision_spans_follow_the_plan(gw):
    cfg, params, x = gw
    spans = _traced(lambda: physics.forward(params, cfg, x, device="cpu"))
    (fwd,) = [s for s in spans if s.name == "physics.forward"]
    snaps = [s for s in spans if s.name == "precision"]
    assert fwd.attrs == {"batch": 3}
    # the embed's input, four projections and two MLP inputs per block, two head inputs
    assert len(snaps) == 1 + 6 * cfg.n_layers + 2
    assert {s.parent for s in snaps} == {fwd.id}
    assert [s.attrs["slot"] for s in snaps] == ["embed"] + ["layer"] * 6 * cfg.n_layers + [
        "logits"] * 2
    assert all(s.attrs["operand"] == "act" for s in snaps)
    flt = dataclasses.replace(cfg, precision="float")
    spans = _traced(lambda: physics.forward(params, flt, x, device="cpu"))
    assert [s.name for s in spans] == ["physics.forward"]


def test_per_layer_plan_snaps_are_spans_too(gw):
    """A layer-heterogeneous plan runs the tensor-parameter snap."""
    cfg, params, x = gw
    policy = precision.PrecisionPolicy("mixed", (
        precision.Rule("layers.0.activations", precision.fixed(12, 6)),))
    spans = _traced(lambda: physics.forward(params, dataclasses.replace(cfg, precision=policy),
                                            x, device="cpu"))
    snaps = [s for s in spans if s.name == "precision"]
    assert len(snaps) == 2 * 6 * cfg.n_layers  # weights and activations of every layer's sites
    assert {s.attrs["slot"] for s in snaps} == {"layer"}


def test_start_and_stop_guard_and_share_the_recorder():
    with pytest.raises(RuntimeError, match="not on"):
        trace.stop()
    trace.start()
    with pytest.raises(RuntimeError, match="already on"):
        trace.start()
    tracer = PhaseTracer(ring=4)
    tracer.begin_step()
    with trace.span("engine.step"):
        with trace.span("schedule"):
            pass
    tracer.end_step()
    assert trace._rec is not None  # start() still records
    spans = trace.stop()
    assert [s.name for s in spans] == ["schedule", "engine.step"]
    assert set(tracer.records()[0]) == {"schedule", "wall"}


# ------------------------------------------------------ phase summaries --


def _step(tracer, plan):
    """One step of hand-timed spans: ``plan`` is (name, cause, [children])
    nested lists, each span taking one clock tick at open and close."""
    ids = {}

    def run(node):
        name, cause, children = node
        with trace.span(name, ids.get(cause, 0)) as sp:
            ids[name] = sp.id
            for c in children:
                run(c)

    tracer.begin_step()
    run(plan)
    tracer.end_step()
    return ids


@pytest.mark.parametrize("kind", [PhaseTracer, OverlapTracer])
def test_a_step_record_sums_its_spans(kind, monkeypatch):
    monkeypatch.setattr(trace, "_clock", CountingClock())  # 10 ns a read
    tracer = kind(ring=8)
    decode = ("decode", None, [("host_prep", None, []), ("launch", None, []),
                               ("device", None, [])])
    collect = ("collect", "decode", [("sample", None, [])])
    _step(tracer, ("engine.step", None, [("schedule", None, []), decode, collect,
                                         ("route", None, [])]))
    (rec,) = tracer.records()
    # every leaf 10 ns; decode 70 (its three leaves and their gaps); collect 30 (own 20)
    want = {"schedule": 10e-9, "host_prep": 10e-9, "dispatch": 10e-9, "device": 10e-9,
            "sample": 10e-9, tracer.collect_phase: 20e-9 + (10e-9 if kind is PhaseTracer else 0),
            "wall": 170e-9}
    if kind is OverlapTracer:
        want["overlap"] = 10e-9  # the decode's end to its collect's start
    assert rec == pytest.approx(want)
    s = tracer.summary()
    assert s["steps"] == 1 and s["unattributed_s"] == pytest.approx(170e-9 - sum(
        v for k, v in want.items() if k != "wall"))


def test_overlap_spans_steps():
    """Under the async loop a decode's collect comes a step later."""
    tracer = OverlapTracer()
    _step(tracer, ("engine.step", None, [("decode", None, [])]))
    first = tracer._decode_end
    (did,) = first
    tracer.begin_step()
    with trace.span("engine.step"):
        with trace.span("collect", did):
            pass
    tracer.end_step()
    assert tracer.records()[1]["overlap"] > 0 and tracer._decode_end == {}


# -------------------------------------------------------------- readers --


def _span(sid, name, parent, start, end, cause=0, **attrs):
    return types.SimpleNamespace(id=sid, name=name, parent=parent, cause=cause, start=start,
                                 end=end, attrs=attrs)


#: a step 0-100 of a serving loop: schedule, a prefill (launch, device wait),
#: a decode (launch) and the collect that waits for it (sample inside)
SPANS = [
    _span(1, "engine.step", 0, 0, 100, step=1),
    _span(2, "schedule", 1, 0, 10),
    _span(3, "prefill", 1, 10, 40, bucket=8, max_batch=4, fill_tokens=12, rows=2),
    _span(4, "launch", 3, 12, 20),
    _span(5, "device", 3, 20, 35),
    _span(6, "decode", 1, 40, 60, slots=2, decode_steps=2),
    _span(7, "launch", 6, 50, 55),
    _span(8, "collect", 1, 60, 95, cause=6),
    _span(9, "sample", 8, 80, 95),
]
#: (start, end, name, launch ns): two prefill kernels, two decode kernels,
#: a copy launched outside any span, one with no launching call in the trace
OPS = [(14, 25, "gemm", 13), (25, 33, "attn", 18), (52, 62, "gemm", 51), (60, 70, "norm", 54),
       (110, 120, "copy", 105), (5, 6, "lost", 0)]


def test_attribution_is_by_the_launching_call():
    assert trace.innermost(SPANS, [13, 18, 51, 54, 105, 0, 10, 60, 80, 100]) == [
        4, 4, 7, 7, 0, 2, 3, 8, 9, 0]
    assert trace.device_ns_under(SPANS, OPS, "prefill") == 33 - 14
    assert trace.device_ns_under(SPANS, OPS, "decode") == 70 - 52
    assert trace.device_ns_under(SPANS, OPS, "engine.step") == 19 + 18
    assert trace.device_ns_under(SPANS, OPS, "route") == 0


def test_idle_time_by_innermost_span():
    # busy: 5-6, 14-33, 52-70, 110-120 within [0, 130)
    # idle: 0-5, 6-14, 33-52, 70-110, 120-130
    idle = trace.idle_by_span(SPANS, OPS, 0, 130)
    assert idle == {2: 5 + 4, 3: 2 + 5, 4: 2, 5: 2, 6: 10, 7: 2, 8: 10, 9: 15, 1: 5, 0: 10 + 10}
    assert sum(idle.values()) == 130 - (1 + 19 + 18 + 10)
    assert trace.idle_by_name(SPANS, OPS, 0, 130) == {
        "outside any span": 20, "engine.step": 5, "schedule": 9, "prefill": 7, "prefill/launch": 2,
        "prefill/device": 2, "decode": 10, "decode/launch": 2, "collect": 10, "collect/sample": 15}
    # host work inside the step: schedule, prefill's and decode's own lines, the
    # launches, sample and the step's own lines; not the device wait, not
    # collect's own wait, not outside the step
    assert trace.host_idle_ns(SPANS, OPS, 0, 130) == 9 + 7 + 2 + 10 + 2 + 15 + 5
    assert trace.idle_by_span(SPANS, OPS, 20, 30) == {}


def test_padding_share_and_union():
    assert trace.padding_share(SPANS) == pytest.approx(1 - 12 / 32)
    assert trace.padding_share(SPANS[:2]) is None
    assert trace.union_ns([(0, 10), (5, 12), (20, 25)]) == 17 and trace.union_ns([]) == 0


def test_device_ops_match_runtime_calls_by_correlation_id():
    from torch.autograd import DeviceType

    def ev(name, dev, start, dur, corr):
        return types.SimpleNamespace(name=lambda: name, device_type=lambda: dev,
                                     start_ns=lambda: start, duration_ns=lambda: dur,
                                     correlation_id=lambda: corr)

    events = [ev("aten::add", DeviceType.CPU, 1, 9, 7),  # host operators number their own ids
              ev("cudaLaunchKernel", DeviceType.CPU, 3, 2, 7),
              ev("elementwise_kernel", DeviceType.CUDA, 6, 4, 7),
              ev("layernorm_kernel", DeviceType.CUDA, 12, 3, 9)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    assert trace.device_ops(prof) == [(6, 10, "elementwise_kernel", 3),
                                      (12, 15, "layernorm_kernel", 0)]
