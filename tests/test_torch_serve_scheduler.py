"""The port's scheduling policies (``repro_torch.serve.scheduler``, ``slo``,
``workloads``, ported by copy) against the JAX package's.

- The policy modules import no torch and nothing of the JAX package (a
  source scan, as the reference scans its own for jax).
- One seeded ``workloads`` trace goes through both packages'
  ``FifoScheduler`` and ``DeadlineScheduler``, each over its own
  ``CacheManager`` and a stub executor that applies the decisions on the
  host (admissions, teacher-forced tails, tokens from a fixed function,
  eos and budgets, retirement) with the same ``ExecutorCaps``: the
  ``ScheduleDecision`` of every step is equal.  The caps cover the CPU
  engine's (bit-exact: prefix-skip, chunked prefill, preemption) and the
  card's (not bit-exact, no cache-extend program: storage-only prefix
  sharing, FIFO blocking, with the same warnings and disabled features).
- The workload generators and the phase tracer's summaries agree.
"""

import ast
import dataclasses
import re
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro.serve import phases as jphases  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro.serve import slo as jslo  # noqa: E402
from repro.serve import workloads as jwork  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.serve import kv_cache, phases, scheduler, slo, workloads  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
POLICY_FILES = [ROOT / "src" / "repro_torch" / "serve" / f"{m}.py"
                for m in ("scheduler", "slo", "workloads")]
VOCAB = 128


@pytest.mark.parametrize("path", POLICY_FILES, ids=lambda p: p.name)
def test_policy_modules_import_no_torch(path):
    src = path.read_text()
    mods = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    assert not [m for m in mods if m.split(".")[0] in ("torch", "jax", "repro")], mods
    assert not re.search(r"(?<![\w.])torch\.", src)  # no torch use by any name


class _Stub:
    """The executor's host bookkeeping without a model: admissions become
    residents, prompts and teacher-forced tails advance positions, each
    decode step emits ``_token(uid, index)``, eos and budgets retire."""

    def __init__(self, pkg, sc, mgr):
        self.pkg, self.sc, self.mgr = pkg, sc, mgr
        self.slots = [pkg.Slot() for _ in range(sc.max_batch)]

    @staticmethod
    def _token(req, i):
        return (req.uid * 7919 + i * 104729 + len(req.prompt)) % VOCAB

    def _retire(self, idx):
        s = self.slots[idx]
        if s.active and (s.request.done or s.pos + 1 >= self.sc.max_seq_len):
            self.slots[idx] = self.pkg.Slot()
            self.mgr.free(idx)

    def apply(self, d):
        for idx, _ in d.preempted:
            self.slots[idx] = self.pkg.Slot()
        for a in d.admissions:
            s = self.slots[a.slot]
            s.admit_seq, s.admit_gen = a.admit_seq, a.admit_gen
            s.active, s.request = True, a.request
            if a.mode == self.pkg.MODE_PREFILL:
                a.request.generated.append(self._token(a.request, len(a.request.generated)))
                s.pos, s.last_token = len(a.tokens), a.request.generated[-1]
            else:  # skip or chunked: the tail is teacher-forced
                start = a.write_from if a.mode == self.pkg.MODE_SKIP else a.fill_len
                s.pos, s.last_token = start, a.tokens[start]
                s.pending = list(a.tokens[start + 1:])
            self._retire(a.slot)
        for idx in d.decode_slots:
            s = self.slots[idx]
            if not s.active:
                continue
            req = s.request
            rem = max(req.max_new_tokens - len(req.generated), 1)
            self.mgr.ensure(idx, min(s.pos + min(self.sc.decode_steps, len(s.pending) + rem),
                                     self.sc.max_seq_len), write_from=s.pos)
            for _ in range(self.sc.decode_steps):
                if s.pending:
                    s.last_token = s.pending.pop(0)
                    s.pos += 1
                    continue
                nxt = self._token(req, len(req.generated))
                req.generated.append(nxt)
                s.pos += 1
                s.last_token = nxt
                if req.done or s.pos + 1 >= self.sc.max_seq_len:
                    break
            if d.register_decoded:
                self.mgr.register_filled(idx, req.resume_tokens, s.pos)
            self._retire(idx)
        self.mgr._pending_copies.clear()  # the device side: the engine tests


def _plain(d):
    """A ScheduleDecision as plain data (requests by uid)."""
    return dict(
        preempted=[(i, r.uid) for i, r in d.preempted],
        admissions=[(a.slot, a.request.uid, a.tokens, a.mode, a.bucket, a.fill_len,
                     a.write_from, a.decode_from, a.shared_pages, a.admit_seq, a.admit_gen,
                     a.swapped_pages, a.sampling) for a in d.admissions],
        groups={b: [a.slot for a in g] for b, g in d.prefill_groups.items()},
        decode=list(d.decode_slots), extend=list(d.extend_slots),
        register=d.register_decoded, dropped=[r.uid for r in d.dropped],
    )


CAPS = {
    # the CPU engine: bit-exact decode, no cache-extend program
    "bit_exact": dict(bit_exact=True, cache_extend=False),
    # the CUDA engine: prefill through the kernel, no cache-extend program
    "kernel": dict(bit_exact=False, cache_extend=False),
}


def _run(pkg, mgr_mod, sched_cls, sc, caps_kw, events, clock_cls):
    cfg = (jax_get_config if pkg is jsched else get_config)("granite-8b", reduced=True)
    mgr = (mgr_mod.CacheManager(cfg, sc) if pkg is jsched
           else mgr_mod.CacheManager(cfg, sc, device="cpu"))
    caps = pkg.ExecutorCaps(max_batch=sc.max_batch, max_seq_len=sc.max_seq_len,
                            decode_steps=sc.decode_steps, buckets=sc.resolved_buckets(),
                            bucketable=True, paged=mgr.layout == "paged",
                            prefix_cache=mgr.prefix_cache, **caps_kw)
    clock = clock_cls()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sched = sched_cls(sc, caps, mgr, clock=clock)
    stub = _Stub(pkg, sc, mgr)
    pending, uid, trace = list(events), 0, []
    for _ in range(400):
        while pending and pending[0].at <= clock():
            ev = pending.pop(0)
            uid += 1
            now = clock()
            req = pkg.Request(uid, list(ev.prompt), ev.max_new_tokens, ev.eos_id,
                              created_at=now, submitted_at=now,
                              deadline_at=None if ev.deadline_s is None else now + ev.deadline_s)
            sched.enqueue(req)
        if not pending and not sched.queue and not any(s.active for s in stub.slots):
            break
        d = sched.schedule(stub.slots)
        trace.append(_plain(d))
        stub.apply(d)
        mgr.check_invariants()
        clock.advance(0.01)
    assert not pending and not sched.queue
    return trace, sched.stats, [str(w.message) for w in caught], mgr.stats().as_dict()


@pytest.mark.parametrize("caps", list(CAPS))
@pytest.mark.parametrize("policy", ["fifo", "edf"])
def test_same_decisions_as_reference(policy, caps):
    base = dict(max_batch=3, max_seq_len=64, prefill_buckets=(8, 16, 32), decode_steps=3,
                kv_layout="paged", kv_page_size=8, kv_pages=11, kv_prefix_cache=True,
                kv_preemption=True, prefill_chunk=8, scheduler=policy, overdue_policy="drop")
    kw = dict(rate=300.0, n=14, vocab_size=VOCAB, seed=3, prompt_len=(3, 24), shared_prefix=8,
              max_new_tokens=9, deadline_s=(0.02, 0.2) if policy == "edf" else None,
              eos_id=5)
    events = workloads.poisson(**kw)
    assert events == [workloads.ArrivalEvent(**dataclasses.asdict(e))
                      for e in jwork.poisson(**kw)]
    sched = {"fifo": (jsched.FifoScheduler, scheduler.FifoScheduler),
             "edf": (jslo.DeadlineScheduler, slo.DeadlineScheduler)}[policy]
    ref = _run(jsched, jkv, sched[0], JServeConfig(**base), CAPS[caps], events, jwork.StepClock)
    ours = _run(scheduler, kv_cache, sched[1], ServeConfig(**base), CAPS[caps], events,
                workloads.StepClock)
    assert len(ours[0]) == len(ref[0]) > 5
    for step, (a, b) in enumerate(zip(ours[0], ref[0])):
        assert a == b, f"step {step}"
    assert ours[1] == ref[1]  # scheduler stats, disabled features included
    assert ours[2] == ref[2]  # warnings
    assert ours[3] == ref[3]  # the cache manager's stats
    if caps == "bit_exact":
        assert ours[1]["preemptions"] > 0 and ours[1]["prefill_tokens_saved"] > 0
        assert policy == "fifo" or ours[1]["deadline_drops"] > 0
    else:  # prefix sharing is storage-only, preemption and chunking are off
        assert len(ours[1]["disabled_features"]) == 3 and ours[1]["prefix_tokens_shared"] > 0


def test_workload_generators_match_reference(tmp_path):
    for gen in ("poisson", "synchronous", "multi_tenant"):
        kw = dict(n=9, vocab_size=VOCAB, seed=4, deadline_s=(0.1, 0.2))
        if gen != "synchronous":
            kw["rate"] = 5.0
        ours, ref = getattr(workloads, gen)(**kw), getattr(jwork, gen)(**kw)
        assert [dataclasses.asdict(e) for e in ours] == [dataclasses.asdict(e) for e in ref]
    workloads.save_trace(ours, str(tmp_path / "t.json"))
    assert jwork.load_trace(str(tmp_path / "t.json")) == ref


def test_phase_tracer_summary_matches_reference():
    """The copied tracer summarises one set of records as the reference
    does; the untraced tracer never fences; a fence of CPU tensors is a
    no-op that counts."""
    recs = [{"schedule": 0.001 * i, "dispatch": 0.002, "wall": 0.01 + 0.001 * i}
            for i in range(7)]
    ours, ref = phases.PhaseTracer(ring=5), jphases.PhaseTracer(ring=5)
    for t in (ours, ref):
        t._ring.extend(recs)
    assert ours.summary() == ref.summary()
    assert phases.make_tracer(False) is phases.NULL_TRACER
    x = torch.zeros(3)
    assert phases.NULL_TRACER.fence(x) is x
    assert ours.fence({"a": (x, [x])})["a"][0] is x and ours.fences == 1
    assert isinstance(phases.make_tracer(True, mode="overlap"), phases.OverlapTracer)
