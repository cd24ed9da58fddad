"""The port's host victim tier (``CacheManager`` with ``kv_host_pages``)
against the JAX package's (the victim-tier parts of
``tests/test_prefix_cache.py``), on the CPU.

- One seeded op trace with the tier live (admissions that hit either tier,
  evictions that spill, swap-ins, flushes over real device pools) through
  both managers: equal host state after every op (the host index, the ring
  free list, the pending spill and swap-in queues), equal device pools and
  host rings after every flush, the port's invariants after every op (the
  reference's check flags one legal state of this trace: a spill whose chain
  matches again before a flush, its ring slot in transit to the swap-in).
- The random-trace property with the tier live, and the checker catching
  a chain key booked in both tiers.
- A flush moves rows bitwise: the rows a page spills are the rows its
  chain's swap-in writes back, and a spill's rows reach the ring before
  ``flush_swaps`` returns.
- Tenant cycling through an engine whose pool is below the warm working
  set: with the tier the spilled prefixes swap back and save prefill
  tokens, the greedy streams equal the tier-off engine's, the dense
  engine's and the JAX engine's (GQA float, MLA, int8-KV), with the
  reference's spill / swap-in counts, and the program budget holds.
"""

import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover - minimal images use the shim
    from _hypothesis_shim import given, settings, st

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

torch = pytest.importorskip("torch")

from _torch_parity import numpy_tree, one_torch_thread  # noqa: E402, F401
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ServeConfig as JServeConfig  # noqa: E402
from repro.core import precision as JP  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import precision as P  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.serve.kv_cache import CacheManager  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "granite-8b"
PAGE = 8
TIER_KW = dict(kv_pages=13, kv_prefix_cache=True, kv_preemption=True)
#: the trace's pool: tight, so evictions (spills) and repeat hits are common
TRACE_KW = dict(kv_pages=7, kv_host_pages=6)
#: the trace's recurring tenants: two-page preambles
TENANTS = ([0, 1, 2, 0, 1, 2, 0, 1], [2, 2, 1, 0, 0, 1, 1, 2], [1, 0, 2, 2, 0, 0, 1, 1])
KV8 = (P.PrecisionPolicy("kv8", (P.Rule("kv_cache", P.int8(per_channel=False)),)),
       JP.PrecisionPolicy("kv8", (JP.Rule("kv_cache", JP.int8(per_channel=False)),)))


# ------------------------------------------------------- the manager ---


def _managers(**kw):
    base = dict(max_batch=4, max_seq_len=32, kv_layout="paged", kv_page_size=4, kv_pages=10,
                kv_prefix_cache=True, kv_host_pages=5)
    base.update(kw)
    return (CacheManager(get_config(ARCH, reduced=True), ServeConfig(**base), device="cpu"),
            jkv.CacheManager(jax_get_config(ARCH, reduced=True), JServeConfig(**base)))


def _state(mgr):
    return dict(
        table=mgr._table.tolist(), ref=mgr._page_ref.tolist(), free=list(mgr._free),
        cached=list(mgr._cached), slot_pages=[list(p) for p in mgr._slot_pages],
        reserved=list(mgr._slot_reserved), keys=[list(k) for k in mgr._slot_keys],
        index=dict(mgr._prefix_index), copies=list(mgr._pending_copies),
        host_index=dict(mgr._host_index), host_free=list(mgr._host_free),
        spills=list(mgr._pending_spills), swap_ins=list(mgr._pending_swap_ins),
        swap_by_page=dict(mgr._swap_in_by_page),
        stats={k: v for k, v in mgr.stats().as_dict().items() if k != "swap_latency_s"},
    )


def _pools(ours, jcaches, mgr_ours, mgr_ref):
    for name in ("k", "v"):
        np.testing.assert_array_equal(ours["layers"][name].numpy()[:, 1:],
                                      np.asarray(jcaches["layers"][name])[:, 1:], err_msg=name)
        held = sorted(mgr_ref._host_key)  # ring slots that hold a chain's rows
        np.testing.assert_array_equal(mgr_ours._host_pool[name].numpy()[:, held],
                                      mgr_ref._host_pool[name][:, held], err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_manager_trace_with_the_tier_matches_reference(seed):
    ours, ref = _managers(**TRACE_KW)
    rng = np.random.default_rng(seed)
    init = np.random.default_rng(seed + 50)
    tcaches, jcaches = ours.init_device_caches(), ref.init_device_caches()
    for n in ("k", "v"):
        v = init.normal(size=tuple(tcaches["layers"][n].shape)).astype(np.float32)
        tcaches["layers"][n].copy_(torch.from_numpy(v))
        jcaches = {"layers": {**jcaches["layers"], n: jnp.asarray(v)}}
    live: dict[int, dict] = {}
    for _ in range(120):
        op = rng.integers(0, 5)
        if op == 0 and len(live) < 4:
            slot = next(i for i in range(4) if i not in live)
            donor = live[list(live)[0]]["tokens"] if live else []
            kind = rng.integers(0, 4)
            if kind == 1 and donor:
                tokens = donor[:max(1, len(donor) // 2)] + [int(t) for t in rng.integers(0, 3, 3)]
            elif kind >= 2:  # a tenant's two-page preamble again: often spilled by now
                tokens = TENANTS[int(rng.integers(0, len(TENANTS)))] + [
                    int(t) for t in rng.integers(0, 3, int(rng.integers(1, 4)))]
            else:
                tokens = [int(t) for t in rng.integers(0, 3, int(rng.integers(1, 16)))]
            reserve = min(len(tokens) + int(rng.integers(1, 8)), 32)
            m_ours, m_ref = ours.match_prefix(tokens), ref.match_prefix(tokens)
            assert (m_ours.pages, m_ours.keys) == (m_ref.pages, m_ref.keys)
            lazy = bool(m_ours) and bool(rng.integers(0, 2))
            wf = min(m_ours.tokens, len(tokens) - 1) if lazy else len(tokens)
            need = ours.admission_need(m_ours, reserve, wf)
            assert need == ref.admission_need(m_ref, reserve, wf)
            if ours.can_reserve(need):
                for mgr, m in ((ours, m_ours), (ref, m_ref)):
                    mgr.admit(slot, tokens, reserve, match=m, lazy_tail=lazy, write_from=wf)
                live[slot] = {"tokens": list(tokens), "pos": wf, "reserve": reserve}
        elif op == 1 and live:
            slot = int(rng.choice(list(live)))
            st_ = live[slot]
            upto = min(st_["pos"] + int(rng.integers(1, 4)), st_["reserve"])
            if upto > st_["pos"]:
                for mgr in (ours, ref):
                    mgr.ensure(slot, upto, write_from=st_["pos"])
                st_["tokens"] += [int(t) for t in
                                  rng.integers(0, 3, max(upto - len(st_["tokens"]), 0))]
                st_["pos"] = upto
        elif op == 2 and live:
            slot = int(rng.choice(list(live)))
            for mgr in (ours, ref):
                mgr.register_filled(slot, live[slot]["tokens"], live[slot]["pos"])
        elif op == 3 and live:
            slot = int(rng.choice(list(live)))
            for mgr in (ours, ref):
                mgr.free(slot)
            del live[slot]
        else:  # a dispatch's host_prep: swaps, copies, table
            ours.write_table(ours.flush_copies(ours.flush_swaps(tcaches)))
            jcaches = ref.write_table(ref.flush_copies(ref.flush_swaps(jcaches)))
            _pools(tcaches, jcaches, ours, ref)
        assert _state(ours) == _state(ref)
        # the reference's own check flags one legal state (a spill whose
        # chain is matched again before a flush: its ring slot in transit to
        # the swap-in) that the port's accepts; its state equals the port's
        ours.check_invariants()
    stats = ours.stats()
    assert stats.swap_outs > 0 and stats.swap_ins > 0  # the trace moved rows both ways


def test_flush_moves_rows_bitwise():
    """A registered page evicted under pressure spills its rows to the ring
    at the next flush; a later hit on its chain swaps those rows, bit for
    bit, into a fresh page."""
    ours, _ = _managers(max_batch=2, kv_pages=4, kv_host_pages=2)
    caches = ours.init_device_caches()
    for n in ("k", "v"):
        caches["layers"][n].copy_(torch.randn(caches["layers"][n].shape))
    prompt = [1, 2, 0, 1]  # one full page
    ours.admit(0, prompt, 5)
    page = ours._slot_pages[0][0]
    rows = {n: caches["layers"][n][:, page].clone() for n in ("k", "v")}
    ours.free(0)  # retained on the LRU
    ours.admit(1, [2] * 12, 12)  # takes every page: the prefix page spills
    assert ours.stats().swap_outs == 1 and ours._pending_spills
    ours.flush_swaps(caches)
    host = ours._host_index[ours._key_intern[(0, tuple(prompt))]]
    for n in ("k", "v"):
        assert torch.equal(ours._host_pool[n][:, host], rows[n])
        caches["layers"][n][:, page] = 0.0  # the page's new owner overwrites it
    ours.free(1)
    match = ours.match_prefix(prompt)
    assert match.host_hits == 1
    ours.admit(0, prompt, 5, match=match, lazy_tail=True, write_from=3)
    dst = ours._slot_pages[0][0]
    ours.flush_swaps(caches)
    for n in ("k", "v"):
        assert torch.equal(caches["layers"][n][:, dst], rows[n])
    assert ours.stats().swap_ins == 1
    ours.check_invariants()


def _trace_with_tier(pool_pages, page_size, seed, host_pages):
    """The engine's calling discipline on the port's manager with the tier
    live and real device flushes; invariants after every op."""
    cfg = get_config(ARCH, reduced=True)
    max_seq = page_size * 8
    sc = ServeConfig(max_batch=4, max_seq_len=max_seq, kv_layout="paged", kv_page_size=page_size,
                     kv_pages=pool_pages, kv_prefix_cache=True, kv_host_pages=host_pages)
    mgr = CacheManager(cfg, sc, device="cpu")
    caches = mgr.init_device_caches()
    rng = np.random.default_rng(seed)
    live: dict[int, dict] = {}
    for _ in range(40):
        op = rng.integers(0, 5)
        if op == 0 and len(live) < sc.max_batch:
            slot = next(i for i in range(sc.max_batch) if i not in live)
            n = int(rng.integers(1, max_seq // 2))
            if live and rng.integers(0, 2):
                donor = live[list(live)[0]]["tokens"]
                tokens = donor[:max(1, n // 2)] + [int(t) for t in rng.integers(0, 5, max(1, n // 2))]
            else:
                tokens = [int(t) for t in rng.integers(0, 5, n)]
            reserve = min(len(tokens) + int(rng.integers(1, 16)), max_seq)
            match = mgr.match_prefix(tokens)
            lazy = bool(match) and len(tokens) > 1 and bool(rng.integers(0, 2))
            wf = min(match.tokens, len(tokens) - 1) if lazy else len(tokens)
            if mgr.can_reserve(mgr.admission_need(match, reserve, wf)):
                mgr.admit(slot, tokens, reserve, match=match, lazy_tail=lazy, write_from=wf)
                live[slot] = {"tokens": list(tokens), "pos": wf, "reserve": reserve}
        elif op == 1 and live:
            slot = int(rng.choice(list(live)))
            state = live[slot]
            upto = min(state["pos"] + int(rng.integers(1, 4)), state["reserve"])
            if upto > state["pos"]:
                mgr.ensure(slot, upto, write_from=state["pos"])
                state["tokens"] += [int(t) for t in
                                    rng.integers(0, 5, max(upto - len(state["tokens"]), 0))]
                state["pos"] = upto
        elif op == 2 and live:
            slot = int(rng.choice(list(live)))
            mgr.register_filled(slot, live[slot]["tokens"], live[slot]["pos"])
        elif op == 3 and live:
            slot = int(rng.choice(list(live)))
            mgr.free(slot)
            del live[slot]
        else:
            caches = mgr.flush_copies(mgr.flush_swaps(caches))
        mgr.check_invariants()
    for slot in list(live):
        mgr.free(slot)
    mgr.check_invariants()
    assert mgr.pages_in_use == 0


@settings(max_examples=10, deadline=None)
@given(st.integers(6, 16), st.sampled_from([2, 4]), st.integers(0, 10_000),
       st.sampled_from([2, 6, 12]))
def test_manager_invariants_with_victim_tier(pool, page_size, seed, host):
    _trace_with_tier(pool, page_size, seed, host)


def test_invariant_checker_catches_two_tier_booking():
    sc = ServeConfig(max_batch=2, max_seq_len=32, kv_layout="paged", kv_page_size=8, kv_pages=8,
                     kv_prefix_cache=True, kv_host_pages=4)
    mgr = CacheManager(get_config(ARCH, reduced=True), sc, device="cpu")
    mgr.admit(0, list(range(8)), 16)
    mgr.register_filled(0, list(range(8)), 8)
    key = mgr._page_key[mgr._slot_pages[0][0]]
    mgr.check_invariants()
    host = mgr._host_free.pop()
    mgr._host_index[key] = host
    mgr._host_key[host] = key
    with pytest.raises(AssertionError, match="both tiers"):
        mgr.check_invariants()


# ------------------------------------------------------------ the engine ---


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in (ARCH, "minicpm3-4b"):
        jcfg = jax_get_config(arch, reduced=True)
        raw = numpy_tree(jlm.param_spec(jcfg), 11)
        out[arch] = (jcfg, jax.tree.map(jnp.asarray, raw), get_config(arch, reduced=True),
                     params_from_numpy(raw, "cpu"))
    return out


def _serve(layout, **kw):
    base = dict(max_batch=2, max_seq_len=64, kv_layout=layout, kv_page_size=PAGE, decode_steps=3)
    base.update(kw)
    return base


def _tenant_waves(eng, vocab, waves=6, n_new=6, seed=5):
    """Four tenants' 3-page preambles in waves of two through one engine:
    with 12 usable pages two residents fill the pool, so each wave evicts
    the last tenants' preamble pages, and the next visit swaps them back
    (tier on) or recomputes them (tier off)."""
    rng = np.random.default_rng(seed)
    preambles = [[int(t) for t in rng.integers(0, vocab, 3 * PAGE)] for _ in range(4)]
    outs = []
    for wave in range(waves):
        handles = [eng.submit(preambles[(wave * 2 + j) % 4]
                              + [int(t) for t in rng.integers(0, vocab, 4)],
                              max_new_tokens=n_new) for j in range(2)]
        res = eng.generate()
        outs.extend(res[h.uid].generated for h in handles)
        if eng.serve_cfg.kv_layout == "paged":
            eng.executor.cache_mgr.check_invariants()
    return outs


KEYS = ("swap_outs", "swap_ins", "host_evictions", "host_pages_used", "prefill_tokens_saved",
        "prefix_hits", "page_evictions", "prefill_dispatches", "extend_dispatches")


def test_victim_tier_swap_back_restores_prefix_hits(models):
    """Tier off, every tenant prefix is lost between visits; tier on, the
    majority of spills swap back, more prefill tokens are saved, and the
    greedy streams are the tier-off engine's and the JAX engine's, with the
    reference's tier counters."""
    jcfg, jparams, cfg, params = models[ARCH]
    off = Engine(cfg, params, ServeConfig(**_serve("paged", **TIER_KW)), device="cpu")
    on = Engine(cfg, params, ServeConfig(**_serve("paged", kv_host_pages=32, **TIER_KW)),
                device="cpu")
    ref = JEngine(jcfg, jparams, JServeConfig(**_serve("paged", kv_host_pages=32, **TIER_KW)))
    off_out = _tenant_waves(off, cfg.vocab_size)
    on_out = _tenant_waves(on, cfg.vocab_size)
    assert on_out == off_out == _tenant_waves(ref, cfg.vocab_size)
    t_on, t_off, t_ref = on.telemetry, off.telemetry, ref.telemetry
    assert t_off["swap_outs"] == 0 and t_off["swap_ins"] == 0
    assert t_on["swap_outs"] > 0 and t_on["swap_ins"] / t_on["swap_outs"] > 0.5
    assert t_on["prefill_tokens_saved"] > t_off["prefill_tokens_saved"]
    assert {k: t_on[k] for k in KEYS} == {k: t_ref[k] for k in KEYS}
    assert t_on["host_pages_used"] > 0 and t_on["swap_latency_s"] >= 0.0


@pytest.mark.parametrize("arch,policy", [(ARCH, None), ("minicpm3-4b", None), (ARCH, "kv8")],
                         ids=["gqa", "mla", "int8kv"])
def test_victim_tier_token_identity_across_datapaths(models, arch, policy):
    """Swap-back restores the rows on every datapath the cache serves (GQA
    float, MLA latent pools, int8 codes with their scale pools): the paged
    engine with the tier equals the dense engine and the JAX engine."""
    jcfg, jparams, cfg, params = models[arch]
    ours_pol, ref_pol = KV8 if policy else (None, None)
    kw = dict(kv_host_pages=32, **TIER_KW)
    eng = Engine(cfg, params, ServeConfig(**_serve("paged", policy=ours_pol, **kw)), device="cpu")
    paged = _tenant_waves(eng, cfg.vocab_size, waves=4)
    dense = _tenant_waves(Engine(cfg, params, ServeConfig(**_serve("dense", policy=ours_pol)),
                                 device="cpu"), cfg.vocab_size, waves=4)
    ref = JEngine(jcfg, jparams, JServeConfig(**_serve("paged", policy=ref_pol, **kw)))
    assert paged == dense == _tenant_waves(ref, cfg.vocab_size, waves=4)
    tel = eng.telemetry
    assert tel["swap_ins"] > 0 and tel["swap_ins"] == ref.telemetry["swap_ins"]
    eng.executor.cache_mgr.check_invariants()


def test_program_budget_with_victim_tier(models):
    """Tier movement is host bookkeeping plus copies outside the programs:
    with spills and swap-backs live, at most len(buckets) prefill shapes,
    one decode and one extend shape."""
    _, _, cfg, params = models[ARCH]
    eng = Engine(cfg, params, ServeConfig(**_serve("paged", prefill_buckets=(8, 16, 32),
                                                   kv_host_pages=32, **TIER_KW)), device="cpu")
    _tenant_waves(eng, cfg.vocab_size)
    tel = eng.telemetry
    assert tel["swap_ins"] > 0
    assert tel["prefill_compiles"] <= 3 and tel["decode_compiles"] == 1
    assert tel["extend_compiles"] <= 1
