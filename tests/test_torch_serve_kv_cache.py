"""The port's paged KV layout and ``CacheManager`` (``repro_torch.serve.
kv_cache``) against the JAX package's (``repro.serve.kv_cache``).

- The paged spec, ``paged_decode_write`` / ``paged_decode_view``,
  ``mask_cache_tail`` and ``insert_prefill_dense`` / ``_paged`` give exactly
  the reference's tensors on the same numpy inputs (the trash page 0 aside:
  pad rows all write it, in an order neither scatter defines, and it is
  never read).
- One seeded op trace (admit with and without a prefix hit, ensure with
  copy-on-write, register, free, flush) through both managers leaves equal
  page tables, refcounts, prefix indices, pending copies, ``stats()`` and,
  after each flush, equal device pools; ``check_invariants`` holds after
  every op.
- The same device ops over MLA's latent pools (num_pages, page_size,
  width) and their per-token scale pools, which have no head axis; the
  manager's copy-on-write over them, float and int8, with
  ``check_invariants``.
- The manager-level tests of ``tests/test_prefix_cache.py`` and
  ``tests/test_kv_cache.py`` that do not need the victim tier, ported: the
  random-trace invariant property, the checker catching corruption, CoW
  purge on free, revived cached pages charged at admission, the intern
  table's garbage collection, page bookkeeping and validation.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover - minimal images use the shim
    from _hypothesis_shim import given, settings, st

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.serve import kv_cache as kvc  # noqa: E402
from repro_torch.serve.kv_cache import CacheManager  # noqa: E402

ARCH = "granite-8b"
MLA = "minicpm3-4b"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _equal(ours, ref, skip_trash=False):
    ours, ref = _np(ours), _np(ref)
    assert set(ours) == set(ref)
    for k in ours:
        if isinstance(ours[k], dict):
            _equal(ours[k], ref[k], skip_trash)
            continue
        a, b = ours[k], ref[k]
        if skip_trash and k != "page_table":  # pools: (L, P, ...), page 0 is the trash page
            a, b = a[:, 1:], b[:, 1:]
        np.testing.assert_array_equal(a, b, err_msg=k)


def _manager(pkg, arch=ARCH, quantized=False, **kw):
    base = dict(max_batch=4, max_seq_len=32, kv_layout="paged", kv_page_size=4,
                kv_pages=18, kv_prefix_cache=True)
    base.update(kw)
    if pkg == "jax":
        return jkv.CacheManager(jax_get_config(arch, reduced=True), JServeConfig(**base),
                                quantized=quantized)
    return CacheManager(get_config(arch, reduced=True), ServeConfig(**base),
                        quantized=quantized, device="cpu")


# ---------------------------------------------------------------- specs ---


def test_paged_spec_matches_reference():
    jcfg, tcfg = jax_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    ours = kvc.abstract_caches(tcfg, 4, 64, torch.float32, layout="paged", page_size=16,
                               num_pages=9)
    ref = jkv.abstract_caches(jcfg, 4, 64, jnp.float32, layout="paged", page_size=16,
                              num_pages=9)
    assert set(ours["layers"]) == set(ref["layers"]) == {"k", "v", "page_table"}
    for name, (shape, dtype) in ours["layers"].items():
        assert shape == ref["layers"][name].shape
        assert str(dtype).split(".")[-1] == str(ref["layers"][name].dtype)
    caches = kvc.init_caches(tcfg, 4, 64, torch.float32, device="cpu", layout="paged",
                             page_size=16, num_pages=9)
    _equal(caches, jkv.init_caches(jcfg, 4, 64, jnp.float32, layout="paged", page_size=16,
                                   num_pages=9))


def test_paged_spec_rejects_unpageable():
    win = get_config("starcoder2-7b", reduced=True)
    with pytest.raises(ValueError, match="sliding-window"):
        kvc.attention_cache_spec(win, 2, 64, layout="paged", page_size=16, num_pages=9)
    ssm = get_config("mamba2-130m", reduced=True)
    with pytest.raises(ValueError, match="position-addressed"):
        kvc.attention_cache_spec(ssm, 2, 64, layout="paged", page_size=16, num_pages=9)
    # the quantized paged spec is ported: the reference's, scale pools
    # head-major (the MLA latent pools: tests/test_torch_mla.py); a hybrid
    # model's caches ignore the layout, as the reference's: the Mamba2 state
    # and the shared block's dense K/V
    ours = kvc.attention_cache_spec(get_config(ARCH, reduced=True), 2, 64, quantized=True,
                                    layout="paged", page_size=16, num_pages=9)
    ref = jkv.attention_cache_spec(jax_get_config(ARCH, reduced=True), 2, 64, quantized=True,
                                   layout="paged", page_size=16, num_pages=9)
    assert {k: (shape, str(dt).removeprefix("torch.")) for k, (shape, dt) in ours.items()} == {
        k: (s.shape, str(s.dtype)) for k, s in ref.items()}
    zamba = get_config("zamba2-1.2b", reduced=True)
    ours = kvc.abstract_caches(zamba, 2, 64, quantized=True, layout="paged", page_size=16,
                               num_pages=9)
    ref = jkv.abstract_caches(jax_get_config("zamba2-1.2b", reduced=True), 2, 64,
                              quantized=True, layout="paged", page_size=16, num_pages=9)
    assert {g: {k: (shape, str(dt).removeprefix("torch.")) for k, (shape, dt) in leaves.items()}
            for g, leaves in ours.items()} == {
        g: {k: (s.shape, str(s.dtype)) for k, s in leaves.items()} for g, leaves in ref.items()}
    assert set(ours) == {"layers", "shared"} and "page_table" not in ours["layers"]


# ------------------------------------------------------------ device ops ---


def _paged_layer(rng, b=3, hkv=2, ps=4, pages=10, per_slot=4, d=8):
    pool = rng.normal(size=(pages, hkv, ps, d)).astype(np.float32)
    table = np.zeros((b, per_slot), np.int32)
    perm = rng.permutation(np.arange(1, pages))
    table[0, :3] = perm[:3]
    table[1, :2] = perm[3:5]  # slot 2 retired: all-trash row
    return {"k": pool, "v": pool * 2, "page_table": table}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_decode_write_and_view_match_reference(seed):
    rng = np.random.default_rng(seed)
    layer = _paged_layer(rng)
    b, hkv, _, d = 3, *layer["k"].shape[1:2], 4, layer["k"].shape[3]
    upd = {n: rng.normal(size=(b, hkv, d)).astype(np.float32) for n in ("k", "v")}
    positions = np.array([rng.integers(0, 12), rng.integers(0, 8), 5], np.int32)
    ours = kvc.paged_decode_write({k: _t(v) for k, v in layer.items()},
                                  {k: _t(v) for k, v in upd.items()}, _t(positions))
    ref = jkv.paged_decode_write({k: jnp.asarray(v) for k, v in layer.items()},
                                 {k: jnp.asarray(v) for k, v in upd.items()},
                                 jnp.asarray(positions))
    _equal(ours, ref, skip_trash=False)
    view = kvc.paged_decode_view(ours)
    assert all(t.is_contiguous() for t in view.values())
    _equal(view, jkv.paged_decode_view(ref))


def test_paged_roundtrip_write_view():
    """paged_decode_write then paged_decode_view reads back exactly what
    was written at each slot's logical position."""
    cfg = get_config(ARCH, reduced=True)
    cache = kvc.init_attention_cache(cfg, batch=2, max_len=32, dtype=torch.float32,
                                     device="cpu", layout="paged", page_size=8, num_pages=9)
    cache["page_table"] = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0]], dtype=torch.int32)
    rng = np.random.default_rng(0)
    hd = cfg.resolved_head_dim
    k_new = _t(rng.normal(size=(2, cfg.n_kv_heads, hd)).astype(np.float32))
    v_new = _t(rng.normal(size=(2, cfg.n_kv_heads, hd)).astype(np.float32))
    out = kvc.paged_decode_write(cache, {"k": k_new, "v": v_new},
                                 torch.tensor([3, 11], dtype=torch.int32))
    assert out is cache  # in place
    view = kvc.paged_decode_view(cache)
    assert view["k"].shape == (2, cfg.n_kv_heads, 32, hd)
    assert torch.equal(view["k"][0, :, 3], k_new[0])
    assert torch.equal(view["k"][1, :, 11], k_new[1])
    assert torch.equal(view["v"][1, :, 11], v_new[1])
    assert float(view["k"][0, :, 4:].abs().max()) == 0.0
    assert float(view["k"][1, :, :11].abs().max()) == 0.0


def _filled(rng, n_layers=2, n=4, hkv=2, length=16, d=8):
    return {"layers": {name: rng.normal(size=(n_layers, n, hkv, length, d)).astype(np.float32)
                       for name in ("k", "v")}}


def test_mask_cache_tail_matches_reference():
    rng = np.random.default_rng(3)
    filled = _filled(rng)
    filled["layers"]["slot_pos"] = rng.integers(0, 9, (2, 4, 16)).astype(np.int32)
    lengths = np.array([16, 3, 0, 9], np.int32)
    ours = kvc.mask_cache_tail({"layers": {k: _t(v) for k, v in filled["layers"].items()}},
                               _t(lengths))
    ref = jkv.mask_cache_tail({"layers": {k: jnp.asarray(v)
                                          for k, v in filled["layers"].items()}},
                              jnp.asarray(lengths))
    _equal(ours, ref)


def test_insert_prefill_dense_matches_reference():
    rng = np.random.default_rng(4)
    big = _filled(rng, n=4)
    small = _filled(rng, n=3)
    slots = np.array([2, 4, 0], np.int32)  # 4 = max_batch: the pad sentinel
    ours = kvc.insert_prefill_dense({"layers": {k: _t(v) for k, v in big["layers"].items()}},
                                    {"layers": {k: _t(v) for k, v in small["layers"].items()}},
                                    slots)
    ref = jkv.insert_prefill_dense(
        {"layers": {k: jnp.asarray(v) for k, v in big["layers"].items()}},
        {"layers": {k: jnp.asarray(v) for k, v in small["layers"].items()}},
        jnp.asarray(slots))
    _equal(ours, ref)


@pytest.mark.parametrize("shared", [None, [0, 0, 0], [1, 0, 2]])
def test_insert_prefill_paged_matches_reference(shared):
    rng = np.random.default_rng(5)
    n_layers, b, ps, pages, per_slot = 2, 3, 4, 14, 4
    pools = {n: rng.normal(size=(n_layers, pages, 2, ps, 8)).astype(np.float32)
             for n in ("k", "v")}
    table = np.zeros((b, per_slot), np.int32)
    table[0] = [3, 5, 7, 0]
    table[1, :2] = [1, 2]
    table[2] = [9, 10, 11, 12]
    big = {"layers": {**pools, "page_table": np.broadcast_to(table, (n_layers, b, per_slot))}}
    small = _filled(rng, n_layers=n_layers, n=3, length=12)  # 3 pages of the scratch
    slots = np.array([0, 3, 2], np.int32)  # 3 = max_batch: a pad row
    sh = None if shared is None else np.array(shared, np.int32)
    ours = kvc.insert_prefill_paged(
        {"layers": {k: _t(v) for k, v in big["layers"].items()}},
        {"layers": {k: _t(v) for k, v in small["layers"].items()}},
        slots, ps, None if sh is None else _t(sh))
    ref = jkv.insert_prefill_paged(
        {"layers": {k: jnp.asarray(v) for k, v in big["layers"].items()}},
        {"layers": {k: jnp.asarray(v) for k, v in small["layers"].items()}},
        jnp.asarray(slots), ps, None if sh is None else jnp.asarray(sh))
    _equal(ours, ref, skip_trash=True)


def _latent_layer(rng, b=3, ps=4, pages=10, per_slot=4, width=24):
    """An int8 latent pool with its per-token scale pool, and a table like
    ``_paged_layer``'s."""
    table = _paged_layer(rng, b=b, ps=ps, pages=pages, per_slot=per_slot)["page_table"]
    return {"latent": rng.integers(-128, 128, (pages, ps, width)).astype(np.int8),
            "latent_scale": rng.uniform(0.01, 1.0, (pages, ps)).astype(np.float32),
            "page_table": table}


@pytest.mark.parametrize("seed", [0, 1])
def test_latent_paged_decode_write_and_view_match_reference(seed):
    """One token per slot into the latent pools (no head axis), then the
    gathered (B, L, width) / (B, L) views, against the reference."""
    rng = np.random.default_rng(seed)
    layer = _latent_layer(rng)
    b, width = 3, layer["latent"].shape[-1]
    upd = {"latent": rng.integers(-128, 128, (b, width)).astype(np.int8),
           "latent_scale": rng.uniform(0.01, 1.0, (b,)).astype(np.float32)}
    positions = np.array([rng.integers(0, 12), rng.integers(0, 8), 5], np.int32)
    ours = kvc.paged_decode_write({k: _t(v) for k, v in layer.items()},
                                  {k: _t(v) for k, v in upd.items()}, _t(positions))
    ref = jkv.paged_decode_write({k: jnp.asarray(v) for k, v in layer.items()},
                                 {k: jnp.asarray(v) for k, v in upd.items()},
                                 jnp.asarray(positions))
    _equal(ours, ref)
    view = kvc.paged_decode_view(ours)
    assert view["latent"].shape == (b, 16, width) and view["latent_scale"].shape == (b, 16)
    assert all(t.is_contiguous() for t in view.values())
    _equal(view, jkv.paged_decode_view(ref))


def _latent_filled(rng, n_layers=2, n=4, length=16, width=24):
    return {"layers": {
        "latent": rng.integers(-128, 128, (n_layers, n, length, width)).astype(np.int8),
        "latent_scale": rng.uniform(0.01, 1.0, (n_layers, n, length)).astype(np.float32)}}


@pytest.mark.parametrize("shared", [None, [1, 0, 2]])
def test_latent_mask_and_insert_match_reference(shared):
    """``mask_cache_tail`` zeroes latent codes and scales past each length;
    ``insert_prefill_dense`` / ``_paged`` scatter both into slots and pages
    (a pad row dropped, shared prefix pages left alone)."""
    rng = np.random.default_rng(6)
    filled = _latent_filled(rng, n=3, length=12)
    lengths = np.array([12, 5, 0], np.int32)
    ours = kvc.mask_cache_tail({"layers": {k: _t(v) for k, v in filled["layers"].items()}},
                               _t(lengths))
    ref = jkv.mask_cache_tail({"layers": {k: jnp.asarray(v)
                                          for k, v in filled["layers"].items()}},
                              jnp.asarray(lengths))
    _equal(ours, ref)
    slots = np.array([0, 3, 2], np.int32)  # 3 = max_batch: a pad row
    big = _latent_filled(rng, n=3, length=12)
    got = kvc.insert_prefill_dense({"layers": {k: _t(v) for k, v in big["layers"].items()}},
                                   {"layers": {k: _t(v) for k, v in filled["layers"].items()}},
                                   slots)
    want = jkv.insert_prefill_dense(
        {"layers": {k: jnp.asarray(v) for k, v in big["layers"].items()}},
        {"layers": {k: jnp.asarray(v) for k, v in filled["layers"].items()}},
        jnp.asarray(slots))
    _equal(got, want)
    n_layers, b, ps, pages, per_slot = 2, 3, 4, 14, 4
    table = np.zeros((b, per_slot), np.int32)
    table[0] = [3, 5, 7, 0]
    table[1, :2] = [1, 2]
    table[2] = [9, 10, 11, 12]
    pools = {"latent": rng.integers(-128, 128, (n_layers, pages, ps, 24)).astype(np.int8),
             "latent_scale": rng.uniform(0.01, 1.0, (n_layers, pages, ps)).astype(np.float32),
             "page_table": np.broadcast_to(table, (n_layers, b, per_slot))}
    sh = None if shared is None else np.array(shared, np.int32)
    got = kvc.insert_prefill_paged({"layers": {k: _t(v) for k, v in pools.items()}},
                                   {"layers": {k: _t(v) for k, v in filled["layers"].items()}},
                                   slots, ps, None if sh is None else _t(sh))
    want = jkv.insert_prefill_paged(
        {"layers": {k: jnp.asarray(v) for k, v in pools.items()}},
        {"layers": {k: jnp.asarray(v) for k, v in filled["layers"].items()}},
        jnp.asarray(slots), ps, None if sh is None else jnp.asarray(sh))
    _equal(got, want, skip_trash=True)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_latent_copy_on_write_flush_matches_reference(quantized):
    """minicpm3-4b's managers (latent pools, float or int8 with the scale
    pool): a full-coverage prefix hit whose first write lands in the shared
    page copies the same page on both sides, ``flush_copies`` copies every
    latent leaf of every layer, and the invariants hold."""
    ours, ref = _manager("torch", MLA, quantized), _manager("jax", MLA, quantized)
    rng = np.random.default_rng(10)
    spec = ref._abstract()["layers"]
    pools = {n: (rng.integers(-128, 128, s.shape).astype(np.int8) if s.dtype == jnp.int8 else
                 rng.normal(size=s.shape).astype(np.float32))
             for n, s in spec.items() if n != "page_table"}
    assert set(pools) == ({"latent", "latent_scale"} if quantized else {"latent"})
    tcaches = ours.init_device_caches()
    for n, v in pools.items():
        tcaches["layers"][n].copy_(_t(v))
    jcaches = {"layers": {**ref.init_device_caches()["layers"],
                          **{n: jnp.asarray(v) for n, v in pools.items()}}}
    prompt = [1, 2, 0, 1, 2, 2, 0, 1]  # two full pages
    for mgr in (ours, ref):
        mgr.admit(0, prompt, 12)
        match = mgr.match_prefix(prompt)
        assert match.tokens == 8
        mgr.admit(1, prompt, 12, match=match, lazy_tail=True, write_from=7)
        mgr.ensure(1, 10, write_from=7)
    assert ours._pending_copies == ref._pending_copies and len(ours._pending_copies) == 1
    (src, dst), = ours._pending_copies
    ours.flush_copies(ours.write_table(tcaches))
    jcaches = ref.write_table(ref.flush_copies(jcaches))
    _equal(tcaches, jcaches)
    for n in pools:
        assert torch.equal(tcaches["layers"][n][:, dst], tcaches["layers"][n][:, src]), n
    assert ours.kv_bytes == ref.kv_bytes
    _assert_same_state(ours, ref)
    ours.check_invariants()


# ------------------------------------------------- the manager vs reference ---


def _state(mgr):
    return dict(
        table=mgr._table.copy(), ref=mgr._page_ref.copy(), free=list(mgr._free),
        cached=list(mgr._cached), slot_pages=[list(p) for p in mgr._slot_pages],
        reserved=list(mgr._slot_reserved), keys=[list(k) for k in mgr._slot_keys],
        index=dict(mgr._prefix_index), copies=list(mgr._pending_copies),
        stats=mgr.stats().as_dict(),
    )


def _assert_same_state(ours, ref):
    a, b = _state(ours), _state(ref)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_manager_trace_matches_reference(seed):
    """A seeded trace of admit (prefix hits lazy or not) / ensure with a
    write range (copy-on-write) / register / free / flush through both
    managers: equal host state after every op, equal device pools after
    every flush, invariants after every op."""
    ours, ref = _manager("torch"), _manager("jax")
    assert ours.kv_bytes == ref.kv_bytes
    rng = np.random.default_rng(seed)
    init = np.random.default_rng(seed + 100)
    pools = {n: init.normal(size=ref._abstract()["layers"][n].shape).astype(np.float32)
             for n in ("k", "v")}
    tcaches = ours.init_device_caches()
    jcaches = ref.init_device_caches()
    for n, v in pools.items():
        tcaches["layers"][n].copy_(_t(v))
        jcaches = {"layers": {**jcaches["layers"], n: jnp.asarray(v)}}
    live: dict[int, dict] = {}
    max_seq, vocab = 32, 3
    for _ in range(100):
        op = rng.integers(0, 5)
        if op == 0 and len(live) < 4:
            slot = next(i for i in range(4) if i not in live)
            n = int(rng.integers(1, max_seq // 2))
            kind = rng.integers(0, 3) if live else 0
            donor = live[list(live)[0]]["tokens"] if live else []
            if kind == 1:  # shares a prefix with a resident
                tokens = donor[: max(1, n // 2)] + [int(t) for t in
                                                      rng.integers(0, vocab, max(1, n // 2))]
            elif kind == 2 and len(donor) >= 4:  # its whole pages: a full-coverage hit
                tokens = donor[: len(donor) // 4 * 4]
            else:
                tokens = [int(t) for t in rng.integers(0, vocab, n)]
            reserve = min(len(tokens) + int(rng.integers(1, 16)), max_seq)
            m_ours, m_ref = ours.match_prefix(tokens), ref.match_prefix(tokens)
            assert (m_ours.pages, m_ours.keys, m_ours.tokens) == (m_ref.pages, m_ref.keys,
                                                                  m_ref.tokens)
            lazy = bool(m_ours) and len(tokens) > 1 and (kind == 2 or bool(rng.integers(0, 2)))
            wf = min(m_ours.tokens, len(tokens) - 1) if lazy else len(tokens)
            need = ours.admission_need(m_ours, reserve, wf)
            assert need == ref.admission_need(m_ref, reserve, wf)
            assert ours.can_reserve(need) == ref.can_reserve(need)
            if ours.can_reserve(need):
                for mgr, m in ((ours, m_ours), (ref, m_ref)):
                    mgr.admit(slot, tokens, reserve, match=m, lazy_tail=lazy, write_from=wf)
                live[slot] = {"tokens": list(tokens), "pos": wf, "reserve": reserve}
        elif op == 1 and live:
            slot = int(rng.choice(list(live)))
            state = live[slot]
            upto = min(state["pos"] + int(rng.integers(1, 4)), state["reserve"])
            if upto > state["pos"]:
                for mgr in (ours, ref):
                    mgr.ensure(slot, upto, write_from=state["pos"])
                state["tokens"] += [int(t) for t in
                                    rng.integers(0, vocab, max(upto - len(state["tokens"]), 0))]
                state["pos"] = upto
        elif op == 2 and live:
            slot = int(rng.choice(list(live)))
            for mgr in (ours, ref):
                mgr.register_filled(slot, live[slot]["tokens"], live[slot]["pos"])
        elif op == 3 and live:
            slot = int(rng.choice(list(live)))
            for mgr in (ours, ref):
                mgr.free(slot)
            del live[slot]
        else:
            ours.write_table(tcaches)
            ours.flush_copies(tcaches)
            jcaches = ref.write_table(ref.flush_copies(jcaches))
            _equal(tcaches, jcaches)
        _assert_same_state(ours, ref)
        ours.check_invariants()
        ref.check_invariants()
    assert ours.stats().as_dict() == ref.stats().as_dict()


def test_copy_on_write_flush_matches_reference():
    """A full-coverage prefix hit whose first write lands in the shared
    page: both managers copy-on-write the same pages, and the flushed
    device pools are equal."""
    ours, ref = _manager("torch"), _manager("jax")
    rng = np.random.default_rng(9)
    pools = {n: rng.normal(size=ref._abstract()["layers"][n].shape).astype(np.float32)
             for n in ("k", "v")}
    tcaches = ours.init_device_caches()
    for n, v in pools.items():
        tcaches["layers"][n].copy_(_t(v))
    jcaches = {"layers": {**ref.init_device_caches()["layers"],
                          **{n: jnp.asarray(v) for n, v in pools.items()}}}
    prompt = [1, 2, 0, 1, 2, 2, 0, 1]  # two full pages
    for mgr in (ours, ref):
        mgr.admit(0, prompt, 12)
        match = mgr.match_prefix(prompt)
        assert match.tokens == 8
        mgr.admit(1, prompt, 12, match=match, lazy_tail=True, write_from=7)
        mgr.ensure(1, 10, write_from=7)  # position 7 is in the shared page 2
    assert ours._pending_copies == ref._pending_copies and len(ours._pending_copies) == 1
    ours.flush_copies(ours.write_table(tcaches))
    jcaches = ref.write_table(ref.flush_copies(jcaches))
    _equal(tcaches, jcaches)
    src, dst = ref.stats().cow_copies, ours.stats().cow_copies
    assert src == dst == 1
    _assert_same_state(ours, ref)
    ours.check_invariants()


# ------------------------------- ported from test_prefix_cache / test_kv_cache ---


def _trace_manager(pool_pages, page_size, seed):
    """One random op trace against the port's paged manager with the
    prefix cache on, in the engine's calling discipline, with the pool
    invariants asserted after every operation."""
    cfg = get_config(ARCH, reduced=True)
    max_seq = page_size * 8
    sc = ServeConfig(max_batch=4, max_seq_len=max_seq, kv_layout="paged",
                     kv_page_size=page_size, kv_pages=pool_pages, kv_prefix_cache=True)
    mgr = CacheManager(cfg, sc, device="cpu")
    rng = np.random.default_rng(seed)
    live: dict[int, dict] = {}
    vocab = 5  # tiny vocab makes shared prefixes common
    for _ in range(40):
        op = rng.integers(0, 5)
        if op == 0 and len(live) < sc.max_batch:
            slot = next(i for i in range(sc.max_batch) if i not in live)
            n = int(rng.integers(1, max_seq // 2))
            if live and rng.integers(0, 2):
                donor = live[list(live)[0]]["tokens"]
                tokens = donor[: max(1, n // 2)] + list(rng.integers(0, vocab, max(1, n // 2)))
            else:
                tokens = list(rng.integers(0, vocab, n))
            reserve = min(len(tokens) + int(rng.integers(1, 16)), max_seq)
            match = mgr.match_prefix(tokens)
            lazy = bool(match) and len(tokens) > 1 and rng.integers(0, 2)
            wf = min(match.tokens, len(tokens) - 1) if lazy else len(tokens)
            need = mgr.admission_need(match, reserve, wf)
            if mgr.can_reserve(need):
                mgr.admit(slot, tokens, reserve, match=match, lazy_tail=lazy, write_from=wf)
                live[slot] = {"tokens": list(tokens), "pos": wf, "reserve": reserve}
        elif op == 1 and live:
            slot = int(rng.choice(list(live)))
            state = live[slot]
            upto = min(state["pos"] + int(rng.integers(1, 4)), state["reserve"])
            if upto > state["pos"]:
                mgr.ensure(slot, upto, write_from=state["pos"])
                grow = max(upto - len(state["tokens"]), 0)
                state["tokens"] += list(rng.integers(0, vocab, grow))
                state["pos"] = upto
        elif op == 2 and live:
            slot = int(rng.choice(list(live)))
            mgr.register_filled(slot, live[slot]["tokens"], live[slot]["pos"])
        elif op == 3 and live:
            slot = int(rng.choice(list(live)))
            mgr.free(slot)
            del live[slot]
        else:  # the device side is exercised by the engine tests
            mgr._pending_copies.clear()
        mgr.check_invariants()
    for slot in list(live):
        mgr.free(slot)
    mgr.check_invariants()
    assert mgr.pages_in_use == 0
    st_ = mgr.stats()
    assert st_.pages_cached + len(mgr._free) == st_.pages_capacity


@settings(max_examples=20, deadline=None)
@given(
    st.integers(6, 24),   # pool pages (incl. trash)
    st.sampled_from([2, 4, 8]),  # page size
    st.integers(0, 10_000),      # trace seed
)
def test_manager_invariants_under_random_traces(pool, page_size, seed):
    _trace_manager(pool, page_size, seed)


def test_invariant_checker_catches_corruption():
    sc = ServeConfig(max_batch=2, max_seq_len=32, kv_layout="paged", kv_page_size=8,
                     kv_pages=8, kv_prefix_cache=True)
    mgr = CacheManager(get_config(ARCH, reduced=True), sc, device="cpu")
    mgr.admit(0, [1, 2, 3], 10)
    mgr.check_invariants()
    mgr._free.append(mgr._slot_pages[0][0])  # double-book: live AND free
    with pytest.raises(AssertionError, match="free list"):
        mgr.check_invariants()


def test_free_purges_pending_cow_copies():
    mgr = _manager("torch", max_batch=2, kv_page_size=8, kv_pages=8)
    first = list(range(8))
    mgr.admit(0, first, 16)
    mgr.register_filled(0, first, 8)
    match = mgr.match_prefix(first)
    assert match.tokens == 8  # full-coverage hit: write lands in-page
    mgr.admit(1, first, 16, match=match, lazy_tail=True, write_from=7)
    mgr.ensure(1, 9, write_from=7)  # write inside the shared page -> CoW
    assert mgr._pending_copies
    mgr.free(1)
    freed = set(mgr._free)
    assert not any(dst in freed for _, dst in mgr._pending_copies)
    mgr.check_invariants()


def test_admission_counts_revived_cached_pages():
    mgr = _manager("torch", max_batch=3, max_seq_len=40, kv_page_size=8, kv_pages=6)
    first = list(range(16))
    mgr.admit(0, first, 16)
    mgr.free(0)  # both pages retained on the cached LRU
    mgr.admit(1, [1, 2, 3, 4, 5, 6, 7, 8], 24)
    match = mgr.match_prefix(first)
    assert len(match.pages) == 2
    need = mgr.admission_need(match, 24, 15)
    assert need == 4
    assert not mgr.can_reserve(need)
    with pytest.raises(RuntimeError, match="cannot reserve"):
        mgr.admit(2, first, 24, match=match, lazy_tail=True, write_from=15)
    mgr.check_invariants()
    mgr.free(1)
    match = mgr.match_prefix(first)
    mgr.admit(2, first, 24, match=match, lazy_tail=True, write_from=15)
    mgr.ensure(2, 24, write_from=15)
    mgr.check_invariants()


def test_chain_key_intern_table_is_garbage_collected():
    mgr = _manager("torch", max_batch=2, kv_page_size=4, kv_pages=5)
    mgr._intern_gc_floor = mgr._intern_gc_at = 8  # frequent sweeps at test scale
    keep = list(range(100, 108))
    mgr.admit(0, keep, 12)
    mgr.free(0)
    for i in range(40):
        tokens = [200 + i] * 4
        match = mgr.match_prefix(tokens)
        if not mgr.can_reserve(mgr.admission_need(match, 8, len(tokens))):
            break
        mgr.admit(1, tokens, 8, match=match)
        mgr.free(1)
        mgr.check_invariants()
    assert len(mgr._key_intern) <= max(16, 4 * (len(mgr._prefix_index) + 1))
    match = mgr.match_prefix(keep + [1, 2])
    if [p for p in mgr._cached if mgr._page_key.get(p)]:
        assert match.tokens in (0, 8)


def test_manager_page_bookkeeping():
    mgr = _manager("torch", max_batch=2, kv_page_size=8, kv_pages=8, kv_prefix_cache=False)
    assert mgr.layout == "paged"
    assert mgr.pages_per_slot == 4 and mgr.pages_capacity == 7
    assert mgr.pages_for(1) == 1 and mgr.pages_for(8) == 1
    assert mgr.pages_for(9) == 2 and mgr.pages_for(32) == 4
    mgr.alloc(0, 9)
    assert mgr.pages_in_use == 2
    assert np.all(mgr._table[0, :2] > 0)  # page 0 is the trash page
    mgr.ensure(0, 17)
    mgr.ensure(0, 17)  # idempotent
    assert mgr.pages_in_use == 3
    mgr.alloc(1, 30)
    assert mgr.pages_in_use == 7
    assert len(set(mgr._table[mgr._table > 0].tolist())) == 7
    mgr.free(0)
    assert mgr.pages_in_use == 4
    assert np.all(mgr._table[0] == kvc.TRASH_PAGE)
    mgr.alloc(0, 24)
    assert mgr.pages_in_use == 7
    with pytest.raises(RuntimeError, match="exhausted"):
        mgr.ensure(0, 32)


def test_manager_validates_page_size_pool_and_the_victim_tier():
    cfg = get_config(ARCH, reduced=True)
    with pytest.raises(ValueError, match="divide"):
        CacheManager(cfg, ServeConfig(max_seq_len=100, kv_layout="paged", kv_page_size=16),
                     device="cpu")
    with pytest.raises(ValueError, match="kv_pages"):
        CacheManager(cfg, ServeConfig(max_seq_len=64, kv_layout="paged", kv_page_size=16,
                                      kv_pages=1), device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        CacheManager(cfg, ServeConfig(kv_layout="interleaved"), device="cpu")
    # the victim tier lives on the paged prefix cache: its rings mirror every
    # pool but the page table, and kv_victim_tier=False keeps it off
    tier = CacheManager(cfg, ServeConfig(max_seq_len=64, kv_layout="paged", kv_prefix_cache=True,
                                         kv_host_pages=16), device="cpu")
    assert tier.victim_tier and tier.host_pages == 16
    assert {n: tuple(r.shape) for n, r in tier._host_pool.items()} == {
        n: (cfg.n_layers, 16) + tuple(tier.init_device_caches()["layers"][n].shape[2:])
        for n in ("k", "v")}
    for kw in (dict(kv_victim_tier=False), dict(kv_prefix_cache=False), dict(kv_layout="dense")):
        sc = dict(dict(max_seq_len=64, kv_layout="paged", kv_prefix_cache=True,
                       kv_host_pages=16), **kw)
        off = CacheManager(cfg, ServeConfig(**sc), device="cpu")
        assert not off.victim_tier and off.stats().host_pages_capacity == 0


def test_page_utilization_guards_zero_capacity_and_bytes_shrink_with_pool():
    row = kvc.CacheStats(layout="dense", kv_bytes=0, page_size=0, pages_in_use=0,
                         pages_capacity=0, page_allocs_total=0, pages_in_use_peak=0)
    assert row.page_utilization == 0.0 and row.prefix_hit_rate == 0.0
    cfg = get_config(ARCH, reduced=True)
    assert CacheManager(cfg, ServeConfig(max_batch=0, max_seq_len=32),
                        device="cpu").stats().page_utilization == 0.0
    dense = CacheManager(cfg, ServeConfig(max_batch=8, max_seq_len=512), device="cpu")
    paged = CacheManager(cfg, ServeConfig(max_batch=8, max_seq_len=512, kv_layout="paged",
                                          kv_page_size=32, kv_pages=33), device="cpu")
    assert paged.kv_bytes < dense.kv_bytes / 3
    assert paged.stats().as_dict()["pages_capacity"] == 32
    ref = jkv.CacheManager(jax_get_config(ARCH, reduced=True),
                           dataclasses.replace(JServeConfig(max_batch=8, max_seq_len=512),
                                               kv_layout="paged", kv_page_size=32, kv_pages=33))
    assert paged.kv_bytes == ref.kv_bytes
