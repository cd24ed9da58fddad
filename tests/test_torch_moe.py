"""The port's MoE family (``repro_torch.models.moe``, the ``moe`` block kind,
``lm.forward``'s summed router aux, the granite-moe-3b-a800m and dbrx-132b
configs) against the JAX package, on the same parameters (numpy from a seed,
``params_from_numpy``) and the same inputs.

Tolerances: ``moe_apply`` outputs within 1e-5 (float32 sums in other
orders), the router aux losses within 1e-6 relative, ``moe_dropped_frac``
equal and the same (token, expert) entries dropped; the LM's logits within
2e-4 (the dense LM tests') and greedy tokens identical;
``apply_plan_to_params(int8_serve)`` on MoE parameters bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import numpy_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.core import softmax as jsm  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import precision  # noqa: E402
from repro_torch.models import blocks, lm, moe  # noqa: E402
from repro_torch.models import params as params_lib  # noqa: E402

MOE = ["granite-moe-3b-a800m", "dbrx-132b"]
ATOL, AUX_RTOL, LM_ATOL = 1e-5, 1e-6, 2e-4


def _configs(name, **moe_overrides):
    jcfg, tcfg = jax_get_config(name, reduced=True), get_config(name, reduced=True)
    if moe_overrides:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_overrides))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe_overrides))
    return jcfg, tcfg


def _reference_drops(jcfg, params, x):
    """The reference's dropped (token, expert) pairs: its own routing and
    sort-based dispatch, line for line (``repro.models.moe.moe_apply``)."""
    m = jcfg.moe
    flat = jnp.asarray(x).reshape(-1, x.shape[-1])
    t = flat.shape[0]
    logits = jlayers.dense(params["router"], flat.astype(jnp.float32), None)
    _, ids = jax.lax.top_k(jsm.softmax_paper_exact(logits, axis=-1), m.top_k)
    cap = int(max(1, round(t * m.top_k / m.n_experts * m.capacity_factor)))
    flat_expert = ids.reshape(-1)
    order = jnp.argsort(flat_expert, stable=True)
    counts = jnp.bincount(flat_expert, length=m.n_experts)
    rank = jnp.arange(t * m.top_k) - (jnp.cumsum(counts) - counts)[flat_expert[order]]
    token = jnp.repeat(jnp.arange(t), m.top_k)[order]
    drop = np.asarray(rank >= cap)
    return {(int(a), int(b)) for a, b in zip(np.asarray(token)[drop],
                                              np.asarray(flat_expert[order])[drop])}


def _ours_drops(tcfg, params, x):
    flat = torch.from_numpy(x).reshape(-1, x.shape[-1])
    _, _, ids, _ = moe.route(params, tcfg, flat)
    _, keep = moe.dispatch(tcfg, ids, moe.capacity(tcfg, flat.shape[0]))
    tok = torch.arange(flat.shape[0])[:, None].expand_as(ids)
    return {(int(a), int(b)) for a, b in zip(tok[~keep], ids[~keep])}


def _check(jcfg, tcfg, raw, x):
    jout, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, raw), jcfg, jnp.asarray(x))
    tparams = params_from_numpy(raw, "cpu")
    out, aux = moe.moe_apply(tparams, tcfg, torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    assert set(aux) == set(jaux)
    assert float(aux["moe_dropped_frac"]) == float(jaux["moe_dropped_frac"])
    for k in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=AUX_RTOL, atol=0)
    drops = _ours_drops(tcfg, tparams, x)
    assert drops == _reference_drops(jcfg, raw, x)
    return drops, aux


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_apply_matches_reference(name, cf):
    """The published capacity factor and a tight one (drops guaranteed)."""
    jcfg, tcfg = _configs(name, capacity_factor=cf)
    raw = numpy_tree(jmoe.moe_spec(jcfg), 3)
    x = np.random.default_rng(4).normal(size=(3, 21, jcfg.d_model)).astype(np.float32)
    drops, _ = _check(jcfg, tcfg, raw, x)
    if cf < 1:
        assert drops


def test_capacity_drops_tokens():
    """``tests/test_moe.py::test_capacity_drops_tokens``' setting: dbrx
    reduced at d 16, 4 experts top-2 of d_expert 24, capacity factor 0.25,
    32 tokens; drops happen and match the reference's entry for entry."""
    jcfg, tcfg = _configs("dbrx-132b", n_experts=4, top_k=2, d_expert=24, capacity_factor=0.25)
    jcfg, tcfg = (dataclasses.replace(c, d_model=16) for c in (jcfg, tcfg))
    raw = numpy_tree(jmoe.moe_spec(jcfg), 5)
    x = np.random.default_rng(6).normal(size=(2, 16, 16)).astype(np.float32)
    drops, aux = _check(jcfg, tcfg, raw, x)
    assert drops and float(aux["moe_dropped_frac"]) > 0
    assert moe.capacity(tcfg, 32) == 4


def test_router_tie_breaks_to_the_lower_expert():
    """A zero router kernel gives every expert the same probability: top-k
    must take experts 0..k-1 in order (``jax.lax.top_k``'s lower index
    first), and so must a tie between two of several distinct values."""
    jcfg, tcfg = _configs("granite-moe-3b-a800m")
    raw = numpy_tree(jmoe.moe_spec(jcfg), 7)
    raw["router"]["kernel"][:] = 0.0
    x = np.random.default_rng(8).normal(size=(1, 6, jcfg.d_model)).astype(np.float32)
    _check(jcfg, tcfg, raw, x)
    _, _, ids, gates = moe.route(params_from_numpy(raw, "cpu"), tcfg,
                                 torch.from_numpy(x).reshape(6, -1))
    assert ids.tolist() == [[0, 1]] * 6 and torch.equal(gates, torch.full((6, 2), 0.5))
    # experts 1 and 3 tie for the top: a one-hot input picks router row 0
    raw["router"]["kernel"][0] = [0.0, 2.0, 1.0, 2.0]
    x = np.zeros((1, 3, jcfg.d_model), np.float32)
    x[..., 0] = 1.0
    _check(jcfg, tcfg, raw, x)
    _, _, ids, _ = moe.route(params_from_numpy(raw, "cpu"), tcfg, torch.from_numpy(x[0]))
    assert ids.tolist() == [[1, 3]] * 3


@pytest.mark.parametrize("t", [1, 2, 3, 7, 8, 12, 13, 48, 96, 16384])
@pytest.mark.parametrize("name", MOE)
def test_capacity_is_the_reference_expression(name, t):
    """Python's ``round`` (half to even) on t * k / e * cf, at least 1: the
    engine's t counts a prefill bucket's pad tokens and decode's idle slots."""
    full = get_config(name)
    m = full.moe
    assert moe.capacity(full, t) == int(max(1, round(t * m.top_k / m.n_experts
                                                    * m.capacity_factor)))
    assert m.capacity_factor == 1.25 and m.router_aux_weight == 0.01
    assert m.router_z_weight == 1e-3


def test_dispatch_is_the_reference_sort_rank():
    """Ranks by the cumulative count equal the reference's stable-sort ranks
    on random routings with heavy collisions."""
    rng = np.random.default_rng(9)
    tcfg = get_config("dbrx-132b", reduced=True)
    e, k = tcfg.moe.n_experts, tcfg.moe.top_k
    ids = np.stack([rng.permutation(e)[:k] for _ in range(50)])
    for cap in (1, 3, 10, 100):
        slot, keep = moe.dispatch(tcfg, torch.from_numpy(ids), cap)
        flat = ids.reshape(-1)
        order = np.argsort(flat, kind="stable")
        counts = np.bincount(flat, minlength=e)
        rank_sorted = np.arange(flat.size) - (np.cumsum(counts) - counts)[flat[order]]
        rank = np.empty_like(rank_sorted)
        rank[order] = rank_sorted
        want_keep = (rank < cap).reshape(ids.shape)
        assert np.array_equal(keep.numpy(), want_keep)
        want = np.where(want_keep, ids * cap + rank.reshape(ids.shape), e * cap)
        assert np.array_equal(slot.numpy(), want)


@pytest.mark.parametrize("name", MOE)
def test_lm_forward_and_aux_match_reference(name):
    """The MoE LM's forward: logits within 2e-4 and the aux, summed over the
    layers, equal to the reference's (losses within 1e-6 relative, the
    dropped share equal); the block kind is ``moe``."""
    jcfg, tcfg = _configs(name)
    raw = numpy_tree(jlm.param_spec(jcfg), 10)
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size, (2, 19)).astype(np.int32)
    jlogits, _, jaux = jlm.forward(jax.tree.map(jnp.asarray, raw), jcfg,
                                   {"tokens": jnp.asarray(toks)})
    logits, _, aux = lm.forward(params_from_numpy(raw, "cpu"), tcfg, {"tokens": toks},
                                device="cpu")
    assert blocks.block_kind(tcfg) == "moe"
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LM_ATOL, rtol=0)
    assert set(aux) == set(jaux)
    assert aux["text_offset"] == jaux["text_offset"] == 0
    assert float(aux["moe_dropped_frac"]) == float(jaux["moe_dropped_frac"])
    for k in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=AUX_RTOL, atol=0)


@pytest.mark.parametrize("name", MOE)
def test_greedy_prefill_decode_match_reference(name):
    """``lm.prefill`` then 6 greedy ``decode_step``s on float32 caches: the
    logits within 2e-4 and the tokens identical.  Decode routes one token per
    sequence: its capacity is that of t = batch."""
    jcfg, tcfg = _configs(name)
    raw = numpy_tree(jlm.param_spec(jcfg), 12)
    jp = jax.tree.map(jnp.asarray, raw)
    tp = params_from_numpy(raw, "cpu")
    b, s, steps, max_len = 3, 10, 6, 20
    prompt = np.random.default_rng(13).integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    last, caches = lm.prefill(tp, tcfg, {"tokens": prompt},
                              lm.init_caches(tcfg, b, max_len, torch.float32, device="cpu"),
                              device="cpu")
    jlast, jcaches = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                                 jlm.init_caches(jcfg, b, max_len, dtype=jnp.float32))
    for i in range(steps):
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=LM_ATOL, rtol=0)
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        jtok = jnp.argmax(jlast, -1)[:, None].astype(jnp.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        pos = np.full((b,), s + i, np.int32)
        last, caches = lm.decode_step(tp, tcfg, tok, pos, caches, device="cpu")
        jlast, jcaches = jlm.decode_step(jp, jcfg, jtok, jnp.asarray(pos), jcaches)


@pytest.mark.parametrize("name", MOE)
def test_apply_plan_int8_serve_is_bitwise_on_moe_params(name):
    """The plan's per-channel int8 rule on the stacked (L, E, d, ff) expert
    leaves: per layer, the channel axis is the last, so the amax reduces over
    (E, d) and the experts share one scale per output column, as in the
    reference (ROADMAP queue 3 records it as the reference's property)."""
    jcfg, tcfg = _configs(name)
    raw = numpy_tree(jlm.param_spec(jcfg), 14)
    plan = precision.get_policy("int8_serve").resolve(tcfg.n_layers)
    jplan = jprec.get_policy("int8_serve").resolve(jcfg.n_layers)
    assert plan.int8_weights and plan.int8_kv_cache and plan.lut_softmax
    assert (plan.int8_weights, plan.int8_kv_cache, plan.lut_softmax) == (
        jplan.int8_weights, jplan.int8_kv_cache, jplan.lut_softmax)
    ours = precision.apply_plan_to_params(params_from_numpy(raw, "cpu"), plan)
    ref = jprec.apply_plan_to_params(jax.tree.map(jnp.asarray, raw), jplan)

    def walk(a, b, path=()):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                walk(a[k], b[k], path + (k,))
            return
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg="/".join(path))

    walk(ours, ref)
    w = ours["blocks"]["ffn"]["w_up"][0]  # (E, d, ff): a shared scale per column
    e, d, ff = w.shape
    col = w.reshape(e * d, ff)
    scale = col.abs().amax(0) / 127
    torch.testing.assert_close(col / scale, torch.round(col / scale), atol=1e-3, rtol=0)


@pytest.mark.parametrize("name", MOE)
def test_params_carry_across_and_init_uses_fan_in_on_axis_minus_2(name):
    """``params_from_numpy`` keeps the stacked (L, E, d, ff) leaves as they
    are; the port's init draws them at 1/sqrt(d) (fan-in on axis -2, the
    reference's rule for leaves of rank 3 or more)."""
    jcfg, tcfg = _configs(name)
    raw = numpy_tree(jlm.param_spec(jcfg), 15)
    tp = params_from_numpy(raw, "cpu")
    spec = lm.param_spec(tcfg)
    e, d, ff = tcfg.moe.n_experts, tcfg.d_model, tcfg.moe.d_expert
    assert spec["blocks"]["ffn"]["w_up"].shape == (tcfg.n_layers, e, d, ff)
    assert spec["blocks"]["ffn"]["w_down"].shape == (tcfg.n_layers, e, ff, d)
    jshapes = jax.tree.map(lambda s: s.shape, jparams.abstract_params(jlm.param_spec(jcfg)))
    tshapes = params_lib.map_leaves(lambda _, s: s.shape, spec)
    assert tshapes == jshapes
    for key in ("w_up", "w_gate", "w_down"):
        assert np.array_equal(tp["blocks"]["ffn"][key].numpy(), raw["blocks"]["ffn"][key])
    big = dataclasses.replace(tcfg, d_model=256, moe=dataclasses.replace(tcfg.moe, d_expert=512))
    init = lm.init_params(big, torch.Generator().manual_seed(0), device="cpu")
    for key, fan_in in (("w_up", 256), ("w_gate", 256), ("w_down", 512)):
        std = float(init["blocks"]["ffn"][key].std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.01, (key, std)


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("reduced", [False, True])
def test_moe_configs_equal_reference(name, reduced):
    ref, ours = jax_get_config(name, reduced), get_config(name, reduced)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.padded_vocab_size == ref.padded_vocab_size
    assert ours.serve_policy == "int8_serve"


def test_loss_fn_raises_naming_its_item():
    """``lm.loss_fn``'s MoE aux losses are ported: the total is the cross
    entropy plus the router's aux and z losses from ``forward``'s aux, and
    the loss, the metrics and the gradients equal ``jax.value_and_grad`` of
    the reference's ``loss_fn`` (loss within 1e-5, each gradient leaf within
    1e-5 max(1, max |g|), as tests/test_torch_train_grads.py)."""
    from repro_torch.train import value_and_grad

    jcfg, tcfg = _configs("granite-moe-3b-a800m")
    params = numpy_tree(jlm.param_spec(jcfg), 19)
    batch = {"tokens": np.random.default_rng(20).integers(0, jcfg.vocab_size,
                                                          (2, 12)).astype(np.int32)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, jcfg, b),
                                              has_aux=True))(params, batch)
    (tl, tm), tg = value_and_grad(lm.loss_fn, params_from_numpy(params, "cpu"), tcfg, batch,
                                  device="cpu")
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert set(tm) == set(jm) == {"ce_loss", "accuracy", "loss", "moe_aux_loss", "moe_z_loss",
                                  "moe_dropped_frac"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(tm["loss"]), float(tm["ce_loss"] + tm["moe_aux_loss"]
                                                        + tm["moe_z_loss"]), rtol=1e-6)

    def close(ours, ref, path=""):
        if isinstance(ref, dict):
            for k in ref:
                close(ours[k], ref[k], f"{path}/{k}")
            return
        r = np.asarray(ref)
        np.testing.assert_allclose(ours.detach().numpy(), r, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(r).max())), err_msg=path)

    close(tg, jg)
    assert float(tg["blocks"]["ffn"]["router"]["kernel"].abs().max()) > 0
