"""Gradients of the port against ``jax.grad`` of the JAX package.

- ``models.physics.loss_fn`` per leaf for the three encoders under
  ``float``, ``qat_fixed<12,6>`` and ``paper_vu13p``, and ``models.lm.loss_fn``
  for the reduced dense configs with ``remat`` none and full, on the same
  parameters (numpy from a seed) and the same inputs: max |Δ| within
  1e-5 · max(1, max |g|) per leaf (float32 sums in other orders).  In LUT
  attention dQ = dK = 0, so the ``wq`` / ``wk`` gradients are exactly 0.
- The two ``torch.autograd.Function``s (``kernels/flash_attention/autograd``,
  ``kernels/layernorm/autograd``) with the plain version injected as their
  forward: their torch-op backward against torch autograd through
  ``mha_ref`` / ``layernorm_ref`` and against ``jax.grad`` of the reference's
  ``mha`` / norms, over GQA, causal, window, ``kv_len``, head_dim 8/80/128,
  ``lut``, LN/RMS, the LUT 1/√, no beta and bf16 x.
- The shared guard that makes the kernels without a backward raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

from _torch_parity import numpy_params, numpy_tree, one_torch_thread  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import layernorm as jln  # noqa: E402
from repro.kernels.flash_attention import ops as jfa  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import physics as jphys  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import require_no_grad  # noqa: E402
from repro_torch.kernels.flash_attention import autograd as fa_grad  # noqa: E402
from repro_torch.kernels.flash_attention import mha, mha_ref  # noqa: E402
from repro_torch.kernels.layernorm import autograd as ln_grad  # noqa: E402
from repro_torch.kernels.layernorm import layernorm_ref  # noqa: E402
from repro_torch.models import lm, physics  # noqa: E402
from repro_torch.train import value_and_grad  # noqa: E402

REL = 1e-5


def _assert_grads_close(ours, ref, path="", rel=REL):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), path
        for k in ref:
            _assert_grads_close(ours[k], ref[k], f"{path}/{k}", rel)
        return
    g, r = ours.detach().float().numpy(), np.asarray(ref, np.float32)
    assert g.shape == r.shape, path
    bound = rel * max(1.0, float(np.abs(r).max()))
    err = float(np.abs(g - r).max())
    assert err <= bound, f"{path}: max |d| {err:.3e} > {bound:.3e}"


def _physics_grads(jcfg, tcfg, params, tparams, x, y):
    """(loss, grads, dloss/dx) of both packages on events (x, y)."""
    (jl, _), (jg, jdx) = jax.jit(jax.value_and_grad(
        lambda p, xx: jphys.loss_fn(p, jcfg, {"x": xx, "y": y}), argnums=(0, 1),
        has_aux=True))(params, x)
    xt = torch.from_numpy(x).requires_grad_()
    (tl, _), tg = value_and_grad(physics.loss_fn, tparams, tcfg, {"x": xt, "y": y},
                                 device="cpu")
    (tdx,) = torch.autograd.grad(physics.loss_fn(tparams, tcfg, {"x": xt, "y": y},
                                                 device="cpu")[0], xt)
    return (float(jl), jg, np.asarray(jdx)), (float(tl), tg, tdx.numpy())


@pytest.mark.parametrize("name", ["engine_anomaly", "btagging", "gw"])
@pytest.mark.parametrize("policy", ["float", "qat_fixed<12,6>", "paper_vu13p"])
def test_physics_loss_grads_match_jax(name, policy):
    """Per-leaf gradients of the loss on 16 events, at 1e-5 · max(1, max |g|).

    The fixed-point policies round activations onto a 2^-6 grid, and
    ``paper_vu13p`` also looks up its softmax and norm tables by rounding.
    Where the two packages' float orders put a value within an ulp of a
    rounding tie, they pick neighbouring levels or entries (the forward's
    known flips, which ``test_torch_physics.py`` holds to 1e-3), and every
    gradient flowing through that event moves with it.  The loss is a mean
    over independent events, so such events are found by their own input
    gradient dloss/dx (or logits) disagreeing beyond 1e-5; the parameter
    gradients of the remaining events are held to 1e-5 · max(1, max |g|)
    per leaf, and those of all 16 to 1e-3.  LUT attention must give
    dQ = dK = 0 exactly, as ``jax.grad`` does."""
    jcfg = dataclasses.replace(jax_get_config(name), precision=policy)
    tcfg = dataclasses.replace(get_config(name), precision=policy)
    params = numpy_params(jcfg, seed=len(name))
    tparams = params_from_numpy(params, "cpu")
    x, y = physics_data(name)
    (jl, jg, jdx), (tl, tg, tdx) = _physics_grads(jcfg, tcfg, params, tparams, x, y)
    dx_bound = REL * float(np.abs(jdx).max())
    moved = np.abs(jdx - tdx).reshape(len(x), -1).max(-1) > dx_bound
    if policy == "float":
        assert not moved.any()
        np.testing.assert_allclose(tl, jl, rtol=REL)
        _assert_grads_close(tg, jg)
    else:  # at most a quarter of the events at a tie; the rest exact to 1e-5
        assert moved.mean() <= 0.25, f"{moved.sum()} of {len(x)} events moved"
        np.testing.assert_allclose(tl, jl, rtol=1e-3)
        _assert_grads_close(tg, jg, rel=1e-3)
        (jl, jg, _), (tl, tg, _) = _physics_grads(jcfg, tcfg, params, tparams, x[~moved],
                                                  y[~moved])
        np.testing.assert_allclose(tl, jl, rtol=REL)
        _assert_grads_close(tg, jg)
    if policy == "paper_vu13p":  # LUT attention: dQ = dK = 0 exactly, as jax.grad gives
        for w in ("wq", "wk"):
            assert np.all(np.asarray(jg["blocks"]["attn"][w]["kernel"]) == 0)
            assert torch.all(tg["blocks"]["attn"][w]["kernel"] == 0)
        assert torch.any(tg["blocks"]["attn"]["wv"]["kernel"] != 0)


def physics_data(name, n=16):
    from repro_torch.data import GENERATORS

    return GENERATORS[name](n, seed=11)


@pytest.mark.parametrize("name", ["granite-8b", "minicpm-2b", "starcoder2-7b"])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_lm_loss_grads_match_jax(name, remat):
    jcfg = jax_get_config(name, reduced=True)
    tcfg = get_config(name, reduced=True)
    params = numpy_tree(jlm.param_spec(jcfg), seed=3)
    # starcoder2-7b-reduced has a window of 8: 24 tokens exercise the window mask
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32),
             "loss_mask": (rng.random((2, 24)) < 0.8).astype(np.float32)}
    (jl, jm), jg = jax.jit(
        jax.value_and_grad(lambda p, b: jlm.loss_fn(p, jcfg, b, remat=remat), has_aux=True)
    )(params, batch)
    (tl, tm), tg = value_and_grad(lm.loss_fn, params_from_numpy(params, "cpu"), tcfg, batch,
                                  remat=remat, device="cpu")
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in ("ce_loss", "accuracy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    _assert_grads_close(tg, jg)


def test_remat_minimal_matches_none():
    tcfg = get_config("granite-8b", reduced=True)
    params = params_from_numpy(numpy_tree(jlm.param_spec(jax_get_config("granite-8b", True)),
                                          seed=4), "cpu")
    batch = {"tokens": np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 16))}
    (l0, _), g0 = value_and_grad(lm.loss_fn, params, tcfg, batch, device="cpu")
    (l1, _), g1 = value_and_grad(lm.loss_fn, params, tcfg, batch, remat="minimal", device="cpu")
    assert float(l0) == float(l1)
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=1e-7), g0, g1)
    with pytest.raises(ValueError, match="remat"):
        lm.loss_fn(params, tcfg, batch, remat="everything", device="cpu")


# --- the autograd.Functions' backward formulas --------------------------------

def _mha_plain(q, k, v, **kw):
    return mha_ref(q, k, v, **kw)


ATT_CASES = [  # (b, hq, hkv, lq = lkv, d, causal, window, kv_len, mode)
    (2, 4, 4, 12, 8, False, None, None, "safe"),
    (2, 4, 2, 12, 8, True, None, None, "safe"),  # GQA, causal
    (1, 8, 2, 20, 80, True, 6, None, "safe"),  # head_dim 80 (zero-padded on the card), window
    (1, 4, 1, 16, 128, False, None, 11, "safe"),  # head_dim 128, kv_len padding
    (2, 2, 2, 10, 8, True, 3, 7, "safe"),  # window and kv_len: some rows see no key
    (2, 4, 2, 12, 8, False, None, None, "lut"),
    (1, 4, 2, 16, 16, True, 5, 13, "lut"),
]


def _qkv(b, hq, hkv, l, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, l, d)).astype(np.float32),
            rng.normal(size=(b, hkv, l, d)).astype(np.float32),
            rng.normal(size=(b, hkv, l, d)).astype(np.float32),
            rng.normal(size=(b, hq, l, d)).astype(np.float32))


@pytest.mark.parametrize("case", ATT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_function_backward_matches_autograd_and_jax(case):
    b, hq, hkv, l, d, causal, window, kv_len, mode = case
    qn, kn, vn, don = _qkv(b, hq, hkv, l, d, seed=d + l)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    kw = dict(causal=causal, window=window, mode=mode, kv_len=kv_len)
    out = fa_grad.attention(q, k, v, forward=_mha_plain, **kw)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(don))
    # torch autograd through the plain version (None: the LUT index carries none)
    ref = torch.autograd.grad(mha_ref(q, k, v, **kw), (q, k, v), torch.from_numpy(don),
                              allow_unused=True)
    ref = [torch.zeros_like(t) if r is None else r for t, r in zip((q, k, v), ref)]
    # jax.grad of the reference's mha (its plain jnp path; kv_len as an explicit mask)
    assert kv_len is None or kv_len <= l

    def jloss(q, k, v):
        if kv_len is None:
            o = jfa.mha(q, k, v, causal=causal, window=window, mode=mode)
        else:
            g = hq // hkv
            from repro.kernels.flash_attention.ref import attention_ref
            o = attention_ref(q, jnp.repeat(k, g, 1), jnp.repeat(v, g, 1), scale=1 / d ** 0.5,
                              causal=causal, window=window, mode=mode, kv_len=kv_len)
        return jnp.sum(o * don)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(qn, kn, vn)
    for name, g, r, j in zip("qkv", grads, ref, jg):
        scale = max(1.0, float(np.abs(np.asarray(j)).max()))
        torch.testing.assert_close(g, r, rtol=0, atol=REL * scale, msg=f"d{name} vs autograd")
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0, atol=REL * scale,
                                   err_msg=f"d{name} vs jax.grad")
    if mode == "lut":
        assert torch.all(grads[0] == 0) and torch.all(grads[1] == 0)
        assert np.all(np.asarray(jg[0]) == 0) and np.all(np.asarray(jg[1]) == 0)
        assert torch.any(grads[2] != 0)


# (b, hq, hkv, l, d, dv, causal, window, kv_len, mode): V at a head_dim of its
# own, as MLA's prefill attend (q/k 96, V 64)
ATT_DV_CASES = [
    (2, 4, 2, 12, 96, 64, True, None, None, "safe"),  # GQA, causal
    (1, 4, 4, 16, 96, 64, False, 5, 11, "safe"),  # window, kv_len
    (1, 4, 2, 16, 96, 64, True, None, 13, "lut"),
]


@pytest.mark.parametrize("case", ATT_DV_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_function_backward_at_a_v_head_dim_of_its_own(case):
    """``attention_backward`` and ``Attention`` with dv != d: the gradients
    equal torch autograd through the plain version within 1e-5 max(1, max
    |g|)."""
    b, hq, hkv, l, d, dv, causal, window, kv_len, mode = case
    qn, kn, vn, don = _qkv(b, hq, hkv, l, d, seed=d + dv + l)
    vn, don = vn[..., :dv].copy(), don[..., :dv].copy()
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    kw = dict(causal=causal, window=window, mode=mode, kv_len=kv_len)
    out = fa_grad.attention(q, k, v, forward=_mha_plain, **kw)
    assert out.shape == (b, hq, l, dv)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(don))
    ref = torch.autograd.grad(mha_ref(q, k, v, **kw), (q, k, v), torch.from_numpy(don),
                              allow_unused=True)
    ref = [torch.zeros_like(t) if r is None else r for t, r in zip((q, k, v), ref)]
    for name, g, r in zip("qkv", grads, ref):
        assert g.shape == r.shape
        scale = max(1.0, float(r.abs().max()))
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5 * scale, msg=f"d{name} vs autograd")
    assert torch.any(grads[2] != 0)


def test_attention_backward_of_rows_that_see_no_key():
    """A safe row that sees no key (window 3 ending before kv_len 7: row 9)
    has the plain version's uniform P: dV takes its share of dO, dQ and its
    dK terms are 0.  The backward rebuilds P from the inputs and reads the
    forward's output only through delta, which the mask zeroes on such a
    row: its gradients do not depend on what the forward stored there."""
    qn, kn, vn, don = _qkv(2, 2, 2, 10, 8, seed=5)
    q, k, v, do = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    kw = dict(causal=True, window=3, mode="safe", kv_len=7)
    out = mha_ref(q, k, v, **kw)
    torch.testing.assert_close(out[:, :, 9], v.mean(dim=2), atol=1e-6, rtol=0)
    grads = fa_grad.attention_backward(q, k, v, out, do, **kw)
    zeroed = out.clone()
    zeroed[:, :, 9] = 0.0  # what the kernel stored there before it took the mean of V
    for g, z in zip(grads, fa_grad.attention_backward(q, k, v, zeroed, do, **kw)):
        assert torch.equal(g, z)
    assert torch.all(grads[0][:, :, 9] == 0)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    ref = torch.autograd.grad(mha_ref(qg, kg, vg, **kw), (qg, kg, vg), do)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)


def test_attention_backward_needs_no_plain_forward(monkeypatch):
    """The backward rebuilds P from its formula; it never calls ``mha_ref``."""
    qn, kn, vn, don = _qkv(1, 2, 1, 8, 8, seed=0)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    out = fa_grad.attention(q, k, v, causal=True, forward=_mha_plain)
    from repro_torch.kernels.flash_attention import ref as fa_ref

    def forbidden(*a, **k):
        raise AssertionError("the backward called the plain forward")

    monkeypatch.setattr(fa_ref, "mha_ref", forbidden)
    monkeypatch.setattr(fa_ref, "attention_ref", forbidden)
    out.backward(torch.from_numpy(don))
    assert q.grad is not None and torch.any(q.grad != 0)


def test_mha_on_cpu_is_the_plain_version_with_its_autograd():
    qn, kn, vn, don = _qkv(1, 2, 2, 6, 8, seed=1)
    q = torch.from_numpy(qn).requires_grad_()
    out = mha(q, torch.from_numpy(kn), torch.from_numpy(vn), causal=True)
    assert out.grad_fn is not None and "Attention" not in type(out.grad_fn).__name__


def _ln_plain(x, gamma, beta, use_lut, rms, eps):
    return layernorm_ref(x, gamma, beta, use_lut=use_lut, rms=rms, eps=eps)


LN_CASES = [  # (rows, k, rms, use_lut, beta, x dtype)
    (24, 32, False, False, True, "float32"),
    (24, 64, False, True, True, "float32"),
    (24, 32, False, False, False, "float32"),  # beta=None
    (24, 48, True, False, False, "float32"),
    (24, 48, True, True, False, "float32"),
    (24, 32, False, False, True, "bfloat16"),  # bf16 x, float32 params
    (24, 64, True, False, False, "bfloat16"),
]


@pytest.mark.parametrize("case", LN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_layernorm_function_backward_matches_autograd_and_jax(case):
    rows, k, rms, use_lut, has_beta, dtype = case
    rng = np.random.default_rng(rows + k)
    xn = (2.0 * rng.normal(size=(rows, k)) + 0.5).astype(np.float32)
    gn = (1 + 0.2 * rng.normal(size=k)).astype(np.float32)
    bn = rng.normal(size=k).astype(np.float32)
    don = rng.normal(size=(rows, k)).astype(np.float32)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(xn).to(tdt).requires_grad_()
    gamma = torch.from_numpy(gn).requires_grad_()
    beta = torch.from_numpy(bn).requires_grad_() if has_beta and not rms else None
    eps = 1e-6 if rms else 1e-5
    ins = [t for t in (x, gamma, beta) if t is not None]
    out = ln_grad.layernorm(x, gamma, beta, use_lut=use_lut, rms=rms, eps=eps, forward=_ln_plain)
    do = torch.from_numpy(don).to(tdt)
    grads = torch.autograd.grad(out, ins, do)
    ref = torch.autograd.grad(
        layernorm_ref(x, gamma, beta, use_lut=use_lut, rms=rms, eps=eps), ins, do)
    for g, r, t in zip(grads, ref, ins):
        assert g.dtype == t.dtype
        if t.dtype == torch.bfloat16:  # one bf16 rounding of the same float32 value
            torch.testing.assert_close(g.float(), r.float(), rtol=1e-2, atol=1e-2)
        else:
            torch.testing.assert_close(g, r, rtol=0, atol=REL * max(1.0, float(r.abs().max())))
    if dtype == "float32":  # jax.grad of the reference's jnp norms
        def jloss(x, gamma, beta):
            if rms:
                o = jln.rmsnorm(x, gamma, eps=eps, use_lut=use_lut)
            else:
                o = jln.layernorm_paper(x, gamma, beta, eps=eps, use_lut=use_lut)
            return jnp.sum(o * don)

        jg = jax.grad(jloss, argnums=(0, 1, 2))(xn, gn, bn if beta is not None else np.zeros_like(bn))
        for g, j in zip(grads, jg):
            np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                       atol=REL * max(1.0, float(np.abs(np.asarray(j)).max())))
    if use_lut and not rms:  # the 1/sqrt lookup is constant, the mean path carries dx
        assert torch.any(grads[0] != 0)


# --- the guard of the kernels without a backward --------------------------------

@pytest.mark.parametrize("kernel,item", [("lut_softmax", "item 9"), ("qmatmul", "item 9")])
def test_require_no_grad_names_the_roadmap_item(kernel, item):
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match=f"{kernel} kernel has no backward.*{item}"):
        require_no_grad(kernel, x)
    with torch.no_grad():
        require_no_grad(kernel, x)
    require_no_grad(kernel, x.detach(), None, torch.ones(2, dtype=torch.int8))
