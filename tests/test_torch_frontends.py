"""The port's modality frontends against the JAX package, on the CPU, on
the same parameters (numpy from a seed, carried across with
``params_from_numpy``) and the same inputs:

- hubert-xlarge (the audio encoder: frame embeddings through
  ``frontend_proj``, no token embedding, bidirectional attention) and
  internvl2-1b (the VLM: patch embeddings through ``frontend_proj`` before
  the text tokens, 7 query heads per KV head at full width): parameter trees
  and counts, ``lm.forward`` within 1e-5 of the logits' scale
  max(1, max |logit|), and the text offset;
- internvl2-1b-reduced prefill (image prefix plus text) then decode against
  the one-pass forward at 5e-4, as
  ``tests/test_serving.py::test_prefill_decode_matches_full_forward``, and
  step for step against the JAX package's prefill and decode;
- the plan's ``embed_quant`` reaching ``frontend_proj``;
- ``lm.loss_fn``: the encoder's masked-unit cross entropy over ``labels``,
  the VLM's next-token loss from the text offset on, and the MoE aux and z
  losses, each against ``jax.value_and_grad`` of the reference's
  ``loss_fn``: the loss within 1e-5, the gradients per leaf within
  1e-5 · max(1, max |g|), as ``tests/test_torch_train_grads.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

from _torch_parity import numpy_tree, one_torch_thread  # noqa: E402, F401
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import precision  # noqa: E402
from repro_torch.models import encoder, lm, vlm  # noqa: E402
from repro_torch.train import value_and_grad  # noqa: E402

FRONTENDS = ["hubert-xlarge", "internvl2-1b"]
REL = 1e-5


def _configs(name, policy="float", capacity_factor=None):
    jcfg = dataclasses.replace(jax_get_config(name, reduced=True), precision=policy)
    tcfg = dataclasses.replace(get_config(name, reduced=True), precision=policy)
    if capacity_factor is not None:  # each package's own MoEConfig
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    return jcfg, tcfg


def _params(jcfg, seed):
    """numpy parameters, transformed by the JAX package's precision plan
    (which acts on jax arrays)."""
    raw = jax.tree.map(jnp.asarray, numpy_tree(jlm.param_spec(jcfg), seed))
    plan = jprec.resolve_model_plan(jcfg)
    return jax.tree.map(np.asarray, jprec.apply_plan_to_params(raw, plan))


def _batch(cfg, b, s, seed, labels=False):
    """Frames (audio), patches and tokens (VLM) or tokens, from a seed."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        batch = {"frames": rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32)}
        if labels:
            batch["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            batch["loss_mask"] = (rng.random((b, s)) < 0.6).astype(np.float32)
        return batch
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "patch":
        batch["patches"] = rng.normal(size=(b, cfg.n_frontend_tokens,
                                            cfg.frontend_dim)).astype(np.float32)
    return batch


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _close_lm(ours, ref):
    """Within 1e-5 max(1, max |ref|) leaf by leaf, the vocab padding's -1e9
    left out of the scale."""
    def check(a, b):
        real = np.where(b <= -1e9, 0.0, b)
        np.testing.assert_allclose(a, b, atol=REL * max(1.0, float(np.abs(real).max())), rtol=0)

    jax.tree.map(check, _np(ours), _np(ref))


def _shapes(spec):
    if isinstance(spec, dict):
        return {k: _shapes(v) for k, v in spec.items()}
    return tuple(spec.shape)


# ---------------------------------------------------------------------------
# parameters and the forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FRONTENDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_param_spec_and_count_match_reference(name, reduced):
    jcfg, tcfg = jax_get_config(name, reduced), get_config(name, reduced)
    spec = lm.param_spec(tcfg)
    assert _shapes(spec) == _shapes(jlm.param_spec(jcfg))
    assert lm.count_params(tcfg) == jlm.count_params(jcfg)
    assert ("embed" in spec) == (name == "internvl2-1b")  # the audio encoder has none
    assert _shapes(spec["frontend_proj"])["kernel"] == (tcfg.frontend_dim, tcfg.d_model)
    assert encoder.param_spec is lm.param_spec and vlm.prefill is lm.prefill


@pytest.mark.parametrize("name", FRONTENDS)
@pytest.mark.parametrize("policy", ["float", "int8_serve"])
def test_forward_matches_reference(name, policy):
    jcfg, tcfg = _configs(name, policy)
    params = _params(jcfg, seed=len(name) + len(policy))
    batch = _batch(jcfg, 2, 12, seed=3)
    logits, caches, aux = lm.forward(params_from_numpy(params, "cpu"), tcfg, batch, device="cpu")
    ref, _, jaux = jlm.forward(params, jcfg, jax.tree.map(jnp.asarray, batch))
    n_img = jcfg.n_frontend_tokens if name == "internvl2-1b" else 0
    assert caches is None and aux["text_offset"] == jaux["text_offset"] == n_img
    assert logits.shape == (2, n_img + 12, tcfg.padded_vocab_size)
    _close_lm(logits, ref)


def test_audio_encoder_attends_both_ways():
    """A frame's logits depend on later frames (no causal mask): changing
    the last frame moves the first position's logits, in both packages."""
    jcfg, tcfg = _configs("hubert-xlarge")
    params = _params(jcfg, seed=1)
    tparams = params_from_numpy(params, "cpu")
    batch = _batch(jcfg, 1, 8, seed=2)
    moved = {"frames": batch["frames"].copy()}
    moved["frames"][:, -1] += 1.0
    a = lm.forward(tparams, tcfg, batch, device="cpu")[0]
    b = lm.forward(tparams, tcfg, moved, device="cpu")[0]
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4
    _close_lm(b, jlm.forward(params, jcfg, jax.tree.map(jnp.asarray, moved))[0])


def test_vlm_patches_alone_and_decode_ignores_patches():
    """The VLM's forward on patches without tokens is the image prefix; in
    decode the patches are not read (the prefix lives in the cache)."""
    jcfg, tcfg = _configs("internvl2-1b")
    params = _params(jcfg, seed=4)
    tparams = params_from_numpy(params, "cpu")
    batch = _batch(jcfg, 2, 5, seed=5)
    only = {"patches": batch["patches"]}
    logits, _, aux = lm.forward(tparams, tcfg, only, device="cpu")
    ref, _, jaux = jlm.forward(params, jcfg, jax.tree.map(jnp.asarray, only))
    assert logits.shape[1] == aux["text_offset"] == jaux["text_offset"] == 4
    _close_lm(logits, ref)
    caches = lm.init_caches(tcfg, 2, 16, torch.float32, device="cpu")
    pos = np.full((2,), 9, np.int32)
    a = lm.forward(tparams, tcfg, {"tokens": batch["tokens"][:, :1]}, mode="decode",
                   caches=caches, positions=pos, device="cpu")[0]
    b, _, aux = lm.forward(tparams, tcfg, {"tokens": batch["tokens"][:, :1],
                                           "patches": batch["patches"]}, mode="decode",
                           caches=caches, positions=pos, device="cpu")
    assert torch.equal(a, b) and aux["text_offset"] == 0


def test_vlm_prefill_decode_matches_full_forward():
    """As tests/test_serving.py::test_prefill_decode_matches_full_forward:
    prefill the image prefix and 12 text tokens, decode 4 from position
    n_img + 12, each within 5e-4 of the one-pass forward; and step for step
    within the LM-level tolerance of the JAX package's prefill and decode,
    the caches included."""
    jcfg, tcfg = _configs("internvl2-1b")
    params = _params(jcfg, seed=6)
    tparams = params_from_numpy(params, "cpu")
    b, s, extra, off = 2, 12, 4, jcfg.n_frontend_tokens
    batch = _batch(jcfg, b, s + extra, seed=7)
    toks = batch["tokens"]
    full, _, _ = lm.forward(tparams, tcfg, batch, device="cpu")
    pre = {"patches": batch["patches"], "tokens": toks[:, :s]}
    caches = lm.init_caches(tcfg, b, off + s + extra, torch.float32, device="cpu")
    jcaches = jlm.init_caches(jcfg, b, off + s + extra, dtype=jnp.float32)
    last, caches = lm.prefill(tparams, tcfg, pre, caches, device="cpu")
    jlast, jcaches = jlm.prefill(params, jcfg, jax.tree.map(jnp.asarray, pre), jcaches)
    torch.testing.assert_close(last, full[:, off + s - 1], atol=5e-4, rtol=0)
    _close_lm(last, jlast)
    _close_lm(caches, jcaches)
    assert float(caches["layers"]["k"][:, :, :, off + s - 1].abs().max()) > 0
    for i in range(extra):
        pos = np.full((b,), off + s + i, np.int32)
        last, caches = lm.decode_step(tparams, tcfg, toks[:, s + i: s + i + 1], pos, caches,
                                      device="cpu")
        jlast, jcaches = jlm.decode_step(params, jcfg, jnp.asarray(toks[:, s + i: s + i + 1]),
                                         jnp.asarray(pos), jcaches)
        torch.testing.assert_close(last, full[:, off + s + i], atol=5e-4, rtol=0)
        _close_lm(last, jlast)
        _close_lm(caches, jcaches)


@pytest.mark.parametrize("name", FRONTENDS)
def test_embed_quant_reaches_the_frontend_projection(name):
    """Under ``qat_fixed<16,6>`` the plan's embed hook (QAT weight STE and
    activation fake-quant) acts on ``frontend_proj``: the port's embedding
    equals the reference's ``_embed_inputs`` within 1e-5 and differs from
    the float embedding."""
    jcfg, tcfg = _configs(name, "qat_fixed<16,6>")
    params = numpy_tree(jlm.param_spec(jcfg), seed=8)
    batch = _batch(jcfg, 2, 6, seed=9)
    qc, jqc = (precision.resolve_model_plan(tcfg).embed_quant(),
               jprec.resolve_model_plan(jcfg).embed_quant())
    assert qc.mode == jqc.mode == "qat"
    tparams = params_from_numpy(params, "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    h, off = lm._embed_inputs(tparams, tcfg, tbatch, "train", quant=qc)
    jh, joff = jlm._embed_inputs(params, jcfg, jax.tree.map(jnp.asarray, batch), "train",
                                 quant=jqc)
    assert off == joff
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5, rtol=0)
    plain, _ = lm._embed_inputs(tparams, tcfg, tbatch, "train",
                                quant=precision.resolve_model_plan(
                                    dataclasses.replace(tcfg, precision="float")).embed_quant())
    assert not torch.equal(h, plain)


# ---------------------------------------------------------------------------
# losses and their gradients
# ---------------------------------------------------------------------------


def _assert_grads_close(ours, ref, path=""):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), path
        for k in ref:
            _assert_grads_close(ours[k], ref[k], f"{path}/{k}")
        return
    g, r = ours.detach().float().numpy(), np.asarray(ref, np.float32)
    assert g.shape == r.shape, path
    bound = REL * max(1.0, float(np.abs(r).max()))
    err = float(np.abs(g - r).max())
    assert err <= bound, f"{path}: max |d| {err:.3e} > {bound:.3e}"


def _loss_and_grads(name, batch, seed, **overrides):
    jcfg, tcfg = _configs(name, **overrides)
    params = numpy_tree(jlm.param_spec(jcfg), seed)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, jcfg, b),
                                              has_aux=True))(params, batch)
    (tl, tm), tg = value_and_grad(lm.loss_fn, params_from_numpy(params, "cpu"), tcfg, batch,
                                  device="cpu")
    np.testing.assert_allclose(float(tl), float(jl), rtol=REL)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=REL, atol=1e-7, err_msg=k)
    _assert_grads_close(tg, jg)
    return tm, tg


def test_encoder_masked_unit_loss_and_grads_match_jax():
    """hubert: the cross entropy of ``labels`` at every frame under
    ``loss_mask`` (no next-token shift), through the frontend projection."""
    jcfg, _ = _configs("hubert-xlarge")
    batch = _batch(jcfg, 2, 10, seed=12, labels=True)
    metrics, grads = _loss_and_grads("hubert-xlarge", batch, seed=13)
    assert set(metrics) == {"ce_loss", "accuracy", "loss"}
    assert float(grads["frontend_proj"]["kernel"].abs().max()) > 0


def test_vlm_loss_from_the_text_offset_and_grads_match_jax():
    """internvl2: the next-token loss over the text only (the image prefix
    predicts nothing), which still reaches the patch projection through
    attention."""
    jcfg, _ = _configs("internvl2-1b")
    batch = _batch(jcfg, 2, 10, seed=14)
    batch["loss_mask"] = (np.random.default_rng(15).random((2, 10)) < 0.8).astype(np.float32)
    _, grads = _loss_and_grads("internvl2-1b", batch, seed=16)
    assert float(grads["frontend_proj"]["kernel"].abs().max()) > 0


@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_moe_aux_losses_and_grads_match_jax(cf):
    """granite-moe-3b-a800m-reduced away from its published capacity factor
    (tests/test_torch_moe.py::test_loss_fn_raises_naming_its_item holds
    1.25): the total is the cross entropy plus the router's aux and z
    losses; the metrics carry each and the dropped share per layer (0.5
    drops many tokens, 4.0 none)."""
    jcfg = jax_get_config("granite-moe-3b-a800m", reduced=True)
    rng = np.random.default_rng(17)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)}
    metrics, _ = _loss_and_grads("granite-moe-3b-a800m", batch, seed=18, capacity_factor=cf)
    assert {"moe_aux_loss", "moe_z_loss", "moe_dropped_frac"} <= set(metrics)
    assert float(metrics["loss"]) > float(metrics["ce_loss"])
    dropped = float(metrics["moe_dropped_frac"])
    assert dropped > 0.1 if cf == 0.5 else dropped == 0.0
