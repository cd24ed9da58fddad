"""The port's optimizer, schedules and train step against the JAX package:
``optim.schedules`` (float32, step by step), ``optim.AdamW`` (one update of
a random tree, clip on and off), ``TrainConfig`` field for field, and
``train.train_step`` over 3 steps on the reduced granite-8b (``grad_accum``
1 and 2) from the same numpy parameters and tokens.

Bounds: schedules and a single AdamW update within 1e-6 relative (float32
pow/sqrt/cos may differ by an ulp); over 3 train steps the loss within 1e-5
and the parameters within 1e-6, except where the step-1 gradient is below
1e-6 in magnitude: there Adam's update m / sqrt(v) is the sign of a float32
rounding difference, up to the learning rate either way.  Such entries are
counted and must stay under 0.1 % of the parameters."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

from _torch_parity import numpy_tree, one_torch_thread  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import global_norm as jglobal_norm  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.optim import AdamW, global_norm, make_schedule, schedules  # noqa: E402
from repro_torch.train import make_train_step, train_step  # noqa: E402


@pytest.mark.parametrize("kind", ["cosine_schedule", "wsd_schedule", "linear_schedule"])
def test_schedules_match_jax(kind):
    kw = dict(base_lr=3e-4, warmup_steps=37, total_steps=411)
    steps = np.arange(0, 460, 7, dtype=np.int32)
    ref = np.asarray(jax.vmap(lambda s: getattr(jsched, kind)(s, **kw))(steps))
    ours = getattr(schedules, kind)(torch.from_numpy(steps), **kw).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)


def test_train_config_and_make_schedule():
    assert [(f.name, f.default) for f in dataclasses.fields(TrainConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JTrainConfig)]
    for kind in ("cosine", "wsd", "linear"):
        tc = TrainConfig(schedule=kind, warmup_steps=5, total_steps=50, learning_rate=1e-3)
        jtc = JTrainConfig(schedule=kind, warmup_steps=5, total_steps=50, learning_rate=1e-3)
        for s in (0, 4, 30, 49):
            np.testing.assert_allclose(float(make_schedule(tc)(torch.tensor(s))),
                                       float(jsched.make_schedule(jtc)(jnp.int32(s))), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown schedule"):
        make_schedule(dataclasses.replace(TrainConfig(), schedule="step"))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(5, 7)).astype(np.float32),
                  "b": rng.normal(size=(7,)).astype(np.float32)},
            "c": (0.1 * rng.normal(size=(3, 4, 2))).astype(np.float32)}


@pytest.mark.parametrize("grad_clip,weight_decay", [(1.0, 0.1), (None, 0.0), (0.05, 0.3)])
def test_adamw_update_matches_jax(grad_clip, weight_decay):
    params, grads = _tree(0), _tree(1)
    sched = lambda s: 1e-2 * (s + 1) / 4  # noqa: E731 - a step-dependent rate
    jopt = JAdamW(schedule=sched, grad_clip=grad_clip, weight_decay=weight_decay)
    opt = AdamW(schedule=sched, grad_clip=grad_clip, weight_decay=weight_decay)
    jp, js = params, jopt.init(params)
    tp = train_state_from_numpy({"params": params, "opt": jax.tree.map(np.asarray, js)}, "cpu")
    tparams, tstate = tp["params"], tp["opt"]
    for i in range(2):  # two updates: the bias correction moves with the step
        g = jax.tree.map(lambda a: a * (i + 1), grads)
        jp, js, jm = jopt.update(g, js, jp)
        out_p, out_s, m = opt.update(params_from_numpy(g, "cpu"), tstate, tparams)
        assert out_p is tparams and out_s is tstate  # in place
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    ours = train_state_to_numpy({"params": tparams, "opt": tstate})
    ref = jax.tree.map(np.asarray, {"params": jp, "opt": js})
    assert ours["opt"]["step"] == 2 and ours["opt"]["step"].dtype == np.int32
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7), ours, ref)
    np.testing.assert_allclose(float(global_norm(tparams)), float(jglobal_norm(jp)), rtol=1e-6)


def _lm_setup(grad_accum):
    jcfg = jax_get_config("granite-8b", reduced=True)
    tcfg = get_config("granite-8b", reduced=True)
    params = numpy_tree(jlm.param_spec(jcfg), seed=9)
    rng = np.random.default_rng(grad_accum)
    batches = [{"tokens": rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)}
               for _ in range(3)]
    return jcfg, tcfg, params, batches


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_tracks_jax_over_3_steps(grad_accum):
    jcfg, tcfg, params, batches = _lm_setup(grad_accum)
    sched = lambda s: jsched.cosine_schedule(s, base_lr=1e-3, warmup_steps=2, total_steps=10)  # noqa: E731
    jopt = JAdamW(schedule=sched)
    opt = AdamW(schedule=lambda s: schedules.cosine_schedule(s, base_lr=1e-3, warmup_steps=2,
                                                             total_steps=10))
    jfn = jax.jit(lambda st, b: jstep.train_step(st, b, cfg=jcfg, optimizer=jopt,
                                                 grad_accum=grad_accum))
    jstate = {"params": params, "opt": jopt.init(params)}
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    g1 = jax.grad(lambda p: jlm.loss_fn(p, jcfg, batches[0])[0])(params)
    small = jax.tree.map(lambda g: np.abs(np.asarray(g)) < 1e-6, g1)
    for b in batches:
        jstate, jm = jfn(jstate, b)
        state, m = train_step(state, {k: torch.from_numpy(v) for k, v in b.items()}, cfg=tcfg,
                              optimizer=opt, grad_accum=grad_accum)
        for k in ("loss", "ce_loss", "accuracy", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    ours = train_state_to_numpy(state)["params"]
    ref = jax.tree.map(np.asarray, jstate["params"])
    off = jax.tree.map(lambda a, b: np.abs(a - b) > 1e-6, ours, ref)
    assert not any(np.any(o & ~s) for o, s in zip(jax.tree.leaves(off), jax.tree.leaves(small)))
    n_off = sum(int(o.sum()) for o in jax.tree.leaves(off))
    n_all = sum(o.size for o in jax.tree.leaves(off))
    assert n_off <= 1e-3 * n_all, f"{n_off} of {n_all} parameters off"
    assert int(state["opt"]["step"]) == 3


def test_grad_accum_averages_microbatches():
    """grad_accum=2 over a batch takes the mean of the two halves'
    gradients: the same update as one full batch, to float32 rounding."""
    _, tcfg, params, batches = _lm_setup(1)
    batch = {"tokens": torch.from_numpy(batches[0]["tokens"])}
    out = []
    for ga in (1, 2):
        opt = AdamW(schedule=lambda s: 1e-3, grad_clip=None)
        p = train_state_from_numpy({"params": params, "opt": jax.tree.map(
            np.asarray, JAdamW(schedule=None).init(params))}, "cpu")
        _, m = train_step(p, batch, cfg=tcfg, optimizer=opt, grad_accum=ga)
        out.append(m)
    np.testing.assert_allclose(float(out[0]["loss"]), float(out[1]["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(out[0]["grad_norm"]), float(out[1]["grad_norm"]), rtol=1e-5)


def test_make_train_step_refuses_a_mesh():
    """The sharded step takes a torch DeviceMesh and refuses anything else;
    a mesh without rules (or rules without a mesh) is the unsharded step,
    as the reference's."""
    opt = AdamW(schedule=lambda s: 1e-3)
    cfg = get_config("granite-8b", reduced=True)
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(cfg, opt, mesh=object(), rules=object())
    assert make_train_step(cfg, opt, mesh=object()).func is train_step
