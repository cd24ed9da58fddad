"""Training the Mamba2 and hybrid families in the port, against the JAX
package on the CPU.

- ``kernels.ssd_scan.autograd.ssd_backward`` (the backward of the card's
  ``SSDScan``) against ``jax.vjp`` of the reference's ``ssd_chunked``, over
  grouped B / C, chunk < l, strong decay and a missing cotangent of either
  output: max |d| within 1e-5 · max(1, max |g|) per gradient, as
  ``tests/test_torch_train_grads.py``'s ``REL``.  Under strong decay the
  oracle is the same JAX function in float64: the reference's float32
  prefix sums lose ~|cs| 2^-24 of their digits there (1.6e-4 of y,
  ``tests/test_torch_ssd_scan.py``), the port's float64 sums do not.
- ``SSDScan`` with the plain scan injected as its forward: the gradients of
  torch autograd through the plain scan, its ``grad_fn``, bf16 inputs.
- ``value_and_grad(lm.loss_fn)`` on reduced mamba2-130m and zamba2-1.2b
  against ``jax.value_and_grad`` on the same numpy parameters, through the
  CPU path and with every Mamba2 layer's scan routed through ``SSDScan``
  (the card's route): the loss within 1e-5, each leaf within 1e-5 ·
  max(1, max |g|).
- Three ``run_training`` steps on each, against the reference's
  ``train_step`` from the port's own initial state on the same synthetic
  batches: losses within 1e-4; and a run killed and resumed bitwise equal
  to the straight one.
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
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.data.synthetic import SyntheticLMConfig as JSyntheticLMConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import make_schedule as jmake_schedule  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_numpy, train_state_to_numpy  # noqa: E402
from repro_torch.data import SyntheticLM, SyntheticLMConfig  # noqa: E402
from repro_torch.kernels.ssd_scan import autograd as ssd_grad  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_with_state  # noqa: E402
from repro_torch.models import lm, ssm  # noqa: E402
from repro_torch.train import FailureInjector, run_training, value_and_grad  # noqa: E402

REL = 1e-5
FAMILIES = ["mamba2-130m", "zamba2-1.2b"]


def _inputs(b, l, h, p, n, g, seed, decay=1.0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(b, l, h, p)).astype(f) * 0.5,
            (-np.abs(rng.normal(size=(b, l, h))) * 0.3 * decay).astype(f),
            rng.normal(size=(b, l, g, n)).astype(f) * 0.5,
            rng.normal(size=(b, l, g, n)).astype(f) * 0.5)


def _jax_vjp(ins, dy, dstate, chunk, dtype):
    """(dxdt, da, dB, dC) of the reference's ssd_chunked, B and C by group."""
    h, g = ins[0].shape[2], ins[2].shape[2]

    def f(xdt, a, bg, cg):
        return jssm.ssd_chunked(xdt, a, jnp.repeat(bg, h // g, axis=2),
                                jnp.repeat(cg, h // g, axis=2), chunk=chunk)

    b, l, _, p = ins[0].shape
    n = ins[2].shape[3]
    cot = tuple(jnp.zeros(shape, dtype) if d is None else jnp.asarray(d, dtype)
                for d, shape in ((dy, (b, l, h, p)), (dstate, (b, h, p, n))))
    grads = jax.jit(lambda args, c: jax.vjp(f, *args)[1](c))(
        [jnp.asarray(t, dtype) for t in ins], cot)
    return [np.asarray(t, np.float64) for t in grads]


# (b, l, h, p, n, groups, chunk, decay, cotangents): grouped B / C, chunk < l,
# one chunk, strong decay, and each output's cotangent missing in turn
SSD_GRAD_CASES = [
    (2, 64, 4, 8, 16, 2, 16, "normal", "both"),
    (2, 64, 4, 8, 16, 1, 64, "normal", "both"),
    (1, 96, 6, 16, 8, 3, 32, "normal", "y"),
    (2, 64, 4, 8, 16, 2, 16, "normal", "state"),
    (2, 128, 4, 16, 16, 1, 64, "strong", "both"),
    (2, 64, 4, 8, 16, 2, 16, "strong", "y"),
]


@pytest.mark.parametrize("b,l,h,p,n,g,chunk,decay,cot", SSD_GRAD_CASES)
def test_ssd_backward_matches_jax_vjp(b, l, h, p, n, g, chunk, decay, cot):
    ins = _inputs(b, l, h, p, n, g, seed=l + h + g, decay=50.0 if decay == "strong" else 1.0)
    rng = np.random.default_rng(1)
    dy = rng.normal(size=(b, l, h, p)).astype(np.float32) if cot in ("both", "y") else None
    dstate = rng.normal(size=(b, h, p, n)).astype(np.float32) if cot in ("both", "state") else None
    t = [torch.from_numpy(a) for a in ins]
    ours = ssd_grad.ssd_backward(*t, None if dy is None else torch.from_numpy(dy),
                                 None if dstate is None else torch.from_numpy(dstate), chunk=chunk)
    if decay == "strong":
        with jax.enable_x64(True):
            ref = _jax_vjp(ins, dy, dstate, chunk, jnp.float64)
    else:
        ref = _jax_vjp(ins, dy, dstate, chunk, jnp.float32)
    for name, o, r, x in zip(("dxdt", "da", "dB", "dC"), ours, ref, t):
        assert o.dtype == x.dtype and o.shape == x.shape, name
        assert torch.isfinite(o).all(), name
        bound = REL * max(1.0, float(np.abs(r).max()))
        err = float(np.abs(o.double().numpy() - r).max())
        assert err <= bound, f"{name}: max |d| {err:.3e} > {bound:.3e}"
    if dy is None:  # C reaches only y
        assert torch.equal(ours[3], torch.zeros_like(t[3]))


def _plain_forward(xdt, a, bmat, cmat, chunk):
    return ssd_with_state(xdt, a, bmat, cmat, chunk=chunk)  # CPU tensors: the plain scan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_function_gives_autograd_of_the_plain_scan(dtype):
    """The Function with the plain scan as its forward: the same outputs and
    the gradients of autograd through the plain scan, in each input's dtype;
    ``y.grad_fn`` names the Function."""
    ins = [torch.from_numpy(a).to(dtype) for a in _inputs(2, 64, 4, 8, 16, 2, seed=3)]
    a = [x.clone().requires_grad_() for x in ins]
    b = [x.clone().requires_grad_() for x in ins]
    y, state = ssd_grad.ssd_scan(*a, chunk=16, forward=_plain_forward)
    assert "SSDScan" in type(y.grad_fn).__name__
    y_ref, s_ref = ssd_with_state(*b, chunk=16)
    assert torch.equal(y, y_ref) and torch.equal(state, s_ref)
    g = torch.Generator().manual_seed(0)
    dy, ds = torch.randn(y.shape, generator=g).to(dtype), torch.randn(state.shape, generator=g)
    ours = torch.autograd.grad((y, state), a, (dy, ds))
    ref = torch.autograd.grad((y_ref, s_ref), b, (dy, ds))
    for o, r, x in zip(ours, ref, ins):
        assert o.dtype == x.dtype
        if dtype == torch.bfloat16:  # one bf16 rounding of the same float32 value
            torch.testing.assert_close(o.float(), r.float(), rtol=1e-2, atol=1e-2)
        else:
            torch.testing.assert_close(o, r, rtol=0, atol=REL * max(1.0, float(r.abs().max())))


def _configs(name):
    return jax_get_config(name, reduced=True), get_config(name, reduced=True)


def _scan_through_function(monkeypatch):
    """Route every Mamba2 layer's scan through ``SSDScan`` with the plain
    forward, as the card routes it through the kernel."""
    monkeypatch.setattr(ssm, "ssd_with_state", lambda xdt, a, bm, cm, *, chunk: ssd_grad.ssd_scan(
        xdt, a, bm, cm, chunk=chunk, forward=_plain_forward))


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


@pytest.mark.parametrize("route", ["plain", "function"])
@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_jax(name, route, monkeypatch):
    """Two chunks of the reduced config's scan (32 tokens, chunk 16), so the
    state carries across a chunk boundary."""
    jcfg, tcfg = _configs(name)
    params = numpy_tree(jlm.param_spec(jcfg), seed=4)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, jcfg, b),
                                              has_aux=True))(params, batch)
    if route == "function":
        _scan_through_function(monkeypatch)
    (tl, tm), tg = value_and_grad(lm.loss_fn, params_from_numpy(params, "cpu"), tcfg, batch,
                                  device="cpu")
    np.testing.assert_allclose(float(tl), float(jl), rtol=REL)
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]), rtol=REL)
    _assert_grads_close(tg, jg)


def _train_cfg(**kw):
    return dict(total_steps=3, warmup_steps=1, learning_rate=1e-3, checkpoint_every=100, **kw)


@pytest.mark.parametrize("name", FAMILIES)
def test_run_training_tracks_the_reference_over_3_steps(name, tmp_path):
    """``run_training`` (the port's loop, its init from ``seed``) against the
    reference's jitted ``train_step`` started from that same state, on the
    same synthetic batches (the two streams are equal)."""
    jcfg, tcfg = _configs(name)
    tc = TrainConfig(**_train_cfg())
    ds = SyntheticLM(SyntheticLMConfig(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=2))
    init = lm.init_params(tcfg, torch.Generator().manual_seed(tc.seed), device="cpu")
    res = run_training(tcfg, tc, ds.batch, workdir=str(tmp_path), log_every=1, device="cpu")
    jtc = JTrainConfig(**_train_cfg())
    jopt = JAdamW(schedule=jmake_schedule(jtc), b1=jtc.b1, b2=jtc.b2, eps=jtc.eps,
                  weight_decay=jtc.weight_decay, grad_clip=jtc.grad_clip)
    params = train_state_to_numpy({"params": init})["params"]
    jstate = {"params": params, "opt": jopt.init(params)}
    jfn = jax.jit(lambda st, b: jstep.train_step(st, b, cfg=jcfg, optimizer=jopt))
    jds = JSyntheticLM(JSyntheticLMConfig(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=2))
    jlosses = []
    for step in range(tc.total_steps):
        jstate, jm = jfn(jstate, jds.batch(step, 0, 1))
        jlosses.append(float(jm["loss"]))
    np.testing.assert_allclose([m["loss"] for m in res.metrics_history], jlosses, rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("name", FAMILIES)
def test_killed_and_resumed_run_is_bitwise_the_straight_run(name, tmp_path):
    tcfg = get_config(name, reduced=True)
    tc = TrainConfig(**dict(_train_cfg(), total_steps=6, checkpoint_every=2))
    ds = SyntheticLM(SyntheticLMConfig(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=2))
    straight = run_training(tcfg, tc, ds.batch, workdir=str(tmp_path / "a"), device="cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        run_training(tcfg, tc, ds.batch, workdir=str(tmp_path / "b"), device="cpu",
                     failure_injector=FailureInjector(fail_at_step=5))
    resumed = run_training(tcfg, tc, ds.batch, workdir=str(tmp_path / "b"), device="cpu")
    a, b = train_state_to_numpy(straight.state), train_state_to_numpy(resumed.state)
    jax.tree.map(np.testing.assert_array_equal, a, b)


def test_mamba_layer_gradient_reaches_every_scan_input(monkeypatch):
    """Through the Function, every Mamba2 parameter of a reduced zamba2 gets a
    nonzero gradient (the scan's inputs all carry one back)."""
    _scan_through_function(monkeypatch)
    tcfg = get_config("zamba2-1.2b", reduced=True)
    tcfg = dataclasses.replace(tcfg, n_layers=2)
    params = lm.init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    tokens = torch.randint(0, tcfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(2))
    _, grads = value_and_grad(lm.loss_fn, params, tcfg, {"tokens": tokens}, device="cpu")
    for k, g in grads["blocks"]["mamba"].items():
        leaves = g.values() if isinstance(g, dict) else [g]
        assert all(torch.count_nonzero(x) > 0 for x in leaves), k
