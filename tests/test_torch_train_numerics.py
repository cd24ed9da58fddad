"""The numerics the training workflow adds to the port, against the JAX
package: PTQ calibration (``CalibrationStats``, ``PTQCalibrator``), the
fixed-point tree transforms (``quantize_pytree_fixed``,
``fake_quant_pytree`` with its clipped-STE gradient, ``sweep_frac_bits``),
``fixed_point.to_int`` / ``from_int`` / ``quantization_error_bound``,
``lut.build_table`` / ``lut_lookup_onehot`` / ``lut_max_abs_error``,
``layernorm.norm`` and the AUC metrics of ``data.physics``.  Bitwise where
the arithmetic is one rounding; the norm at 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

from _torch_parity import one_torch_thread  # noqa: E402,F401

from repro.core import fixed_point as jfxp  # noqa: E402
from repro.core import layernorm as jln  # noqa: E402
from repro.core import lut as jlut  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.data import physics as jdata  # noqa: E402
from repro_torch.core import fixed_point as fxp  # noqa: E402
from repro_torch.core import layernorm as ln  # noqa: E402
from repro_torch.core import lut, quant  # noqa: E402
from repro_torch.data import physics as data  # noqa: E402

CFGS = [fxp.ap_fixed(12, 6), fxp.ap_fixed(8, 3, round_mode="floor"),
        fxp.ap_fixed(10, 4, overflow_mode="wrap"), fxp.ap_fixed(6, 2, signed=False)]


def _jcfg(cfg):
    return jfxp.FixedPointConfig(cfg.total_bits, cfg.int_bits, cfg.signed, cfg.round_mode,
                                 cfg.overflow_mode)


def _x(seed=0, shape=(64, 9), scale=20.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("cfg", CFGS, ids=str)
def test_to_int_from_int_and_error_bound(cfg):
    x = _x()
    codes = fxp.to_int(torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jfxp.to_int(x, _jcfg(cfg))))
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(fxp.from_int(codes, cfg).numpy(),
                                  np.asarray(jfxp.from_int(np.asarray(codes), _jcfg(cfg))))
    assert fxp.quantization_error_bound(cfg) == jfxp.quantization_error_bound(_jcfg(cfg))
    assert str(cfg) == str(_jcfg(cfg))
    assert fxp.ap_fixed(12, 6).with_frac_bits(4) == fxp.ap_fixed(10, 6)
    assert {k: {m: str(c) for m, c in v.items()} for k, v in fxp.PAPER_OPTIMAL.items()} == {
        k: {m: str(c) for m, c in v.items()} for k, v in jfxp.PAPER_OPTIMAL.items()}


def _nested(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"kernel": (3 * rng.normal(size=(5, 4))).astype(np.float32),
                  "bias": rng.normal(size=(4,)).astype(np.float32)},
            "idx": np.arange(4, dtype=np.int32),
            "b": (40 * rng.normal(size=(6,))).astype(np.float32)}


def _to_t(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _to_t(v, grad) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, copy=True))
    return t.requires_grad_() if grad and t.is_floating_point() else t


def test_quantize_pytree_fixed_and_sweep_match_jax():
    tree = _nested(0)
    cfg = fxp.ap_fixed(12, 6)
    ours = quant.quantize_pytree_fixed(_to_t(tree), cfg)
    ref = jquant.quantize_pytree_fixed(jax.tree.map(jnp.asarray, tree), _jcfg(cfg))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)), ours, ref)
    assert ours["idx"].dtype == torch.int32
    x = _x(1, (3, 5), 1.0)
    w = (2 * np.random.default_rng(2).normal(size=(5, 4))).astype(np.float32)
    ours = quant.sweep_frac_bits(lambda p, x: x @ p["w"], {"w": torch.from_numpy(w)},
                                 torch.from_numpy(x), 4, [2, 5, 8])
    ref = jquant.sweep_frac_bits(lambda p, x: x @ p["w"], {"w": jnp.asarray(w)},
                                 jnp.asarray(x), 4, [2, 5, 8])
    for fb in (2, 5, 8):
        np.testing.assert_allclose(ours[fb].numpy(), np.asarray(ref[fb]), rtol=1e-6, atol=1e-6)


def test_fake_quant_pytree_values_and_ste_gradient_match_jax():
    tree = _nested(3)
    tree["b"][:2] = [fxp.ap_fixed(8, 4).min_value, fxp.ap_fixed(8, 4).max_value]  # at the bounds
    cfg = fxp.ap_fixed(8, 4)
    tt = _to_t(tree, grad=True)
    ours = quant.fake_quant_pytree(tt, cfg)
    loss = sum((v * (i + 1)).sum() for i, v in enumerate(
        x for x in (ours["a"]["kernel"], ours["a"]["bias"], ours["b"])))
    grads = torch.autograd.grad(loss, [tt["a"]["kernel"], tt["a"]["bias"], tt["b"]])

    def jloss(t):
        q = jquant.fake_quant_pytree(t, _jcfg(cfg))
        return sum((v * (i + 1)).sum() for i, v in enumerate(
            (q["a"]["kernel"], q["a"]["bias"], q["b"])))

    jt = jax.tree.map(jnp.asarray, tree)
    jg = jax.grad(jloss, allow_int=True)(jt)
    ref_q = jquant.fake_quant_pytree(jt, _jcfg(cfg))
    np.testing.assert_array_equal(ours["b"].detach().numpy(), np.asarray(ref_q["b"]))
    for g, r in zip(grads, (jg["a"]["kernel"], jg["a"]["bias"], jg["b"])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))  # incl. 0.5 at a bound
    assert float(grads[2][0]) == 1.5 and float(grads[2][1]) == 1.5


def test_ptq_calibrator_matches_jax():
    ours, ref = quant.PTQCalibrator(frac_bits=6), jquant.PTQCalibrator(frac_bits=6)
    for seed, scale in ((0, 0.3), (1, 5.0), (2, 700.0)):
        x = _x(seed, (32,), scale)
        ours.observe("h", torch.from_numpy(x))
        ref.observe("h", jnp.asarray(x))
        ours.observe(f"s{seed}", torch.from_numpy(x))
        ref.observe(f"s{seed}", jnp.asarray(x))
    assert {k: str(v) for k, v in ours.configs().items()} == {
        k: str(v) for k, v in ref.configs().items()}
    assert {k: (v.amax, v.amin, v.n) for k, v in ours.stats.items()} == {
        k: (v.amax, v.amin, v.n) for k, v in ref.stats.items()}
    assert quant.CalibrationStats(amax=3.9).required_int_bits() == \
        jquant.CalibrationStats(amax=3.9).required_int_bits()


@pytest.mark.parametrize("spec,fn", [(lut.EXP_SPEC, np.exp), (lut.INV_SPEC, lambda x: 1.0 / x),
                                     (lut.RSQRT_SPEC, lambda x: 1.0 / np.sqrt(x))],
                         ids=["exp", "inv", "rsqrt"])
def test_lut_table_onehot_lookup_and_error_bound(spec, fn):
    jspec = jlut.LutSpec(spec.name, spec.lo, spec.hi, spec.size, spec.spacing)
    table = lut.build_table(spec, fn, device="cpu")
    np.testing.assert_array_equal(table.numpy(), np.asarray(jlut.build_table(jspec, fn)))
    x = np.abs(_x(4, (300,), 3.0)) if spec.spacing == "log" else _x(4, (300,), 3.0)
    onehot = lut.lut_lookup_onehot(torch.from_numpy(x), table, spec)
    assert torch.equal(onehot, lut.lut_lookup(torch.from_numpy(x), table, spec))
    np.testing.assert_array_equal(onehot.numpy(),
                                  np.asarray(jlut.lut_lookup_onehot(x, jnp.asarray(table.numpy()),
                                                                    jspec)))
    assert lut.lut_max_abs_error(spec, fn) == jlut.lut_max_abs_error(jspec, fn)


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm", "none"])
@pytest.mark.parametrize("use_lut", [False, True])
def test_norm_matches_jax(kind, use_lut):
    x = _x(5, (6, 32), 2.0)
    rng = np.random.default_rng(6)
    p = {"scale": (1 + 0.1 * rng.normal(size=32)).astype(np.float32),
         "bias": rng.normal(size=32).astype(np.float32)}
    ours = ln.norm(torch.from_numpy(x), _to_t(p), kind=kind, use_lut=use_lut)
    ref = jln.norm(jnp.asarray(x), jax.tree.map(jnp.asarray, p), kind=kind, use_lut=use_lut)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="norm kind"):
        ln.norm(torch.from_numpy(x), _to_t(p), kind="batchnorm")


def test_auc_metrics_match_jax():
    rng = np.random.default_rng(8)
    y = rng.integers(0, 2, 500)
    scores = np.round(rng.normal(size=500) + y, 1)  # ties: midranks
    assert data.auc_score(y, scores) == jdata.auc_score(y, scores)
    np.testing.assert_array_equal(data._average_ranks(scores), jdata._average_ranks(scores))
    y3 = rng.integers(0, 3, 400)
    probs = rng.dirichlet(np.ones(3), 400) + 0.2 * np.eye(3)[y3]
    assert data.multiclass_auc(y3, probs) == jdata.multiclass_auc(y3, probs)
    assert np.isnan(data.auc_score(np.zeros(4), np.arange(4.0)))
