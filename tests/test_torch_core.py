"""The port's numerics (repro_torch.core) against the JAX package's
(repro.core): same numpy inputs from a seed, bitwise where the arithmetic
is the same."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import fixed_point as jfxp  # noqa: E402
from repro.core import lut as jlut  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import softmax as jsoftmax  # noqa: E402
from _torch_parity import numpy_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import fixed_point as tfxp  # noqa: E402
from repro_torch.core import lut as tlut  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core import softmax as tsoftmax  # noqa: E402

PHYSICS = ["engine_anomaly", "btagging", "gw"]
POLICIES = ["float", "paper_vu13p", "int8_serve", "ptq_fixed<12,6>"]
SPECS = ["EXP_SPEC", "INV_SPEC", "RSQRT_SPEC"]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("name", ["exp_table", "inv_table", "rsqrt_table"])
def test_lut_tables_bitwise(name):
    ref = np.asarray(getattr(jlut, name)())
    ours = getattr(tlut, name)("cpu").numpy()
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))


def _index_inputs(spec, seed):
    """Values across and beyond the domain, every grid point, and every
    exact half-step tie between neighbouring entries."""
    rng = np.random.default_rng(seed)
    off, step = tlut.index_constants(spec)
    i = np.arange(spec.size, dtype=np.float32)
    grid = np.float32(off) + i * np.float32(step)
    ties = np.float32(off) + (i + np.float32(0.5)) * np.float32(step)
    if spec.spacing == "log":
        rand = np.exp2(rng.uniform(off - 4, off + step * spec.size + 4, 20000))
        grid, ties = np.exp2(grid), np.exp2(ties)
        extra = [0.0, -1.0, 1e-35]
    else:
        rand = rng.uniform(spec.lo - 2, spec.hi + 2, 20000)
        extra = [-1e9, 1e9]
    return np.concatenate([rand, grid, ties, extra]).astype(np.float32)


@pytest.mark.parametrize("spec_name", SPECS)
def test_lut_index_matches(spec_name):
    spec = getattr(tlut, spec_name)
    x = _index_inputs(spec, seed=len(spec_name))
    ref = np.asarray(jlut.lut_index(jnp.asarray(x), getattr(jlut, spec_name)))
    ours = tlut.lut_index(_t(x), spec).numpy()
    if spec.spacing == "linear":  # no transcendental: bitwise the same arithmetic
        np.testing.assert_array_equal(ours, ref)
        return
    # A log table indexes log2(x), and neither package's float32 log2 is
    # exact: the reference's jnp.log2 is log(x)/log(2), and both run
    # vectorized code paths whose error was seen to reach tens of ulps on
    # some inputs, varying between runs.  So the claim is: the port picks the
    # entry that exact arithmetic picks except within 1 % of an entry spacing
    # of a half-step tie, and the reference differs from it by at most one
    # entry, on under 0.1 % of the inputs away from ties.
    off, step = tlut.index_constants(spec)
    with np.errstate(divide="ignore", invalid="ignore"):
        pos = (np.log2(np.maximum(x, np.float32(1e-30)).astype(np.float64)) - off) / step
    exact = np.clip(np.round(pos), 0, spec.size - 1)
    at_tie = np.abs(pos - np.floor(pos) - 0.5) < 1e-2
    off_exact = (ours != exact) & ~at_tie
    assert not off_exact.any(), (x[off_exact], pos[off_exact], ours[off_exact])
    assert np.abs(ours - ref).max() <= 1
    assert (ours != ref)[~at_tie].mean() <= 1e-3


@pytest.mark.parametrize(
    "cfg_args",
    [
        (12, 6, {}),
        (16, 6, {}),
        (8, 3, {}),
        (12, 6, {"round_mode": "floor"}),
        (12, 6, {"overflow_mode": "wrap"}),
        (10, 4, {"signed": False}),
    ],
)
def test_fixed_point_quantize_bitwise(cfg_args):
    w, i, kw = cfg_args
    jcfg, tcfg = jfxp.ap_fixed(w, i, **kw), tfxp.ap_fixed(w, i, **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    rng = np.random.default_rng(w * 100 + i)
    k = np.arange(-2 ** (w - 1) - 8, 2 ** (w - 1) + 8, dtype=np.float32)
    ties = (k + np.float32(0.5)) * np.float32(tcfg.step)  # exact half-step ties
    x = np.concatenate([rng.normal(0, 2 ** (i - 1), 5000), ties]).astype(np.float32)
    ref = np.asarray(jfxp.quantize(jnp.asarray(x), jcfg))
    ours = tfxp.quantize(_t(x), tcfg).numpy()
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))
    ref_ste = np.asarray(jfxp.quantize_ste(jnp.asarray(x), jcfg))
    np.testing.assert_array_equal(tfxp.quantize_ste(_t(x), tcfg).numpy(), ref_ste)


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_int8_bitwise(axis, bits):
    rng = np.random.default_rng(bits + (axis or 0))
    x = (rng.normal(size=(24, 40)) * rng.uniform(0.1, 3, size=(1, 40))).astype(np.float32)
    jq = jquant.quantize_int8(jnp.asarray(x), axis=axis, bits=bits)
    tq = tquant.quantize_int8(_t(x), axis=axis, bits=bits)
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(tq.dequantize().numpy(), np.asarray(jq.dequantize()))
    np.testing.assert_array_equal(
        tquant.fake_quant_int8(_t(x), axis=axis, bits=bits).numpy(),
        np.asarray(jquant.fake_quant_int8(jnp.asarray(x), axis=axis, bits=bits)),
    )


@pytest.mark.parametrize("mode", ["safe", "paper", "lut"])
def test_softmax_matches(mode):
    # scores inside and beyond the exp table's [-8, 8]; float32 sums in
    # different orders (1e-6).  lut: rows are kept off 1/x-table ties by the
    # seed (a tie would move a row by one entry, see test_lut_index_matches).
    x = np.random.default_rng(5).normal(0, 3, size=(64, 40)).astype(np.float32)
    ref = np.asarray(jsoftmax.softmax(jnp.asarray(x), mode=mode))
    np.testing.assert_allclose(tsoftmax.softmax(_t(x), mode=mode).numpy(), ref,
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("model", PHYSICS)
@pytest.mark.parametrize(
    "policy", ["float", "int8_serve", "paper_vu13p", "ptq_fixed<12,6>", "qat_fixed<12,6>"]
)
def test_precision_plan_matches(model, policy):
    jcfg = dataclasses.replace(jax_get_config(model), precision=policy)
    tcfg = dataclasses.replace(get_config(model), precision=policy)
    jplan, tplan = jprec.resolve_model_plan(jcfg), tprec.resolve_model_plan(tcfg)
    assert tplan.to_dict() == jplan.to_dict()
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    for kernel in (None, {}, {"softmax_mode": "safe"}):
        assert tplan.kernel_defaults(kernel) == jplan.kernel_defaults(kernel)
    assert tplan.transforms_params == jplan.transforms_params
    jq, tq = jplan.uniform_layer_quant(), tplan.uniform_layer_quant()
    assert dataclasses.asdict(tq) == dataclasses.asdict(jq)
    jarr, tarr = jplan.layer_quant_arrays(), tplan.layer_quant_arrays()
    for f in dataclasses.fields(tarr):
        np.testing.assert_array_equal(
            getattr(tarr, f.name).numpy(), np.asarray(getattr(jarr, f.name))
        )


def test_heterogeneous_layer_quant_matches():
    """Per-layer fixed precision rides the stacked step/bound arrays."""
    rules = (
        jprec.Rule("layers.0.weights", jprec.fixed(12, 6, method="qat")),
        jprec.Rule("layers.0.activations", jprec.fixed(12, 6)),
        jprec.Rule("layers.1.activations", jprec.fixed(10, 4)),
    )
    jpol = jprec.PrecisionPolicy("mixed", rules)
    tpol = tprec.PrecisionPolicy.from_dict(jpol.to_dict())
    jarr, tarr = jpol.resolve(3).layer_quant_arrays(), tpol.resolve(3).layer_quant_arrays()
    x = np.random.default_rng(3).normal(0, 8, 4000).astype(np.float32)
    for i in range(3):
        jl = jax.tree.map(lambda a, i=i: a[i], jarr)
        tl = tarr.layer(i)
        for hook in ("maybe_fake_quant_weight", "maybe_fake_quant_act"):
            ref = np.asarray(getattr(jl, hook)(jnp.asarray(x)))
            np.testing.assert_array_equal(getattr(tl, hook)(_t(x)).numpy(), ref)


@pytest.mark.parametrize("policy", POLICIES)
def test_apply_plan_to_params_bitwise(policy):
    jcfg = dataclasses.replace(jax_get_config("btagging"), precision=policy)
    tcfg = dataclasses.replace(get_config("btagging"), precision=policy)
    pn = numpy_params(jcfg, seed=11)
    ref = jprec.apply_plan_to_params(
        jax.tree.map(jnp.asarray, pn), jprec.resolve_model_plan(jcfg)
    )
    ours = tprec.apply_plan_to_params(
        params_from_numpy(pn, "cpu"), tprec.resolve_model_plan(tcfg)
    )
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    our_leaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), ours))
    assert [p for p, _ in our_leaves] == [p for p, _ in ref_leaves]
    for (path, a), (_, b) in zip(our_leaves, ref_leaves):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
