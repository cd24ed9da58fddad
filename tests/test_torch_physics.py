"""The port's physics encoders end to end against
``repro.models.physics.forward``: the three models at their published
widths, batch 8, under four precision policies, on the same parameters
(numpy from a seed, PTQ'd by the JAX package, carried across with
``params_from_numpy``) and the same seeded events."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import numpy_params  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.models import physics as jphys  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import GENERATORS  # noqa: E402
from repro_torch.models import physics  # noqa: E402

# float / ptq_fixed: float32 matmuls summed in different orders; the logits
# (|logit| up to ~10) agree to about 1e-6 relative.
# paper_vu13p / int8_serve: the LUT softmax and the activation snapping pick
# a table entry or an ap_fixed level by rounding, and a one-ulp difference
# before a tie moves the result by one entry (exp: 1.6 % of one key's
# weight; 1/x: 0.8 % of a row) or one level (2^-6); such a flip, damped
# through the following layers and the mean pool, stays below 1e-3.
TOL = {
    "float": dict(atol=1e-5, rtol=1e-5),
    "ptq_fixed<12,6>": dict(atol=1e-5, rtol=1e-5),
    "paper_vu13p": dict(atol=1e-3, rtol=1e-4),
    "int8_serve": dict(atol=1e-3, rtol=1e-4),
}


@pytest.mark.parametrize("name", ["engine_anomaly", "btagging", "gw"])
@pytest.mark.parametrize("policy", list(TOL))
def test_logits_and_proba_match_jax(name, policy):
    jcfg = dataclasses.replace(jax_get_config(name), precision=policy)
    tcfg = dataclasses.replace(get_config(name), precision=policy)
    plan = jprec.resolve_model_plan(jcfg)
    ptq = jax.jit(lambda p: jprec.apply_plan_to_params(p, plan))
    params = jax.tree.map(np.asarray, ptq(numpy_params(jcfg, seed=len(name))))
    x, _ = GENERATORS[name](8, seed=3)

    fwd = jax.jit(jphys.forward, static_argnums=(1,))
    proba = jax.jit(jphys.predict_proba, static_argnums=(1,))
    ref_logits = np.asarray(fwd(params, jcfg, jnp.asarray(x)))
    ref_proba = np.asarray(proba(params, jcfg, jnp.asarray(x)))

    tparams = params_from_numpy(params, "cpu")
    logits = physics.forward(tparams, tcfg, x, device="cpu")
    prob = physics.predict_proba(tparams, tcfg, x, device="cpu")
    assert logits.shape == (8, tcfg.n_classes) and torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.numpy(), ref_logits, **TOL[policy])
    np.testing.assert_allclose(prob.numpy(), ref_proba, **TOL[policy])


def test_params_from_numpy_keeps_tree_dtypes_and_stacking():
    jcfg = jax_get_config("gw")
    pn = numpy_params(jcfg, seed=0)
    pt = params_from_numpy(pn, "cpu")
    assert pt["blocks"]["attn"]["wq"]["kernel"].shape == (2, 32, 32)
    assert pt["blocks"]["ln1"]["scale"].shape == (2, 32)
    assert pt["head2"]["kernel"].dtype == torch.float32
    np.testing.assert_array_equal(pt["pos_embed"].numpy(), pn["pos_embed"])
    spec_shapes = jax.tree.map(lambda s: tuple(s.shape), physics.param_spec(get_config("gw")),
                               is_leaf=lambda s: hasattr(s, "init"))
    assert spec_shapes == jax.tree.map(lambda a: a.shape, pn)


def test_init_params_is_seeded():
    cfg = get_config("btagging")
    a = physics.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = physics.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    c = physics.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(a["blocks"]["ffn"]["w_up"]["kernel"], b["blocks"]["ffn"]["w_up"]["kernel"])
    assert not torch.equal(a["pos_embed"], c["pos_embed"])
    assert torch.equal(a["blocks"]["ln1"]["scale"], torch.ones(3, 64))
