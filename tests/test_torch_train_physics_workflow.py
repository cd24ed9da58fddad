"""The port's physics workflow (``repro_torch.examples.physics_inference``:
train, PTQ, QAT, AUC ratios) against the JAX package's example
(``examples/physics_inference.py``) at a reduced size: 256 events, 20
float and 10 QAT steps, from the same numpy init, for the three encoders
under the paper-optimal policies.

What can be held, and how tightly:
- every step's loss of the two float runs within 1e-4 relative for the
  first 5 steps.  Later steps are not compared: full-batch AdamW at lr 3e-3
  on these models is chaotic, and float32 rounding differences grow by about
  10x per step from there (the reference run itself moves by 2e-5
  (btagging) and 8e-3 (gw) of its step-20 loss when one weight matrix of its
  init moves by one ulp);
- the AUCs of the float, PTQ and QAT models, computed by the port on the
  reference's own trained weights, within 1e-4 of the reference's;
- the free-running AUC ratios of the two workflows within 0.02 (the bound
  ``chip_smoke.py`` phase 8 holds the card's full-size run to).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

from _torch_parity import numpy_params, one_torch_thread  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.models import physics as jphys  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import precision  # noqa: E402
from repro_torch.examples import physics_inference as wf  # noqa: E402

N_EVENTS, FLOAT_STEPS, QAT_STEPS, TRACKED_STEPS = 256, 20, 10, 5


def _reference_example():
    path = Path(__file__).resolve().parents[1] / "examples" / "physics_inference.py"
    spec = importlib.util.spec_from_file_location("_jax_physics_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jex = _reference_example()


def _reference_float_run(jcfg, init, x, y):
    """The example's ``train`` (constant lr 3e-3, no weight decay, full
    batch), keeping every step's loss."""
    opt = JAdamW(schedule=lambda s: 3e-3, weight_decay=0.0)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}

    @jax.jit
    def step(params, state):
        (loss, _), g = jax.value_and_grad(jphys.loss_fn, has_aux=True)(params, jcfg, batch)
        params, state, _ = opt.update(g, state, params)
        return params, state, loss

    params = jax.tree.map(jnp.asarray, init)
    state, losses = opt.init(params), []
    for _ in range(FLOAT_STEPS):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    return params, losses


@pytest.mark.parametrize("name", ["engine_anomaly", "btagging", "gw"])
def test_reduced_workflow_tracks_the_reference(name):
    jcfg = jconfigs.get_config(name)
    init = numpy_params(jcfg, seed=5)
    x, y = wf.pdata.GENERATORS[name](N_EVENTS, seed=0)
    xt, yt = wf.pdata.GENERATORS[name](N_EVENTS, seed=77)
    ptq_p, qat_p = wf.policies(name)
    jptq, jqat = jprec.get_policy(ptq_p.name), jprec.get_policy(qat_p.name)

    jp, jlosses = _reference_float_run(jcfg, init, x, y)
    jptq_params = jprec.apply_plan_to_params(jp, jptq.resolve(jcfg.n_layers))
    jcq = dataclasses.replace(jcfg, precision=jqat)
    jq, _ = jex.train(jcq, x, y, QAT_STEPS, params=jp, lr=1e-3)
    jq_eval = jprec.apply_plan_to_params(jq, jqat.resolve(jcfg.n_layers))
    ref = {"float": jex.auc_of(jcfg, jp, xt, yt), "ptq": jex.auc_of(jcfg, jptq_params, xt, yt),
           "qat": jex.auc_of(jcq, jq_eval, xt, yt)}

    ours = wf.workflow(name, device="cpu", n_events=N_EVENTS, float_steps=FLOAT_STEPS,
                       qat_steps=QAT_STEPS, params=params_from_numpy(init, "cpu"))
    assert len(ours["float_losses"]) == FLOAT_STEPS and len(ours["qat_losses"]) == QAT_STEPS
    np.testing.assert_allclose(ours["float_losses"][:TRACKED_STEPS], jlosses[:TRACKED_STEPS],
                               rtol=1e-4)

    # the port's PTQ, forward and AUC on the reference's trained weights
    cfg = configs.get_config(name)
    cfg_q = dataclasses.replace(cfg, precision=qat_p)
    on_ref = {
        "float": wf.auc_of(cfg, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), xt, yt,
                           device="cpu"),
        "ptq": wf.auc_of(cfg, precision.apply_plan_to_params(
            params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
            ptq_p.resolve(cfg.n_layers)), xt, yt, device="cpu"),
        "qat": wf.auc_of(cfg_q, precision.apply_plan_to_params(
            params_from_numpy(jax.tree.map(np.asarray, jq), "cpu"),
            qat_p.resolve(cfg.n_layers)), xt, yt, device="cpu"),
    }
    for k in ref:
        assert abs(on_ref[k] - ref[k]) <= 1e-4, (k, on_ref[k], ref[k])

    # the free-running ratios
    assert abs(ours["ratio_ptq"] - ref["ptq"] / ref["float"]) <= 0.02
    assert abs(ours["ratio_qat"] - ref["qat"] / ref["float"]) <= 0.02
    assert 0.5 < ours["auc_float"] <= 1.0


def test_cli_runs_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(wf, "workflow", lambda *a, **k: calls.append((a, k)))
    calls = []
    wf.main(["btagging", "--policy", "paper_vu13p", "--device", "cpu"])
    assert calls == [(("btagging",), dict(policy="paper_vu13p", device="cpu", verbose=True))]
    ptq, qat = wf.policies("btagging")
    assert (ptq.name, qat.name) == ("ptq_fixed<12,6>", "qat_fixed<12,6>")
    assert wf.policies("gw", "paper_vu13p")[0].name == "paper_vu13p"
