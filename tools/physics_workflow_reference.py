#!/usr/bin/env python3
"""The JAX package's physics workflow (``examples/physics_inference.py``:
its ``train`` and ``auc_of``, 150 float steps, PTQ, 60 QAT steps, 1024
events) on the CPU, started from the port's seeded init, for the values
``chip_smoke.py`` phase 8 holds the card's run to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/physics_workflow_reference.py [MODEL ...]

The example draws its init from ``jax.random.PRNGKey(0)``, which torch
cannot reproduce; here the init is the port's
(``repro_torch.models.physics.init_params`` with a CPU generator seeded 0,
what ``repro_torch.examples.physics_inference`` uses), converted to numpy,
so the two runs differ only in the float order of their arithmetic.
Prints one line per (model, policy) with the float AUC, the PTQ and QAT
AUCs and their ratios to the float AUC, at full float precision.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro import configs as jconfigs  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.examples import physics_inference as port_wf  # noqa: E402
from repro_torch.models import physics  # noqa: E402


def _example():
    spec = importlib.util.spec_from_file_location("physics_example",
                                                  ROOT / "examples" / "physics_inference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def run(ex, name: str, policy: str | None):
    jcfg = jconfigs.get_config(name)
    init = physics.init_params(configs.get_config(name), torch.Generator().manual_seed(0),
                               device="cpu")
    ptq_p, qat_p = port_wf.policies(name, policy)
    jptq, jqat = jprec.get_policy(ptq_p.name), jprec.get_policy(qat_p.name)
    x, y = ex.pdata.GENERATORS[name](1024, seed=0)
    xt, yt = ex.pdata.GENERATORS[name](1024, seed=77)
    params, loss = ex.train(jcfg, x, y, 150, params=jax.tree.map(jnp.asarray, _numpy(init)))
    auc_float = ex.auc_of(jcfg, params, xt, yt)
    auc_ptq = ex.auc_of(jcfg, jprec.apply_plan_to_params(params, jptq.resolve(jcfg.n_layers)),
                        xt, yt)
    cfg_q = dataclasses.replace(jcfg, precision=jqat)
    qat_params, _ = ex.train(cfg_q, x, y, 60, params=params, lr=1e-3)
    auc_qat = ex.auc_of(cfg_q, jprec.apply_plan_to_params(qat_params,
                                                           jqat.resolve(jcfg.n_layers)), xt, yt)
    return loss, auc_float, auc_ptq, auc_qat


def main(argv):
    ex = _example()
    names = argv or ["engine_anomaly", "btagging", "gw"]
    for name in names:
        for policy in (None, "paper_vu13p"):
            t0 = time.perf_counter()
            loss, f, p, q = run(ex, name, policy)
            print(f"{name} {policy}: float loss {loss!r} AUC {f!r}; PTQ AUC {p!r} ratio "
                  f"{p / f!r}; QAT AUC {q!r} ratio {q / f!r}  ({time.perf_counter() - t0:.0f} s)",
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
