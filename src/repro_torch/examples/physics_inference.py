"""The paper's end-to-end physics workflow on one encoder (port of
``examples/physics_inference.py``).

The Sec. V-C + Sec. VI-A protocol: train the classifier (150 float AdamW
steps on 1024 seeded events), post-training-quantize it at the paper's
chosen precision (``ptq_fixed<W,I>`` from ``PAPER_OPTIMAL``), run
quantization-aware training at that precision (60 steps from the float
weights), and report each AUC on 1024 held-out events (seed 77) with its
ratio to the float AUC.  ``--policy`` overrides the paper-optimal presets
(for example ``paper_vu13p``, whose LUT softmax and LUT norm are then on the
training path).  Last, the paper's FPGA cycle model (``core.latency_model``,
its VU13P clocks) estimates the encoder's latency at reuse factors 1, 2
and 4.

    PYTHONPATH=src python -m repro_torch.examples.physics_inference \\
        [gw|engine_anomaly|btagging] [--policy qat_fixed<10,5>] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.core import fixed_point as fxp
from repro_torch.core import latency_model as lat
from repro_torch.core import precision as precision_lib
from repro_torch.data import physics as pdata
from repro_torch.device import resolve_device
from repro_torch.models import physics as pmodel
from repro_torch.models.params import map_leaves
from repro_torch.optim import AdamW
from repro_torch.train.step import value_and_grad


def train(cfg, x, y, steps, params=None, lr=3e-3, seed=0, *, device="cuda", losses=None):
    """``steps`` full-batch AdamW steps (constant ``lr``, no weight decay)
    on events ``x`` with labels ``y``, from ``params`` (copied; default: an
    init drawn from a CPU generator seeded with ``seed``).  Returns (params,
    last loss); each step's loss tensor is appended to ``losses`` if given."""
    dev = resolve_device(device)
    if params is None:
        params = pmodel.init_params(cfg, torch.Generator().manual_seed(seed), device=dev)
    else:
        params = map_leaves(lambda _, t: t.detach().to(dev, copy=True), params)
    opt = AdamW(schedule=lambda s: lr, weight_decay=0.0)
    state = opt.init(params)
    batch = {"x": torch.tensor(x, device=dev), "y": torch.tensor(y, device=dev)}
    loss = torch.tensor(float("nan"))
    for _ in range(steps):
        (loss, _), grads = value_and_grad(pmodel.loss_fn, params, cfg, batch, device=dev)
        opt.update(grads, state, params)
        if losses is not None:
            losses.append(loss)
    return params, float(loss)


def auc_of(cfg, params, x, y, *, device="cuda") -> float:
    with torch.no_grad():
        proba = pmodel.predict_proba(params, cfg, x, device=device).cpu().numpy()
    if cfg.n_classes == 1:
        return pdata.auc_score(y, proba)
    if cfg.n_classes == 2:
        return pdata.auc_score(y, proba[:, 1])
    return pdata.multiclass_auc(y, proba)


def policies(name: str, policy: str | None = None):
    """(PTQ policy, QAT policy): the paper-optimal ``{ptq,qat}_fixed<W,I>``,
    or ``policy`` for both ('auto': the model's ``serve_policy``)."""
    cfg = configs.get_config(name)
    if policy == "auto":
        policy = cfg.serve_policy
    if policy is None:
        fp = fxp.PAPER_OPTIMAL[name]["qat"]
        return (precision_lib.get_policy(f"ptq_fixed<{fp.total_bits},{fp.int_bits}>"),
                precision_lib.get_policy(f"qat_fixed<{fp.total_bits},{fp.int_bits}>"))
    return precision_lib.get_policy(policy), precision_lib.get_policy(policy)


def fpga_latency(name: str, reuses=(1, 2, 4)) -> list[lat.FpgaLatencyEstimate]:
    """The paper's FPGA cycle model of encoder ``name`` at each reuse
    factor."""
    cfg = configs.get_config(name)
    return [lat.fpga_style_estimate(seq_len=cfg.seq_len, d_model=cfg.d_model,
                                    n_blocks=cfg.n_layers, reuse=r) for r in reuses]


def workflow(name: str = "gw", policy: str | None = None, *, device="cuda", n_events=1024,
             float_steps=150, qat_steps=60, params=None, seed=0, verbose=False) -> dict:
    """Train, PTQ, QAT and the AUCs; ``params`` is the float init (default:
    drawn from ``seed``).  Returns the AUCs, their ratios and every step's
    loss."""
    dev = resolve_device(device)
    cfg = configs.get_config(name)
    ptq_policy, qat_policy = policies(name, policy)
    say = print if verbose else (lambda *a: None)
    say(f"== {name}: seq {cfg.seq_len} x {cfg.input_vec_size}, {cfg.n_layers} blocks, "
        f"d={cfg.d_model}, policies {ptq_policy.name}/{qat_policy.name} ==")
    x, y = pdata.GENERATORS[name](n_events, seed=0)
    xt, yt = pdata.GENERATORS[name](n_events, seed=77)

    float_losses, qat_losses = [], []
    params, loss = train(cfg, x, y, float_steps, params=params, seed=seed, device=dev,
                         losses=float_losses)
    auc_float = auc_of(cfg, params, xt, yt, device=dev)
    say(f"float model:       loss {loss:.4f}  AUC {auc_float:.4f}")

    ptq = precision_lib.apply_plan_to_params(params, ptq_policy.resolve(cfg.n_layers))
    auc_ptq = auc_of(cfg, ptq, xt, yt, device=dev)
    say(f"PTQ {ptq_policy.name}:   AUC {auc_ptq:.4f}  (ratio {auc_ptq / auc_float:.4f})")

    cfg_q = dataclasses.replace(cfg, precision=qat_policy)
    qat_params, _ = train(cfg_q, x, y, qat_steps, params=params, lr=1e-3, device=dev,
                          losses=qat_losses)
    qat_eval = precision_lib.apply_plan_to_params(qat_params, qat_policy.resolve(cfg.n_layers))
    auc_qat = auc_of(cfg_q, qat_eval, xt, yt, device=dev)
    say(f"QAT {qat_policy.name}:   AUC {auc_qat:.4f}  (ratio {auc_qat / auc_float:.4f})")
    for est in fpga_latency(name):
        say(f"latency model R{est.reuse}: clk {est.clock_ns:.2f}ns  "
            f"II {est.interval_cycles}  latency {est.latency_us:.2f}us")
    return dict(model=name, ptq_policy=ptq_policy.name, qat_policy=qat_policy.name,
                loss_float=loss, auc_float=auc_float, auc_ptq=auc_ptq,
                ratio_ptq=auc_ptq / auc_float, auc_qat=auc_qat, ratio_qat=auc_qat / auc_float,
                float_losses=[float(t) for t in float_losses],
                qat_losses=[float(t) for t in qat_losses])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("model", nargs="?", default="gw", choices=["gw", "engine_anomaly", "btagging"])
    ap.add_argument("--policy", default=None,
                    help="precision policy overriding the paper-optimal presets (e.g. "
                         "qat_fixed<10,5>, paper_vu13p, or 'auto' for the model's serve_policy)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    workflow(args.model, policy=args.policy, device=args.device, verbose=True)


if __name__ == "__main__":
    main()
