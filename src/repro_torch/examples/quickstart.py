"""Quickstart: the paper's pipeline in a few steps (port of
``examples/quickstart.py``).

Trains a reduced granite-8b briefly on the synthetic token stream, serves
it from the checkpoint under the float and the paper-quantized
(``int8_serve``: int8 weights and KV cache, LUT softmax) policies and
compares the two continuations, then prints the H100 roofline bound of
its decode step, counted from the step itself on ``meta`` tensors.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np

from repro_torch import configs
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ServeConfig, ShapeConfig, TrainConfig
from repro_torch.core import latency_model as lat
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import dryrun
from repro_torch.models import lm
from repro_torch.roofline.analysis import analyze_cell
from repro_torch.serve.api import Engine
from repro_torch.train import run_training


def decode_roofline(cfg, batch: int = 1, cache_len: int = 64):
    """The fused roofline terms of one decode step of ``cfg`` at ``batch``
    over a ``cache_len``-token cache on one H100."""
    shape = ShapeConfig("decode", cache_len, batch, "decode")
    mesh = dryrun.make_mesh("card")
    tr = dryrun.trace_decode(cfg, shape, mesh,
                             ShardingRules(mesh=mesh, plan=dryrun.plan_for(cfg, shape)))
    cell = analyze_cell(arch=cfg.name, shape_cfg=shape, cfg=cfg, mesh_name="card", n_devices=1,
                        count=tr.count, coll_bytes=tr.coll_bytes, memory_stats=tr.memory_stats)
    return cell.terms_fused


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    cfg = configs.get_config("granite-8b", reduced=True)
    print(f"model: {cfg.name}  params={lm.count_params(cfg):,}")

    # 1. train briefly on the synthetic token stream; a fresh workdir per run
    # (a stale checkpoint at total_steps would resume and return at once)
    ds = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8))
    workdir = tempfile.mkdtemp(prefix="repro_torch_quickstart_")
    result = run_training(
        cfg, TrainConfig(learning_rate=1e-2, warmup_steps=5, total_steps=50,
                         checkpoint_every=25),
        ds.batch, workdir=workdir, device=args.device)
    hist = result.metrics_history
    print(f"trained {result.final_step} steps; loss {hist[0]['loss']:.3f} -> "
          f"{hist[-1]['loss']:.3f}")

    # 2. reload the trained params and serve, float vs paper-quantized
    state = Checkpointer(f"{workdir}/checkpoints").restore(result.state)
    params = state["params"]
    prompt = [int(t) for t in np.asarray(ds.batch(999)["tokens"][0, :8])]
    outs = {}
    for policy in (None, "int8_serve"):
        eng = Engine(cfg, params, ServeConfig(max_batch=1, max_seq_len=64, policy=policy),
                     device=args.device)
        h = eng.submit(prompt, max_new_tokens=12)
        outs[policy] = eng.generate()[h.uid].generated
    agree = sum(a == b for a, b in zip(outs[None], outs["int8_serve"]))
    print(f"float   continuation: {outs[None]}")
    print(f"int8+LUT continuation: {outs['int8_serve']}  (agreement {agree}/12)")

    # 3. the H100 roofline bound of this model's decode step
    terms = decode_roofline(cfg)
    lo, hi = lat.latency_us(terms)
    print(f"{lat.H100.name} decode-step roofline (batch 1, 64-token cache): "
          f"{lo:.2f}-{hi:.2f} us, {terms.dominant}-bound")


if __name__ == "__main__":
    main()
