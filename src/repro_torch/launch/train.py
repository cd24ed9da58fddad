"""Training launcher (port of ``repro.launch.train``).

One process: runs the fault-tolerant loop on ``--device``.  ``--multihost``:
each rank initialises the process group from ``torchrun``'s environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), builds the
production mesh ((data 16, model 16), 256 ranks) and runs the same loop,
sharded by the default ``ShardingRules``; rank 0 writes the checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --steps 100 \\
        [--device cuda|cpu] [--workdir DIR]
    torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \\
        --arch granite-8b --full-config --multihost
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.base import ParallelismConfig, TrainConfig
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import run_training


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_launch_train"))
    ap.add_argument("--multihost", action="store_true",
                    help="initialise torch.distributed from the environment and use the "
                         "production mesh")
    ap.add_argument("--schedule", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    mesh = None
    if args.multihost:
        backend = "nccl" if args.device == "cuda" else "gloo"
        dist.init_process_group(backend)  # env:// (torchrun)
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        mesh = make_production_mesh(device_type=args.device)

    try:
        cfg = configs.get_config(args.arch, reduced=not args.full_config)
        schedule = args.schedule or ("wsd" if cfg.name.startswith("minicpm") else "cosine")
        tc = TrainConfig(
            total_steps=args.steps,
            warmup_steps=max(5, args.steps // 20),
            schedule=schedule,
            checkpoint_every=max(25, args.steps // 4),
        )
        ds = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                           global_batch=args.batch))
        rules = ShardingRules(mesh=mesh, plan=ParallelismConfig()) if mesh else None
        result = run_training(cfg, tc, ds.batch, workdir=args.workdir, mesh=mesh, rules=rules,
                              device=args.device)
        print(f"done at step {result.final_step}; "
              f"last loss {result.metrics_history[-1]['loss']:.4f}")
    finally:
        if args.multihost:
            dist.barrier()  # a gloo rank that leaves early resets its peers
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
