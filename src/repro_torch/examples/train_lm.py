"""Train an LM on the synthetic token stream through the fault-tolerant
loop (checkpoint/resume, heartbeat, straggler detection); port of
``examples/train_lm.py``.

The default is a ~100M-parameter llama-style model; ``--arch`` takes a
ported config, reduced unless ``--full-config`` (the published widths).
A run resumes from the latest checkpoint in ``--workdir``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 \\
        [--arch granite-8b] [--device cuda|cpu] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import tempfile

from repro_torch import configs
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
from repro_torch.models import lm
from repro_torch.train import run_training


def model_100m() -> ModelConfig:
    """~100M params: 12L x d768, llama-style."""
    return ModelConfig(
        name="repro-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=2048, vocab_size=32000, attn_kind="gqa", norm_kind="rmsnorm",
        act="silu", gated_mlp=True, tie_embeddings=True, dtype="float32",
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="a ported config id (reduced)")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd", "linear"])
    ap.add_argument("--workdir", default=None, help="default: a new temporary directory")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.arch:
        cfg = configs.get_config(args.arch, reduced=not args.full_config)
        if cfg.name.startswith("minicpm"):
            args.schedule = "wsd"  # the paper-faithful schedule for MiniCPM
    else:
        cfg = model_100m()
    workdir = args.workdir or tempfile.mkdtemp(prefix="repro_torch_train_")
    print(f"training {cfg.name}: {lm.count_params(cfg):,} params, {args.steps} steps @ batch "
          f"{args.batch} x seq {args.seq} on {args.device}; workdir {workdir}")
    ds = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                       global_batch=args.batch))
    tc = TrainConfig(learning_rate=args.lr, warmup_steps=max(10, args.steps // 20),
                     total_steps=args.steps, schedule=args.schedule,
                     checkpoint_every=max(50, args.steps // 4))
    result = run_training(cfg, tc, ds.batch, workdir=workdir, log_every=10, device=args.device)
    hist = result.metrics_history
    print(f"\nfinal step {result.final_step}; loss {hist[0]['loss']:.3f} -> "
          f"{hist[-1]['loss']:.3f}; stragglers flagged: {len(result.stragglers)}")


if __name__ == "__main__":
    main()
