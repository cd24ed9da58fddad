"""LR schedules: linear warmup + {cosine, WSD, linear} decay (port of
``repro.optim.schedules``).

Each takes the step as an int or an integer tensor and returns the rate as
a float32 tensor on the step's device, computed in float32 as the
reference's jnp arithmetic is.  WSD (Warmup-Stable-Decay) is the MiniCPM
schedule (arXiv:2404.06395): constant through the stable phase, then an
exponential-style decay over the final ``decay_fraction`` of training.
"""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step)


def warmup(step, warmup_steps):
    return torch.clamp_max((_step(step) + 1) / max(warmup_steps, 1), 1.0)


def _progress(step, warmup_steps, total_steps):
    return torch.clamp((_step(step) - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)


def cosine_schedule(step, *, base_lr, warmup_steps, total_steps, min_ratio=0.1):
    w = warmup(step, warmup_steps)
    t = _progress(step, warmup_steps, total_steps)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return base_lr * w * cos


def wsd_schedule(step, *, base_lr, warmup_steps, total_steps, decay_fraction=0.1,
                 min_ratio=0.01):
    """Warmup -> Stable (constant) -> Decay (MiniCPM; exponential-like)."""
    step = _step(step)
    w = warmup(step, warmup_steps)
    f32 = dict(dtype=torch.float32, device=step.device)
    decay_steps = torch.tensor(max(total_steps * decay_fraction, 1), **f32)
    decay_start = total_steps - decay_steps
    in_decay = step >= decay_start
    t = torch.clamp((step - decay_start) / decay_steps, 0.0, 1.0)
    decay = torch.pow(torch.tensor(min_ratio, **f32), t)  # min_ratio**t: 1 -> min_ratio
    return base_lr * w * torch.where(in_decay, decay, 1.0)


def linear_schedule(step, *, base_lr, warmup_steps, total_steps, min_ratio=0.0):
    w = warmup(step, warmup_steps)
    t = _progress(step, warmup_steps, total_steps)
    return base_lr * w * (1 - (1 - min_ratio) * t)


def make_schedule(train_cfg):
    kind = train_cfg.schedule
    kw = dict(base_lr=train_cfg.learning_rate, warmup_steps=train_cfg.warmup_steps,
              total_steps=train_cfg.total_steps)
    if kind == "cosine":
        return lambda s: cosine_schedule(s, **kw)
    if kind == "wsd":
        return lambda s: wsd_schedule(s, decay_fraction=train_cfg.decay_fraction, **kw)
    if kind == "linear":
        return lambda s: linear_schedule(s, **kw)
    raise ValueError(f"unknown schedule {kind}")
