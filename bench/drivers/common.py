"""What both drivers need from the program: its model configuration with
the configuration file's sizes, and weights drawn from the seed on the
device in the layout the program's parameter spec gives."""

from __future__ import annotations

import dataclasses

import torch


def model_config(config: dict):
    """The program's ``ModelConfig`` of ``config["model"]`` with every size
    of the file's ``model_config`` and the configuration's precision."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(config["model"]), **config["model_config"])
    return dataclasses.replace(cfg, precision=config["policy"])


def make_weights(spec, seed: int, device: torch.device):
    """Weights for the program's parameter spec tree: one draw per leaf from
    one generator on ``device`` seeded with ``seed``, leaves in sorted path
    order (a stacked leaf holds every layer, so a model takes a few large
    draws), scaled as the spec's ``init`` says, in the leaf's own type."""
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], path + (k,))
        else:
            leaves.append((path, tree))

    walk(spec, ())
    values = {}
    for path, s in sorted(leaves, key=lambda kv: kv[0]):
        if s.init == "zeros":
            values[path] = torch.zeros(s.shape, dtype=s.dtype, device=device)
        elif s.init == "ones":
            values[path] = torch.ones(s.shape, dtype=s.dtype, device=device)
        else:
            scale = s.init_scale or {"embed": 1.0, "normal": 0.02, "small": 1e-3}.get(
                s.init, (1.0 / max(s.shape[-2] if len(s.shape) >= 2 else s.shape[0], 1)) ** 0.5)
            t = torch.randn(s.shape, generator=gen, dtype=torch.float32, device=device)
            values[path] = t.mul_(scale).to(s.dtype)

    def build(tree, path):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        return values[path]

    return build(spec, ())


def free_device_memory() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
