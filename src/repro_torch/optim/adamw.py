"""AdamW on nested dicts of tensors (port of ``repro.optim.adamw``).

The state is ``{"step", "mu", "nu"}``: an int32 scalar and float32 moments
mirroring the parameter tree, on the parameters' device, as the reference's.
Same order of operations: global-norm clip, moment updates, bias
correction by ``1 - b**step``, then decoupled weight decay on every leaf.

The reference's jitted step donates its buffers; here ``update`` writes the
new parameters and moments into the given tensors under ``torch.no_grad()``
and returns the same objects.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models.params import map_leaves

PyTree = Any


def tree_leaves(tree: PyTree, path=()) -> list[tuple[tuple, torch.Tensor]]:
    """(path, leaf) pairs of a nested dict in sorted path order (the order
    of ``jax.tree.leaves``)."""
    if not isinstance(tree, dict):
        return [(path, tree)]
    return [item for k in sorted(tree) for item in tree_leaves(tree[k], path + (k,))]


def tree_get(tree: PyTree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for _, x in tree_leaves(tree)))


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Callable[[torch.Tensor], torch.Tensor | float]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float | None = 1.0

    def init(self, params: PyTree) -> dict:
        device = tree_leaves(params)[0][1].device
        zeros = lambda _, p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return {
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": map_leaves(zeros, params),
            "nu": map_leaves(zeros, params),
        }

    def abstract_state(self, abstract_params: PyTree) -> dict:
        """The state of :meth:`init` on the ``meta`` device."""
        f32 = lambda _, p: torch.empty(p.shape, dtype=torch.float32, device="meta")  # noqa: E731
        return {
            "step": torch.empty((), dtype=torch.int32, device="meta"),
            "mu": map_leaves(f32, abstract_params),
            "nu": map_leaves(f32, abstract_params),
        }

    @torch.no_grad()
    def update(self, grads: PyTree, state: dict, params: PyTree, *,
               grad_norm: torch.Tensor | None = None) -> tuple[PyTree, dict, dict]:
        """Returns (params, state, metrics); ``params`` and ``state`` are the
        given trees, updated in place.  ``grad_norm``: the global norm of
        the whole gradient, when ``grads`` hold one shard of each leaf (the
        sharded step); the update is elementwise beyond it."""
        step = state["step"] + 1
        gnorm = global_norm(grads) if grad_norm is None else grad_norm
        scale = None
        if self.grad_clip is not None:
            scale = torch.clamp_max(self.grad_clip / (gnorm + 1e-9), 1.0)
        b1, b2 = self.b1, self.b2
        lr = self.schedule(step)
        c1 = 1 - b1 ** step.float()
        c2 = 1 - b2 ** step.float()
        for path, p in tree_leaves(params):
            g = tree_get(grads, path).float()
            if scale is not None:
                g = g * scale
            m, v = tree_get(state["mu"], path), tree_get(state["nu"], path)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            delta = delta + self.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
        state["step"].copy_(step)
        return params, state, {"lr": lr, "grad_norm": gnorm}
