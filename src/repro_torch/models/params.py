"""Parameter specs: one source of truth for parameter shapes and init.

A spec tree is a nested dict whose leaves are ``ArraySpec``s; the parameter
tree mirrors it with tensors.  ``stack_spec`` prepends the layer axis of the
stacked ``blocks`` tree, as in the JAX package.  Init draws from an explicit
``torch.Generator``, leaf by leaf in sorted path order, each leaf on the
generator's own device, cast and placed before the next is drawn.  It cannot
reproduce the JAX package's parameters; parity tests carry those across with
``repro_torch.convert.params_from_numpy``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device

SpecTree = Any  # nested dict[str, ArraySpec | SpecTree]


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    logical_axes: tuple[str | None, ...] = ()
    init: str = "fan_in"  # fan_in | normal | zeros | ones | embed | small
    init_scale: float | None = None

    def __post_init__(self):
        if self.logical_axes and len(self.logical_axes) != len(self.shape):
            raise ValueError(f"logical_axes {self.logical_axes} rank != shape {self.shape}")


def _leaf_init(spec: ArraySpec, gen: torch.Generator) -> torch.Tensor:
    shape, dtype, dev = spec.shape, spec.dtype, gen.device
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    default_scale = {"embed": 1.0, "normal": 0.02, "small": 1e-3}
    if spec.init in default_scale:
        scale = spec.init_scale or default_scale[spec.init]
    else:  # fan_in: 1/sqrt(fan_in); stacked (layers, in, out) leaves use axis -2
        fan_in = shape[-2] if len(shape) >= 2 else shape[0]
        scale = spec.init_scale or (1.0 / max(fan_in, 1)) ** 0.5
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev) * scale).to(dtype)


def map_leaves(fn: Callable[[tuple, Any], Any], tree: Any, path=()) -> Any:
    """Apply ``fn(path, leaf)`` to every leaf of a nested dict."""
    if not isinstance(tree, dict):
        return fn(path, tree)
    return {name: map_leaves(fn, child, path + (name,)) for name, child in tree.items()}


def init_params(
    spec: SpecTree, generator: torch.Generator, device: str | torch.device = "cuda"
) -> Any:
    """Parameters for ``spec`` on ``device``, drawn from ``generator`` in
    sorted path order, one leaf at a time on the generator's device (float32,
    then cast to the leaf's dtype and moved), so at most one leaf's float32
    draw is held besides the tree.  A seed gives the same parameters on
    every ``device`` for a CPU generator; a CUDA generator draws other
    values (fast for large models: nothing crosses from the host)."""
    device = resolve_device(device)
    leaves = {}
    map_leaves(lambda path, s: leaves.setdefault(path, s), spec)
    values = {path: _leaf_init(leaves[path], generator).to(device) for path in sorted(leaves)}
    return map_leaves(lambda path, _: values[path], spec)


def abstract_params(spec: SpecTree) -> Any:
    """The parameter tree of ``spec`` as tensors on the ``meta`` device:
    shapes and dtypes, no storage (the reference's ``ShapeDtypeStruct``
    tree)."""
    return map_leaves(lambda _, s: torch.empty(s.shape, dtype=s.dtype, device="meta"), spec)


def logical_axes(spec: SpecTree) -> Any:
    """The tree of each leaf's logical axis names (``()`` where a spec names
    none)."""
    return map_leaves(lambda _, s: tuple(s.logical_axes), spec)


def check_on(params: Any, dev: torch.device) -> None:
    """Raise unless every leaf of ``params`` lies on ``dev``'s device type."""
    bad = []
    map_leaves(
        lambda path, t: bad.append("/".join(path)) if t.device.type != dev.type else None,
        params,
    )
    if bad:
        raise ValueError(f"parameters {bad[:3]}... are not on {dev}; move them first")


def stack_spec(spec: SpecTree, n: int) -> SpecTree:
    """Prepend a ``layers`` axis to every leaf (the stacked ``blocks`` tree)."""

    def _stack(_, s: ArraySpec) -> ArraySpec:
        axes = ("layers",) + (tuple(s.logical_axes) or (None,) * len(s.shape))
        return dataclasses.replace(s, shape=(n,) + s.shape, logical_axes=axes)

    return map_leaves(_stack, spec)


def cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Every floating tensor leaf of ``tree`` (nested dicts, lists, tuples)
    cast to ``dtype``; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
