"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""

import numpy as np

from repro.models import params as jparams
from repro.models import physics as jphys


def numpy_params(jcfg, seed):
    """A random physics parameter tree (nested dicts of numpy float32)
    with the JAX package's shapes, including the stacked blocks."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        if len(shape) >= 2 and path[-1] == "kernel":
            return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(np.float32)
        if path[-1] == "scale":
            return (1.0 + 0.2 * rng.normal(size=shape)).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    spec = jparams.abstract_params(jphys.param_spec(jcfg))

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in sorted(tree.items())}
        return leaf(path, tree.shape)

    return walk(spec)
