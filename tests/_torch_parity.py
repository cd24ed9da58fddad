"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""

import numpy as np
import pytest

from repro.models import params as jparams
from repro.models import physics as jphys


def _leaf(rng, path, shape):
    name = path[-1]
    if len(shape) >= 2 and name == "kernel":
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(np.float32)
    if name == "scale":
        return (1.0 + 0.2 * rng.normal(size=shape)).astype(np.float32)
    # Mamba2: the published init's ranges, A in [-16, -1] and dt in
    # [1e-3, 0.1] after the softplus, so the state carries across chunks
    if name == "A_log":
        return np.log(rng.uniform(1.0, 16.0, size=shape)).astype(np.float32)
    if name == "dt_bias":
        return np.log(np.expm1(rng.uniform(1e-3, 0.1, size=shape))).astype(np.float32)
    if name == "conv_w":
        return (0.5 * rng.normal(size=shape)).astype(np.float32)
    return (0.1 * rng.normal(size=shape)).astype(np.float32)


def numpy_tree(spec, seed):
    """Random numpy float32 leaves for a JAX ``ArraySpec`` tree (sorted path
    order, so a seed gives one tree)."""
    rng = np.random.default_rng(seed)
    abstract = jparams.abstract_params(spec)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in sorted(tree.items())}
        return _leaf(rng, path, tree.shape)

    return walk(abstract)


def numpy_params(jcfg, seed):
    """A random physics parameter tree (nested dicts of numpy float32)
    with the JAX package's shapes, including the stacked blocks."""
    return numpy_tree(jphys.param_spec(jcfg), seed)


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's torch ops on one thread, restoring the count after.
    The tier-1 run puts six test processes on the machine's cores; each
    torch op spread over every core by each of them oversubscribes the CPU
    (the training tests' small ops ran 10-25x slower that way)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
