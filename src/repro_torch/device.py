"""Device selection shared by every entry point of the port.

Entry points take ``device="cuda"`` by default.  When CUDA is absent they
raise instead of running on the CPU; the CPU runs only when the caller asks
for it (the tests pass ``device="cpu"``).  They refuse the ``meta`` device
too, except inside :func:`meta_trace`, which the dry run (``launch.dryrun``)
and the roofline counts enter around a step on ``meta`` tensors of their own.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


_META_DEPTH = 0


@contextlib.contextmanager
def meta_trace():
    """Let the entry points run on ``meta`` tensors (shapes only) within the
    block: every kernel wrapper then runs its plain version, which computes
    nothing there."""
    global _META_DEPTH
    _META_DEPTH += 1
    try:
        yield
    finally:
        _META_DEPTH -= 1


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` to run on; raises when CUDA was asked for and
    is not available, and for ``meta`` outside :func:`meta_trace`."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA device requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path"
            )
    elif dev.type == "meta" and _META_DEPTH:
        return dev
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {device!r}")
    return dev


@functools.lru_cache(maxsize=None)
def scalar(value: float, dtype: torch.dtype, device: str) -> torch.Tensor:
    """``value`` as a 0-dim tensor on ``device``, for exact division.

    PyTorch's CUDA division of a tensor by a Python number multiplies by the
    number's reciprocal, which can be one ulp away from the quotient that
    the CPU, the JAX package and the CUDA kernels compute; dividing by a
    tensor on the same device divides on both devices."""
    return torch.tensor(value, dtype=dtype, device=device)


def upload(a, device: torch.device) -> torch.Tensor:
    """A fresh copy of the host array ``a`` on ``device``.

    To a card the copy is staged in a pinned buffer of its own and enqueued
    without blocking the host (a copy from pageable memory synchronises).
    The buffer is never written again, and the caching host allocator keeps
    it from reuse until the copy has landed, so no later host write to
    ``a`` can reach the device through it."""
    t = torch.from_numpy(np.array(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
