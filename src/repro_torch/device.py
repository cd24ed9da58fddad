"""Device selection shared by every entry point of the port.

Entry points take ``device="cuda"`` by default.  When CUDA is absent they
raise instead of running on the CPU; the CPU runs only when the caller asks
for it (the tests pass ``device="cpu"``).
"""

from __future__ import annotations

import functools

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` to run on; raises when CUDA was asked for and
    is not available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA device requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path"
            )
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
