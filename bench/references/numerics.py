"""Plain numerics the references share, written from the paper's and the
precision plans' definitions (frozen; nothing here imports the program).

- ``ap_fixed(W, I)``: round half to even onto the grid of step 2^-(W - I),
  saturating at [-2^(I-1), 2^(I-1) - step].
- The paper's lookup tables, built in float64 and stored as float32: exp
  over [-8, 8] (1024 entries, linear), 1/x over [2^-12, 2^33] and 1/sqrt(x)
  over [2^-20, 2^12] (4096 entries each, log-spaced); the nearest entry is
  ``rint((x' - offset) / step)`` in float32, saturated, with x' = x or
  log2(max(x, 1e-30)).
- Symmetric linear quantization of a weight per output channel (the last
  axis), of a key or value vector per (token, head), and fp8 (e4m3) with a
  per-channel scale.
- ``matmul_precision``: TF32 matrix products off (the references) or on
  (a control) for a block.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 off (the reference) or on (the control) for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


EXP = ("linear", -8.0, 8.0, 1024)
INV = ("log", 2.0 ** -12, 2.0 ** 33, 4096)
RSQRT = ("log", 2.0 ** -20, 2.0 ** 12, 4096)
_FN = {EXP: np.exp, INV: lambda x: 1.0 / x, RSQRT: lambda x: 1.0 / np.sqrt(x)}


def ap_fixed(x: torch.Tensor, total_bits: int, int_bits: int) -> torch.Tensor:
    step = 2.0 ** -(total_bits - int_bits)
    lo, hi = -(2.0 ** (int_bits - 1)), 2.0 ** (int_bits - 1) - step
    return torch.clamp(torch.round(x / step), lo / step, hi / step) * step


def ap_fixed_ste_value(x: torch.Tensor, total_bits: int, int_bits: int) -> torch.Tensor:
    """The forward value of a straight-through fake quantizer written as
    ``clip(x) + (q(x) - clip(x))``, which can differ from ``q(x)`` by one
    float32 rounding."""
    step = 2.0 ** -(total_bits - int_bits)
    clipped = torch.clamp(x, -(2.0 ** (int_bits - 1)), 2.0 ** (int_bits - 1) - step)
    return clipped + (ap_fixed(x, total_bits, int_bits) - clipped)


def _spacing_step(spec) -> tuple[float, float]:
    kind, lo, hi, size = spec
    if kind == "log":
        return float(np.float32(np.log2(lo))), float(np.float32((np.log2(hi) - np.log2(lo))
                                                                / (size - 1)))
    return float(np.float32(lo)), float(np.float32((hi - lo) / (size - 1)))


@functools.lru_cache(maxsize=None)
def _table(spec, device: str) -> torch.Tensor:
    kind, lo, hi, size = spec
    xs = (np.logspace(np.log2(lo), np.log2(hi), size, base=2.0, dtype=np.float64)
          if kind == "log" else np.linspace(lo, hi, size, dtype=np.float64))
    return torch.from_numpy(np.asarray(_FN[spec](xs)).astype(np.float32)).to(device)


def lookup(x: torch.Tensor, spec) -> torch.Tensor:
    """The table's nearest entry for float32 ``x``."""
    offset, step = _spacing_step(spec)
    xs = torch.log2(torch.clamp_min(x, 1e-30)) if spec[0] == "log" else x
    idx = torch.round((xs - offset) / torch.tensor(step, dtype=torch.float32, device=x.device))
    idx = torch.clamp(idx, 0, spec[3] - 1).to(torch.int64)
    return _table(spec, str(x.device))[idx]


def int_per_channel(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize-dequantize ``w`` (..., d_out) in float32 with one scale per
    last-axis channel over every other axis: scale = max|w| / (2^(bits-1) - 1)."""
    w = w.float()
    qmax = 2 ** (bits - 1) - 1
    amax = torch.amax(torch.abs(w).reshape(-1, w.shape[-1]), dim=0)
    scale = torch.clamp_min(amax, 1e-8) / qmax
    return torch.clamp(torch.round(w / scale), -qmax - 1, qmax) * scale


def fp8_per_channel(w: torch.Tensor) -> torch.Tensor:
    """Round ``w`` to float8 e4m3 under one scale per last-axis channel that
    maps the channel's largest magnitude to 448."""
    w = w.float()
    amax = torch.amax(torch.abs(w).reshape(-1, w.shape[-1]), dim=0)
    scale = torch.clamp_min(amax, 1e-8) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def int_per_vector(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize-dequantize float32 ``x`` with one scale per last-axis vector
    (a key or value per token and head)."""
    qmax = 2 ** (bits - 1) - 1
    scale = torch.clamp_min(torch.amax(torch.abs(x), dim=-1, keepdim=True), 1e-8) / qmax
    return torch.clamp(torch.round(x / scale), -qmax - 1, qmax) * scale
