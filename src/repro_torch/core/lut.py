"""Bounded-domain lookup tables (port of ``repro.core.lut``).

Tables are built in numpy float64 and cast to float32, exactly as the
reference builds them, so they are bitwise equal.  ``lut_index`` computes in
float32 with the spec constants cast to float32 (the reference's weak
typing does the same) and rounds half to even.  The CUDA kernels take the
same float32 constants from :func:`index_constants`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device, scalar


@dataclasses.dataclass(frozen=True)
class LutSpec:
    """A sampled function table over [lo, hi] with ``size`` entries;
    ``spacing`` is 'linear' (fixed-point BRAM indexing) or 'log'
    (uniform relative error for reciprocal-like functions)."""

    name: str
    lo: float
    hi: float
    size: int
    spacing: str = "linear"  # linear | log

    @property
    def step(self) -> float:
        if self.spacing == "log":
            return (np.log2(self.hi) - np.log2(self.lo)) / (self.size - 1)
        return (self.hi - self.lo) / (self.size - 1)


def build_table_np(spec: LutSpec, fn: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    if spec.spacing == "log":
        xs = np.logspace(
            np.log2(spec.lo), np.log2(spec.hi), spec.size, base=2.0,
            dtype=np.float64,
        )
    else:
        xs = np.linspace(spec.lo, spec.hi, spec.size, dtype=np.float64)
    return np.asarray(fn(xs)).astype(np.float32)


def build_table(spec: LutSpec, fn: Callable[[np.ndarray], np.ndarray],
                device: str | torch.device = "cuda") -> torch.Tensor:
    """The float32 table of ``fn`` over ``spec``'s grid, on ``device``."""
    return torch.from_numpy(build_table_np(spec, fn)).to(resolve_device(device))


def index_constants(spec: LutSpec) -> tuple[float, float]:
    """(offset, step) as float32 values: ``idx = rint((x' - offset) / step)``
    with ``x' = x`` (linear) or ``log2(max(x, 1e-30))`` (log)."""
    offset = np.log2(spec.lo) if spec.spacing == "log" else spec.lo
    return float(np.float32(offset)), float(np.float32(spec.step))


def lut_index(x: torch.Tensor, spec: LutSpec) -> torch.Tensor:
    """Nearest-entry index with saturation (AP_SAT analogue)."""
    offset, step = index_constants(spec)
    if spec.spacing == "log":
        x = torch.log2(torch.clamp_min(x, 1e-30))
    # A true division on both devices (see device.scalar): a reciprocal
    # multiply would move the index at ties by one entry.
    idx = torch.round((x - offset) / scalar(step, torch.float32, str(x.device)))
    return torch.clamp(idx, 0, spec.size - 1).to(torch.int64)


def lut_lookup(x: torch.Tensor, table: torch.Tensor, spec: LutSpec) -> torch.Tensor:
    """Reference lookup (gather)."""
    return table[lut_index(x, spec)]


def lut_lookup_onehot(x: torch.Tensor, table: torch.Tensor, spec: LutSpec) -> torch.Tensor:
    """The lookup as ``one_hot(idx) @ table`` (the reference's matrix-unit
    form); bit-identical to :func:`lut_lookup`: each row selects one entry."""
    onehot = torch.nn.functional.one_hot(lut_index(x, spec), spec.size).to(table.dtype)
    return onehot @ table


def lut_max_abs_error(spec: LutSpec, fn: Callable[[np.ndarray], np.ndarray]) -> float:
    """Worst-case error of the nearest-entry lookup at the grid midpoints,
    in numpy float64 (bounds the LUT softmax error in property tests)."""
    if spec.spacing == "log":
        grid = np.logspace(np.log2(spec.lo), np.log2(spec.hi), spec.size, base=2.0)
        xs = np.sqrt(grid[:-1] * grid[1:])  # geometric midpoints
        idx = np.round((np.log2(xs) - np.log2(spec.lo)) / spec.step)
    else:
        xs = np.linspace(spec.lo, spec.hi - spec.step, spec.size - 1) + spec.step / 2
        idx = np.round((xs - spec.lo) / spec.step)
    idx = np.clip(idx, 0, spec.size - 1).astype(int)
    return float(np.max(np.abs(build_table_np(spec, fn)[idx] - fn(xs))))


# --- the paper's three tables ----------------------------------------------

EXP_SPEC = LutSpec("exp", lo=-8.0, hi=8.0, size=1024)
INV_SPEC = LutSpec("inv", lo=2.0 ** -12, hi=2.0 ** 33, size=4096, spacing="log")
RSQRT_SPEC = LutSpec("rsqrt", lo=2.0 ** -20, hi=2.0 ** 12, size=4096, spacing="log")

_FUNCTIONS = {
    "exp": np.exp,
    "inv": lambda x: 1.0 / x,
    "rsqrt": lambda x: 1.0 / np.sqrt(x),
}


@functools.lru_cache(maxsize=None)
def _table(name: str, device: str) -> torch.Tensor:
    spec = {"exp": EXP_SPEC, "inv": INV_SPEC, "rsqrt": RSQRT_SPEC}[name]
    return torch.from_numpy(build_table_np(spec, _FUNCTIONS[name])).to(device)


def exp_table(device: str | torch.device = "cuda") -> torch.Tensor:
    return _table("exp", str(resolve_device(device)))


def inv_table(device: str | torch.device = "cuda") -> torch.Tensor:
    return _table("inv", str(resolve_device(device)))


def rsqrt_table(device: str | torch.device = "cuda") -> torch.Tensor:
    return _table("rsqrt", str(resolve_device(device)))


# the lookups take the table on x's own device (a ``meta`` x too: the plain
# versions' shapes in a dry run)
def lut_exp(x: torch.Tensor) -> torch.Tensor:
    return lut_lookup(x, _table("exp", str(x.device)), EXP_SPEC)


def lut_inv(x: torch.Tensor) -> torch.Tensor:
    return lut_lookup(x, _table("inv", str(x.device)), INV_SPEC)


def lut_rsqrt(x: torch.Tensor) -> torch.Tensor:
    return lut_lookup(x, _table("rsqrt", str(x.device)), RSQRT_SPEC)
