"""ap_fixed<W, I> semantics on float carriers (port of ``repro.core.fixed_point``).

W total bits (incl. sign), I integer bits (incl. sign), F = W - I
fractional bits; step ``2**-F``; range ``[-2**(I-1), 2**(I-1) - 2**-F]``.
Rounding is round-half-to-even (``torch.round``), as ``jnp.round`` does in
the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.device import scalar

# Paper, Sec. VI-A: accumulator integer width fixed at 10 bits incl. sign.
ACCUM_INT_BITS = 10

RoundMode = Literal["nearest", "floor"]
OverflowMode = Literal["saturate", "wrap"]


@dataclasses.dataclass(frozen=True)
class FixedPointConfig:
    """``ap_fixed<total_bits, int_bits>`` (both include the sign bit)."""

    total_bits: int
    int_bits: int
    signed: bool = True
    round_mode: RoundMode = "nearest"
    overflow_mode: OverflowMode = "saturate"

    def __post_init__(self):
        if self.total_bits < 1:
            raise ValueError(f"total_bits must be >= 1, got {self.total_bits}")
        if self.int_bits > self.total_bits:
            raise ValueError(
                f"int_bits ({self.int_bits}) cannot exceed total_bits "
                f"({self.total_bits})"
            )

    @property
    def frac_bits(self) -> int:
        return self.total_bits - self.int_bits

    @property
    def step(self) -> float:
        return 2.0 ** (-self.frac_bits)

    @property
    def max_value(self) -> float:
        if self.signed:
            return 2.0 ** (self.int_bits - 1) - self.step
        return 2.0 ** self.int_bits - self.step

    @property
    def min_value(self) -> float:
        if self.signed:
            return -(2.0 ** (self.int_bits - 1))
        return 0.0

    @property
    def n_levels(self) -> int:
        return 2 ** self.total_bits

    def with_frac_bits(self, frac_bits: int) -> "FixedPointConfig":
        return dataclasses.replace(self, total_bits=self.int_bits + frac_bits)

    def __str__(self) -> str:
        kind = "ap_fixed" if self.signed else "ap_ufixed"
        return f"{kind}<{self.total_bits},{self.int_bits}>"


def quantize(x: torch.Tensor, cfg: FixedPointConfig) -> torch.Tensor:
    """Round ``x`` onto the ap_fixed grid (returns a float carrier)."""
    scaled = x / cfg.step
    q = torch.round(scaled) if cfg.round_mode == "nearest" else torch.floor(scaled)
    lo = cfg.min_value / cfg.step
    if cfg.overflow_mode == "saturate":
        q = torch.clamp(q, lo, cfg.max_value / cfg.step)
        if lo == 0.0:  # jnp.clip's max(-0., 0.) is +0.: keep the reference's zero sign
            q = q + 0.0
    else:  # wrap (two's complement)
        q = torch.remainder(q - lo, float(cfg.n_levels)) + lo
    return q * cfg.step


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, whose gradient is
    split evenly at a tie (0.5 when x equals a bound), where ``torch.clamp``
    passes all of it.  ``lo`` and ``hi`` are numbers or tensors."""
    lo, hi = (b.to(x.device, x.dtype) if isinstance(b, torch.Tensor)
              else scalar(float(b), x.dtype, str(x.device)) for b in (lo, hi))
    return torch.minimum(torch.maximum(x, lo), hi)


def quantize_ste(x: torch.Tensor, cfg: FixedPointConfig) -> torch.Tensor:
    """Fake-quantize with a clipped straight-through-estimator gradient:
    identity inside the representable range, zero outside, half at its
    bounds, as the reference's ``jnp.clip``.

    The forward value is computed as the reference writes it,
    ``clipped + (quantize(x) - clipped)``, so it matches bit for bit.
    """
    clipped = clip(x, cfg.min_value, cfg.max_value)
    return clipped + (quantize(x, cfg) - clipped).detach()


def to_int(x: torch.Tensor, cfg: FixedPointConfig, dtype=torch.int32) -> torch.Tensor:
    """Integer codes of the fixed-point representation (perf-path bridge)."""
    return torch.round(quantize(x, cfg) / cfg.step).to(dtype)


def from_int(codes: torch.Tensor, cfg: FixedPointConfig, dtype=torch.float32) -> torch.Tensor:
    return codes.to(dtype) * cfg.step


def quantization_error_bound(cfg: FixedPointConfig) -> float:
    """Max |x - quantize(x)| for in-range x (used by property tests)."""
    if cfg.round_mode == "nearest":
        return cfg.step / 2.0
    return cfg.step


def ap_fixed(total_bits: int, int_bits: int, **kw) -> FixedPointConfig:
    return FixedPointConfig(total_bits=total_bits, int_bits=int_bits, **kw)


# The paper's per-model optima (Sec. VI-A): engine 6 frac bits (PTQ & QAT),
# b-tagging 10 (PTQ) / 6 (QAT), GW 6 (PTQ & QAT); 6 integer bits.
PAPER_OPTIMAL = {
    "engine_anomaly": {"ptq": ap_fixed(12, 6), "qat": ap_fixed(12, 6)},
    "btagging": {"ptq": ap_fixed(16, 6), "qat": ap_fixed(12, 6)},
    "gw": {"ptq": ap_fixed(12, 6), "qat": ap_fixed(12, 6)},
}

ACCUM_CONFIG = ap_fixed(ACCUM_INT_BITS + 8, ACCUM_INT_BITS)
