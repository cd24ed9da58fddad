"""Reuse factor (paper Sec. VI-B) as a block plan for the int8 GEMM.

On the FPGA, reuse factor ``R`` is the number of multiplications
time-multiplexed onto one DSP: R = 1 is fully parallel (most DSPs, least
latency), a larger R trades compute resources for initiation interval.

In the block plan, ``R`` is the sequentialization factor of the contraction
dimension: ``grid_k`` sequential chunks of K per output tile.  The plan and
its ``resource_estimate`` are copied from the JAX package's
``core/reuse.py`` field for field (its block constants included), so the
paper's R trade-off numbers agree between the two packages.  The CUDA
kernel (``csrc/qmatmul.cu``) takes only ``grid_k`` from the plan and picks
its own tiles.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class Strategy(enum.Enum):
    """hls4ml synthesis strategy (Sec. VI-B).

    LATENCY: fully pipelined, output every cycle -> widest block shapes.
    RESOURCE: time-multiplex hardware across stages -> reuse-factor loop.
    """

    LATENCY = "latency"
    RESOURCE = "resource"


# The reference plan's block granularities and fast-memory budget, kept
# unchanged so that every plan field matches the JAX package.
MXU_DIM = 128
LANE = 128
SUBLANE = 8
VMEM_BYTES = 128 * 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """Block plan for an (M,K) @ (K,N) kernel under a reuse factor."""

    block_m: int
    block_n: int
    block_k: int
    grid_m: int
    grid_n: int
    grid_k: int  # == reuse factor (sequential contraction passes)
    vmem_bytes: int

    @property
    def interval(self) -> int:
        """Sequential passes per output tile (the initiation-interval analogue)."""
        return self.grid_k


def plan_matmul(
    m: int,
    k: int,
    n: int,
    *,
    reuse_factor: int = 1,
    strategy: Strategy = Strategy.LATENCY,
    bytes_per_elem: int = 1,  # int8 datapath by default
    accum_bytes: int = 4,  # int32/float32 accumulator
    max_block_m: int = 512,
) -> MatmulPlan:
    """Translate (shape, R, strategy) into block shapes.

    R divides the contraction dim K into R sequential chunks.  Under the
    RESOURCE strategy, output tiles are narrowed first (time-multiplexing
    the multiplier array across output columns) before K is split.
    """
    if reuse_factor < 1:
        raise ValueError(f"reuse_factor must be >= 1, got {reuse_factor}")
    m_pad = _round_up(max(m, 1), SUBLANE)
    k_pad = _round_up(max(k, 1), LANE)
    n_pad = _round_up(max(n, 1), LANE)

    block_m = min(m_pad, max_block_m)
    if strategy is Strategy.LATENCY:
        block_n = n_pad
    else:
        block_n = min(n_pad, MXU_DIM)  # one column stripe at a time

    # reuse factor: split K into R sequential chunks (>= one lane each)
    grid_k = min(reuse_factor, max(1, k_pad // LANE))
    block_k = _round_up(k_pad // grid_k, LANE)
    grid_k = math.ceil(k_pad / block_k)

    def working_set(bm: int) -> int:
        return (
            bm * block_k * bytes_per_elem  # lhs tile
            + block_k * block_n * bytes_per_elem  # rhs tile
            + bm * block_n * accum_bytes  # accumulator
        )

    vmem = working_set(block_m)
    # shrink block_m until the working set fits (with double buffering)
    while vmem * 2 > VMEM_BYTES and block_m > SUBLANE:
        block_m //= 2
        vmem = working_set(block_m)

    return MatmulPlan(
        block_m=block_m,
        block_n=block_n,
        block_k=block_k,
        grid_m=math.ceil(m_pad / block_m),
        grid_n=math.ceil(n_pad / block_n),
        grid_k=grid_k,
        vmem_bytes=vmem,
    )


@dataclasses.dataclass(frozen=True)
class ResourceEstimate:
    """The paper's resource/latency axes in block-plan units.

    ``macs``        - multiply-accumulates (DSP-op analogue)
    ``vmem_bytes``  - live fast-memory working set (register/BRAM analogue)
    ``passes``      - sequential block passes (latency cycles analogue)
    ``interval``    - passes per new output tile (initiation interval)
    """

    macs: int
    vmem_bytes: int
    passes: int
    interval: int


def resource_estimate(plan: MatmulPlan) -> ResourceEstimate:
    total_passes = plan.grid_m * plan.grid_n * plan.grid_k
    macs = (
        plan.block_m * plan.block_n * plan.block_k
        * plan.grid_m * plan.grid_n * plan.grid_k
    )
    return ResourceEstimate(
        macs=macs,
        vmem_bytes=plan.vmem_bytes,
        passes=total_passes,
        interval=plan.interval,
    )
