"""int8 tensors and the runtime fake-quant hook (port of ``repro.core.quant``).

``quantize_pytree_int8`` turns the float matrices of a nested dict into
``QTensor`` s for the int8 datapath (``kernels/qmatmul``); the fidelity
path has PTQ calibration (``PTQCalibrator``), the fixed-point tree
transforms (``quantize_pytree_fixed``, ``fake_quant_pytree``) and the
bit-width sweep of the AUC-versus-bits figures (``sweep_frac_bits``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import trace
from repro_torch.core import fixed_point as fxp
from repro_torch.device import scalar


@dataclasses.dataclass
class QTensor:
    """Integer codes + float scale; ``dequant = values * scale`` broadcast
    along ``axis`` (None = per-tensor scale)."""

    values: torch.Tensor
    scale: torch.Tensor
    axis: int | None = None

    @property
    def shape(self) -> torch.Size:
        return self.values.shape

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        scale = self.scale
        if self.axis is not None:
            bshape = [1] * self.values.ndim
            bshape[self.axis] = self.values.shape[self.axis]
            scale = scale.reshape(bshape)
        return self.values.to(dtype) * scale.to(dtype)


def quantize_int8(x: torch.Tensor, axis: int | None = None, bits: int = 8) -> QTensor:
    """Symmetric linear quantization to ``bits`` (default int8)."""
    qmax = 2 ** (bits - 1) - 1
    if axis is None:
        amax = torch.max(torch.abs(x))
    else:
        reduce_axes = tuple(i for i in range(x.ndim) if i != axis)
        amax = torch.amax(torch.abs(x), dim=reduce_axes)
    # a true division on both devices (device.scalar), as the reference's
    # eager quantizer divides
    scale = torch.clamp_min(amax, 1e-8) / scalar(float(qmax), amax.dtype, str(amax.device))
    if axis is None:
        codes = torch.round(x / scale)
    else:
        bshape = [1] * x.ndim
        bshape[axis] = x.shape[axis]
        codes = torch.round(x / scale.reshape(bshape))
    dtype = torch.int8 if bits <= 8 else torch.int16
    codes = torch.clamp(codes, -qmax - 1, qmax).to(dtype)
    return QTensor(codes, scale.to(torch.float32), axis)


def fake_quant_int8(x: torch.Tensor, axis: int | None = None, bits: int = 8) -> torch.Tensor:
    """Quantize-dequantize with STE gradient (int8 QAT)."""
    deq = quantize_int8(x.detach(), axis=axis, bits=bits).dequantize(x.dtype)
    return x + (deq - x).detach()


def quantize_pytree_int8(params, axis: int | None = 0):
    """Every float matrix leaf of a nested dict -> ``QTensor``, with one
    scale per output channel (the last axis), or per tensor when ``axis``
    is None.  1-D leaves (biases, norm scales) stay float, as the paper keeps
    bias precision above the datapath's."""
    if isinstance(params, dict):
        return {k: quantize_pytree_int8(v, axis) for k, v in params.items()}
    if isinstance(params, torch.Tensor) and params.is_floating_point() and params.ndim >= 2:
        return quantize_int8(params, axis=(params.ndim - 1) if axis is not None else None)
    return params


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Model-level quantization selection; the ``maybe_fake_quant_*`` hooks
    are what a resolved precision plan hands to each dense site."""

    mode: str = "none"  # none | ptq | qat | int8
    weight_cfg: fxp.FixedPointConfig | None = None
    act_cfg: fxp.FixedPointConfig | None = None
    accum_cfg: fxp.FixedPointConfig = fxp.ACCUM_CONFIG
    int8_weights: bool = False
    int8_kv_cache: bool = False
    lut_softmax: bool = False
    #: the plan slot the hook serves ("embed", "layer", "logits", "shared";
    #: "model" for a model-level config), named by its ``precision`` spans.
    #: Not a field, so the config compares and converts as the reference's:
    #: ``PrecisionPlan.quant_for`` sets it on the instance.
    slot = "model"

    def maybe_fake_quant_act(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "qat" and self.act_cfg is not None:
            with trace.span("precision", slot=self.slot, operand="act"):
                return fxp.quantize_ste(x, self.act_cfg)
        return x

    def maybe_fake_quant_weight(self, w: torch.Tensor) -> torch.Tensor:
        if self.mode == "qat" and self.weight_cfg is not None:
            with trace.span("precision", slot=self.slot, operand="weight"):
                return fxp.quantize_ste(w, self.weight_cfg)
        return w


# ---------------------------------------------------------------------------
# PTQ calibration and the fixed-point tree transforms (fidelity path)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CalibrationStats:
    """Running activation statistics collected over calibration batches."""

    amax: float = 0.0
    amin: float = 0.0
    n: int = 0

    def update(self, x: torch.Tensor) -> "CalibrationStats":
        return CalibrationStats(
            amax=max(self.amax, float(torch.max(x))),
            amin=min(self.amin, float(torch.min(x))),
            n=self.n + 1,
        )

    def required_int_bits(self) -> int:
        """Smallest signed integer width covering the observed range."""
        bound = max(abs(self.amax), abs(self.amin), 1e-8)
        return max(1, math.ceil(math.log2(bound) + 1e-12) + 1)


class PTQCalibrator:
    """Collects per-name activation stats and emits FixedPointConfigs:
    ``observe(name, x)`` over calibration batches, then ``configs()``."""

    def __init__(self, frac_bits: int, max_int_bits: int = fxp.ACCUM_INT_BITS):
        self.frac_bits = frac_bits
        self.max_int_bits = max_int_bits
        self.stats: dict[str, CalibrationStats] = {}

    def observe(self, name: str, x: torch.Tensor) -> torch.Tensor:
        self.stats[name] = self.stats.get(name, CalibrationStats()).update(x)
        return x

    def configs(self) -> dict[str, fxp.FixedPointConfig]:
        out = {}
        for name, st in self.stats.items():
            int_bits = min(st.required_int_bits(), self.max_int_bits)
            out[name] = fxp.ap_fixed(int_bits + self.frac_bits, int_bits)
        return out


def _map_float_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_float_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return fn(tree)
    return tree


def quantize_pytree_fixed(params: Any, cfg: fxp.FixedPointConfig) -> Any:
    """PTQ: snap every float leaf of a nested dict onto the ap_fixed grid."""
    return _map_float_leaves(lambda t: fxp.quantize(t, cfg), params)


def fake_quant_pytree(params: Any, cfg: fxp.FixedPointConfig) -> Any:
    """QAT: fake-quant every float leaf with clipped-STE gradients."""
    return _map_float_leaves(lambda t: fxp.quantize_ste(t, cfg), params)


def sweep_frac_bits(
    apply_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    params: Any,
    x: torch.Tensor,
    int_bits: int,
    frac_bits_list: list[int],
) -> dict[int, torch.Tensor]:
    """PTQ bit-width sweep (the AUC-versus-bits figures): ``apply_fn`` on
    the params snapped at ``ap_fixed<int_bits + fb, int_bits>`` per fb."""
    return {fb: apply_fn(quantize_pytree_fixed(params, fxp.ap_fixed(int_bits + fb, int_bits)), x)
            for fb in frac_bits_list}
