"""int8 tensors and the runtime fake-quant hook (port of ``repro.core.quant``).

``quantize_pytree_int8`` turns the float matrices of a nested dict into
``QTensor`` s for the int8 datapath (``kernels/qmatmul``).  PTQ calibration
and the fixed-point pytree sweeps wait for the training slice.
"""

from __future__ import annotations

import dataclasses

import torch

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

    def maybe_fake_quant_act(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "qat" and self.act_cfg is not None:
            return fxp.quantize_ste(x, self.act_cfg)
        return x

    def maybe_fake_quant_weight(self, w: torch.Tensor) -> torch.Tensor:
        if self.mode == "qat" and self.weight_cfg is not None:
            return fxp.quantize_ste(w, self.weight_cfg)
        return w
