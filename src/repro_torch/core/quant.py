"""int8 tensors and the runtime fake-quant hook (port of ``repro.core.quant``).

PTQ calibration and the pytree sweep helpers wait for the training slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import fixed_point as fxp


@dataclasses.dataclass
class QTensor:
    """Integer codes + float scale; ``dequant = values * scale`` broadcast
    along ``axis`` (None = per-tensor scale)."""

    values: torch.Tensor
    scale: torch.Tensor
    axis: int | None = None

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
    scale = torch.clamp_min(amax, 1e-8) / qmax
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
