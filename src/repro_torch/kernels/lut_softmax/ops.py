"""Public entry point of the paper's 3-stage LUT softmax: ``lut_softmax``
over the last axis of any leading shape.

On a CPU tensor it runs the plain version (``ref.lut_softmax_ref``); on a
CUDA tensor it launches ``csrc/lut_softmax.cu`` or raises.  With a ``fixed``
output precision the result is then snapped onto the ap_fixed grid, a torch
op after the kernel as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core import lut
from repro_torch.kernels import LAUNCHES, PLAIN_DEVICES, build, refuse_dtensor, require_no_grad
from repro_torch.kernels.lut_softmax.ref import lut_softmax_ref
from repro_torch.roofline import kernel_costs, op_counter


@functools.lru_cache(maxsize=None)
def _lib():
    fn = build.library("lut_softmax").repro_lut_softmax
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_float] * 4
        + [ctypes.c_void_p]
    )
    return fn


def _snap_output(out: torch.Tensor, precision) -> torch.Tensor:
    """Emit on an ap_fixed grid when a fixed output precision is given (the
    hardware datapath hands fixed-point rows to the next stage)."""
    if precision is None or getattr(precision, "kind", None) != "fixed":
        return out
    return fxp.quantize(out, precision.fixed_cfg())


def _kernel(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"lut_softmax kernel needs contiguous float32 scores, got "
                         f"{x.dtype}{'' if x.is_contiguous() else ' (not contiguous)'}")
    k = x.shape[-1]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    exp_tab, inv_tab = lut.exp_table(x.device), lut.inv_table(x.device)
    exp_off, exp_step = lut.index_constants(lut.EXP_SPEC)
    inv_off, inv_step = lut.index_constants(lut.INV_SPEC)
    err = _lib()(
        x.data_ptr(), out.data_ptr(), exp_tab.data_ptr(), inv_tab.data_ptr(),
        x.numel() // k, k, exp_off, exp_step, inv_off, inv_step,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "lut_softmax")
    LAUNCHES["lut_softmax"] += 1
    if op_counter.ACTIVE is not None:
        op_counter.ACTIVE.launch(kernel_costs.lut_softmax(x.numel() // k, k))
    return out


def lut_softmax(x: torch.Tensor, *, precision=None) -> torch.Tensor:
    """Softmax over the last axis through the paper's 3-stage LUT dataflow;
    ``precision`` (a ``core.precision.Precision``) of kind ``fixed`` puts the
    output on its ap_fixed grid."""
    refuse_dtensor("lut_softmax", x)
    if x.ndim == 0:
        raise ValueError("lut_softmax needs at least one axis")
    if x.device.type in PLAIN_DEVICES:
        counter = op_counter.ACTIVE
        if counter is None:
            out = lut_softmax_ref(x)
        else:
            k = x.shape[-1]
            with counter.plain_call(kernel_costs.lut_softmax(x.numel() // k if k else 0, k)):
                out = lut_softmax_ref(x)
    elif x.device.type == "cuda":
        require_no_grad("lut_softmax", x)
        out = _kernel(x)
    else:
        raise ValueError(f"lut_softmax runs on cpu, meta or cuda, got {x.device}")
    return _snap_output(out, precision)
