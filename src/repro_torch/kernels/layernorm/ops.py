"""Public entry point of the staged LayerNorm kernel.

On a CPU tensor it runs the plain version (``ref.layernorm_ref``); on a
CUDA tensor it launches ``csrc/layernorm.cu`` or raises.  ``x`` is float32,
bfloat16 or float16 and the output has its dtype; gamma and beta are float32
or ``x``'s dtype.  With a ``fixed`` output precision the result is then
snapped onto the ap_fixed grid, a torch op after the kernel as in the JAX
package.  Under grad mode, with any of x, gamma, beta requiring grad, the
launch goes through ``autograd.LayerNorm`` (the kernel forward, a backward
in torch ops).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import lut
from repro_torch.kernels import LAUNCHES, PLAIN_DEVICES, build, refuse_dtensor
from repro_torch.kernels.layernorm import autograd
from repro_torch.kernels.layernorm.ref import layernorm_ref, snap_output
from repro_torch.roofline import kernel_costs, op_counter

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The plan's routes, tuned on an H100 by tools/layernorm_routes.py; each
# (VEC, NV, team) they can give is an instance of csrc/layernorm.cu:dispatch.
# - Rows of up to 32 16-byte vectors: 1-32 lanes per row, NV = 1.
# - Up to FEW_ROWS rows (decode, short prefills): a block per row at 8
#   elements per thread, so the few rows are spread over many threads and
#   every SM gets a block (warp teams of 8 per block fill the 132 SMs only
#   from about 1056 rows).
# - Otherwise a warp per row up to the largest of _WARP_NV vectors per lane,
#   then a block per row of 32 * ceil(vectors / (32 * NV)) threads, NV the
#   first of _BLOCK_NV that keeps it within 512 threads.
# Single-element (VEC = 1) rows take the _SCALAR lists.
FEW_ROWS = 1024
_WARP_NV = (1, 2, 3, 4, 6)
_WARP_NV_SCALAR = (1, 2, 4, 8, 16)
_BLOCK_NV = (4, 8, 16)
_BLOCK_NV_SCALAR = (16, 32, 64)
_FEW_ROWS_ELEMS = 8
_MAX_THREADS = 512


@functools.lru_cache(maxsize=None)
def _entry(device: int):
    """The kernel's C entry, with device ``device``'s 1/sqrt table (kept
    alive by ``lut``'s own cache) and its index constants handed over once:
    built, bound and set up on the first call per device, not per launch."""
    lib = build.library("layernorm")
    setup = lib.repro_layernorm_set_table
    setup.restype = ctypes.c_int
    setup.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_float]
    tab = lut.rsqrt_table(torch.device("cuda", device))
    build.check(setup(device, tab.data_ptr(), *lut.index_constants(lut.RSQRT_SPEC)),
                "layernorm")
    fn = lib.repro_layernorm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def _zeros(device: int, k: int, dtype: torch.dtype) -> torch.Tensor:
    """The beta of a LayerNorm called without one."""
    return torch.zeros(k, device=torch.device("cuda", device), dtype=dtype)


@functools.lru_cache(maxsize=None)
def _plan(k: int, itemsize: int, vector: bool, few_rows: bool = False) -> tuple[int, int, int]:
    """(VEC, NV, lanes) of the instance for rows of ``k`` elements of
    ``itemsize`` bytes: VEC elements per load (16 bytes' worth when
    ``vector`` and k is a multiple of it, else 1), NV vectors per lane, and
    ``lanes`` lanes per row (a power of two up to 32) or, above 32, the size
    of the block that owns a row.  ``few_rows``: at most FEW_ROWS rows."""
    vec = 16 // itemsize
    if not vector or k % vec:
        vec = 1
    nvec = -(-k // vec)
    if vec > 1 and nvec <= 32:  # rows of up to 512 bytes: several rows per warp
        return vec, 1, 1 << (nvec - 1).bit_length()

    def block(nv):
        threads = 32 * -(-nvec // (32 * nv))
        return (vec, nv, threads) if 64 <= threads <= _MAX_THREADS else None

    if few_rows and (plan := block(max(1, _FEW_ROWS_ELEMS // vec))):
        return plan
    for nv in _WARP_NV if vec > 1 else _WARP_NV_SCALAR:  # a warp per row
        if 32 * nv >= nvec:
            return vec, nv, 32
    for nv in _BLOCK_NV if vec > 1 else _BLOCK_NV_SCALAR:  # a block per row
        if plan := block(nv):
            return plan
    raise ValueError(f"layernorm kernel holds a row in registers: K = {k} is too long")


@functools.lru_cache(maxsize=None)
def _flags(k: int, dtype_code: int, params_f32: bool, aligned: bool, few_rows: bool) -> int:
    """The C entry's packed ``flags`` but for the RMSNorm and LUT bits:
    dtype, params in float32, and the plan's VEC, NV and lanes."""
    vec, nv, lanes = _plan(k, 4 if dtype_code == 0 else 2, aligned, few_rows)
    return dtype_code | params_f32 << 2 | vec << 5 | nv << 10 | lanes << 17


def cost(x: torch.Tensor, gamma: torch.Tensor, use_lut: bool,
         rms: bool) -> kernel_costs.KernelCost:
    """The work of one ``layernorm`` call on these tensors."""
    k = x.shape[-1]
    return kernel_costs.layernorm(x.numel() // k if k else 0, k, x.dtype, rms=rms,
                                  use_lut=use_lut, param_dtype=gamma.dtype)


def _kernel(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor | None, use_lut: bool,
            rms: bool, eps: float) -> torch.Tensor:
    k = x.shape[-1]
    dev = x.get_device()
    if rms:
        beta = None  # not read
    elif beta is None:
        beta = _zeros(dev, k, gamma.dtype)
    code = _DTYPES.get(x.dtype)
    params_f32 = gamma.dtype == torch.float32
    if (code is None or not (params_f32 or gamma.dtype == x.dtype)
            or gamma.get_device() != dev or not gamma.is_contiguous()
            or (beta is not None and (beta.dtype != gamma.dtype or beta.get_device() != dev
                                      or not beta.is_contiguous()))):
        raise ValueError(
            f"layernorm kernel needs x of float32, bfloat16 or float16 and contiguous gamma "
            f"and beta of one dtype, float32 or x's, on x's device; got x {x.dtype} on "
            f"{x.device}, gamma {gamma.dtype} on {gamma.device}"
            + ("" if beta is None else f", beta {beta.dtype} on {beta.device}"))
    x = x.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // k if k else 0
    if rows == 0:
        return out
    xp, op, gp = x.data_ptr(), out.data_ptr(), gamma.data_ptr()
    bp = 0 if beta is None else beta.data_ptr()
    flags = (_flags(k, code, params_f32, not (xp | op | gp | bp) & 15, rows <= FEW_ROWS)
             | rms << 3 | use_lut << 4)
    stream = torch._C._cuda_getCurrentRawStream(dev)  # an int: no Stream object per call
    build.check(_entry(dev)(xp, gp, bp or None, op, rows, k, flags, eps, stream), "layernorm")
    LAUNCHES["layernorm"] += 1
    if op_counter.ACTIVE is not None:
        op_counter.ACTIVE.launch(cost(x, gamma, use_lut, rms))
    return out


def layernorm(
    x: torch.Tensor,  # (..., K)
    gamma: torch.Tensor,  # (K,)
    beta: torch.Tensor | None = None,  # (K,); None = zeros; ignored for RMSNorm
    *,
    use_lut: bool = False,
    rms: bool = False,
    eps: float = 1e-5,
    precision=None,  # core.precision.Precision (fixed): output grid
) -> torch.Tensor:
    refuse_dtensor("layernorm", x, gamma, beta)
    k = x.shape[-1]
    if gamma.shape != (k,) or (beta is not None and beta.shape != (k,)):
        raise ValueError(f"gamma/beta must be ({k},), got {tuple(gamma.shape)}, "
                         f"{None if beta is None else tuple(beta.shape)}")
    if x.is_cuda:
        if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, gamma, beta)
        ):
            out = autograd.layernorm(x, gamma, beta, use_lut=use_lut, rms=rms, eps=eps,
                                     forward=_kernel)
        else:
            out = _kernel(x, gamma, beta, use_lut, rms, eps)
        return out if precision is None else snap_output(out, precision)
    if x.device.type in PLAIN_DEVICES:
        counter = op_counter.ACTIVE
        if counter is None:
            return layernorm_ref(x, gamma, beta, use_lut=use_lut, rms=rms, eps=eps,
                                 precision=precision)
        with counter.plain_call(cost(x, gamma, use_lut, rms)):
            return layernorm_ref(x, gamma, beta, use_lut=use_lut, rms=rms, eps=eps,
                                 precision=precision)
    raise ValueError(f"layernorm runs on cpu, meta or cuda, got {x.device}")
