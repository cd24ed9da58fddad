"""Public entry points of the SSD chunked-scan kernel, in the (b, l, h, p)
layout of the reference's ``kernels/ssd_scan/ops.ssd``.

``ssd`` returns y; ``ssd_with_state`` returns (y, final_state) for
``models.ssm.mamba_apply`` and takes B and C per group, (b, l, g, n) with g
dividing h (head i reads group i // (h / g)), so the per-head copies are
never made.  On CPU tensors they run the plain version (``ref.ssd_chunked``);
on CUDA tensors they launch ``csrc/ssd_scan.cu`` or raise, through
``autograd.SSDScan`` when an input requires grad (the kernel forward, the
plain scan's gradient as the backward).  Inputs are
float32 or bfloat16, computed in float32; y has the input type and the final
state is float32.  One call on the card is three device kernels (chunk
states, state passing, output) and counts as one launch of ``ssd_scan``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, PLAIN_DEVICES, build, refuse_dtensor
from repro_torch.kernels.ssd_scan import autograd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.roofline import kernel_costs, op_counter

MAX_CHUNK, MAX_P, MAX_N = 64, 128, 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib():
    fn = build.library("ssd_scan").repro_ssd_scan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def _states_floats():
    fn = build.library("ssd_scan").repro_ssd_scan_states_floats
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 6
    return fn


def _check(xdt, a, bmat, cmat, chunk):
    if xdt.ndim != 4 or a.ndim != 3 or bmat.ndim != 4 or cmat.shape != bmat.shape:
        raise ValueError(f"ssd needs xdt (b,l,h,p), a (b,l,h), B and C (b,l,g,n); got "
                         f"{tuple(xdt.shape)}, {tuple(a.shape)}, {tuple(bmat.shape)}, "
                         f"{tuple(cmat.shape)}")
    b, l, h, _ = xdt.shape
    g = bmat.shape[2]
    if a.shape != (b, l, h) or bmat.shape[:2] != (b, l) or h % g:
        raise ValueError(f"ssd shapes disagree: xdt {tuple(xdt.shape)}, a {tuple(a.shape)}, "
                         f"B/C {tuple(bmat.shape)} (groups must divide the {h} heads)")
    chunk = min(chunk, l)
    if chunk < 1 or l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the chunk {chunk}")
    return chunk


def cost(xdt, bmat, chunk) -> kernel_costs.KernelCost:
    """The work of one ``ssd_with_state`` call on these tensors."""
    b, l, h, p = xdt.shape
    g, n = bmat.shape[2:]
    return kernel_costs.ssd_scan(b, l, h, p, n, g, chunk, xdt.dtype)


def _kernel(xdt, a, bmat, cmat, chunk):
    b, l, h, p = xdt.shape
    g, n = bmat.shape[2:]
    if chunk > MAX_CHUNK or p > MAX_P or n > MAX_N:
        raise ValueError(f"ssd_scan kernel takes chunk <= {MAX_CHUNK}, P <= {MAX_P}, "
                         f"N <= {MAX_N}; got chunk {chunk}, P {p}, N {n}")
    for name, t in (("xdt", xdt), ("a", a), ("B", bmat), ("C", cmat)):
        if t.device != xdt.device or t.dtype != xdt.dtype or not t.is_contiguous():
            raise ValueError(f"ssd_scan kernel needs contiguous {name} of one type on one "
                             f"device, got {t.dtype} on {t.device}")
    if xdt.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan kernel takes float32 or bfloat16, got {xdt.dtype}")
    y = torch.empty_like(xdt)
    f32 = dict(dtype=torch.float32, device=xdt.device)
    state = torch.empty((b, h, p, n), **f32)
    # scratch: each chunk's state, then the state entering it (rows padded as
    # the kernel lays them out); exp of each chunk's summed decay
    states = torch.empty(_states_floats()(b, l, h, p, n, chunk), **f32)
    decay = torch.empty((b, h, l // chunk), **f32)
    err = _lib()(
        xdt.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), y.data_ptr(),
        state.data_ptr(), states.data_ptr(), decay.data_ptr(), b, l, h, p, g, n, chunk,
        _DTYPES[xdt.dtype],
        torch.cuda.current_stream(xdt.device).cuda_stream,
    )
    build.check(err, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    if op_counter.ACTIVE is not None:
        op_counter.ACTIVE.launch(cost(xdt, bmat, chunk))
    return y, state


def ssd_with_state(
    xdt: torch.Tensor,  # (b, l, h, p) inputs pre-multiplied by dt
    a: torch.Tensor,  # (b, l, h) log-decay
    bmat: torch.Tensor,  # (b, l, g, n), g dividing h
    cmat: torch.Tensor,  # (b, l, g, n)
    *,
    chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (b, l, h, p), final_state (b, h, p, n) float32); ``chunk`` is
    clipped to l, which must be a multiple of it."""
    refuse_dtensor("ssd_scan", xdt, a, bmat, cmat)
    chunk = _check(xdt, a, bmat, cmat, chunk)
    if xdt.device.type == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (xdt, a, bmat, cmat)):
            return autograd.ssd_scan(xdt, a, bmat, cmat, chunk=chunk, forward=_kernel)
        return _kernel(xdt, a, bmat, cmat, chunk)
    if xdt.device.type not in PLAIN_DEVICES:
        raise ValueError(f"ssd runs on cpu, meta or cuda, got {xdt.device}")
    counter = op_counter.ACTIVE
    if counter is None:
        return _plain(xdt, a, bmat, cmat, chunk)
    with counter.plain_call(cost(xdt, bmat, chunk)):
        return _plain(xdt, a, bmat, cmat, chunk)


def _plain(xdt, a, bmat, cmat, chunk):
    rep = xdt.shape[2] // bmat.shape[2]
    f = torch.float32
    y, state = ssd_chunked(
        xdt.to(f), a.to(f), bmat.to(f).repeat_interleave(rep, dim=2),
        cmat.to(f).repeat_interleave(rep, dim=2), chunk=chunk,
    )
    return y.to(xdt.dtype), state


def ssd(
    xdt: torch.Tensor,  # (b, l, h, p)
    a: torch.Tensor,  # (b, l, h)
    bmat: torch.Tensor,  # (b, l, h, n)
    cmat: torch.Tensor,  # (b, l, h, n)
    *,
    chunk: int = 64,
) -> torch.Tensor:
    """The reference's ``ssd``: y (b, l, h, p) of the chunked scan."""
    return ssd_with_state(xdt, a, bmat, cmat, chunk=chunk)[0]
