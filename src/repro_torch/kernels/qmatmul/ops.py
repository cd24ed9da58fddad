"""Public entry points of the int8 GEMM: ``qmatmul`` (float inputs,
quantized here) and ``qmatmul_prequantized`` (``QTensor`` codes).

Both end in ``qmatmul_int8``: on CPU tensors it runs the plain version
(``ref.qmatmul_ref``), on CUDA tensors it launches ``csrc/qmatmul.cu`` or
raises.  The JAX package sends ``qmatmul_prequantized`` to its jnp
reference; the two compute the same function (equal int32 sums, the same
epilogue), and the card has no integer ``torch.matmul``, so here the tensor's
device alone decides.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core import quant, reuse
from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.qmatmul.ref import MAX_K, qmatmul_ref

_ALIGN = 16  # bytes: the kernel reads rows of codes in 16-byte chunks


@functools.lru_cache(maxsize=None)
def _lib():
    fn = build.library("qmatmul").repro_qmatmul
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def qmatmul_int8(
    x: torch.Tensor,  # (M, K) int8 codes
    w: torch.Tensor,  # (K, N) int8 codes
    x_scale: torch.Tensor,  # (M, 1) float32, per row
    w_scale: torch.Tensor,  # (1, N) float32, per column
    *,
    grid_k: int = 1,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``(x @ w) * (x_scale * w_scale)`` with an exact int32 sum, K walked
    in ``grid_k`` sequential chunks (the paper's reuse factor R)."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"qmatmul wants x (M, K) and w (K, N), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if x_scale.shape != (m, 1) or w_scale.shape != (1, n):
        raise ValueError(f"scales must be ({m}, 1) and (1, {n}), got "
                         f"{tuple(x_scale.shape)}, {tuple(w_scale.shape)}")
    if grid_k < 1:
        raise ValueError(f"grid_k must be >= 1, got {grid_k}")
    devices = {t.device for t in (x, w, x_scale, w_scale)}
    if len(devices) != 1:
        raise ValueError(f"qmatmul operands on different devices: {devices}")
    if x.device.type == "cpu":
        return qmatmul_ref(x, w, x_scale, w_scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"qmatmul runs on cpu or cuda, got {x.device}")

    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"qmatmul kernel takes int8 codes, got {x.dtype}, {w.dtype}")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise ValueError(f"qmatmul kernel takes float32 scales, got {x_scale.dtype}, "
                         f"{w_scale.dtype}")
    if not all(t.is_contiguous() for t in (x, w, x_scale, w_scale)):
        raise ValueError("qmatmul kernel needs contiguous codes and scales")
    if k >= MAX_K:
        raise ValueError(f"K = {k} overflows the int32 accumulator (K must be < {MAX_K})")
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=out_dtype, device=x.device)
    # Zero columns of x and zero rows / columns of w leave the int32 sum
    # unchanged; padding only happens when K or N is not a multiple of 16.
    pk, pn = -k % _ALIGN, -n % _ALIGN
    xp = F.pad(x, (0, pk)) if pk else x
    wp = F.pad(w, (0, pn, 0, pk)) if pk or pn else w
    if xp.data_ptr() % _ALIGN or wp.data_ptr() % _ALIGN:
        raise ValueError("qmatmul kernel needs 16-byte aligned codes")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = _lib()(
        xp.data_ptr(), wp.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), m, n, xp.shape[1], wp.shape[1], grid_k,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "qmatmul")
    LAUNCHES["qmatmul"] += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)


def qmatmul(
    x: torch.Tensor,  # (M, K) float
    w: torch.Tensor,  # (K, N) float
    *,
    reuse_factor: int = 1,
    strategy: reuse.Strategy = reuse.Strategy.LATENCY,
    precision=None,  # core.precision.Precision of kind int8: bits / granularity
) -> torch.Tensor:
    """Quantize x (per row) and w (per column) and multiply.

    The paper's reuse factor R maps to ``grid_k`` sequential contraction
    chunks (``core.reuse.plan_matmul``).  ``precision`` selects the code
    width (``bits``) and, with ``per_channel=False``, per-tensor scales.
    """
    bits, per_channel = 8, True
    if precision is not None:
        if precision.kind != "int8":
            raise ValueError(f"qmatmul expects an int8 precision, got {precision}")
        bits, per_channel = precision.bits, precision.per_channel
    m, k = x.shape
    n = w.shape[1]
    xq = quant.quantize_int8(x, axis=0 if per_channel else None, bits=bits)
    wq = quant.quantize_int8(w, axis=1 if per_channel else None, bits=bits)
    x_scale = xq.scale.reshape(-1, 1).expand(m, 1).contiguous()
    w_scale = wq.scale.reshape(1, -1).expand(1, n).contiguous()
    plan = reuse.plan_matmul(m, k, n, reuse_factor=reuse_factor, strategy=strategy,
                             bytes_per_elem=1)
    return qmatmul_int8(xq.values, wq.values, x_scale, w_scale, grid_k=plan.grid_k)


def qmatmul_prequantized(
    xq: quant.QTensor, wq: quant.QTensor, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """The GEMM of already-quantized tensors (stages 1 and 4 of the
    streaming MHA): per-row or per-tensor x scales, per-column or
    per-tensor w scales."""
    m, n = xq.values.shape[0], wq.values.shape[1]
    xs = (xq.scale.reshape(m, 1) if xq.axis is not None
          else xq.scale.reshape(1, 1).expand(m, 1)).contiguous()
    ws = (wq.scale.reshape(1, n) if wq.axis is not None
          else wq.scale.reshape(1, 1).expand(1, n)).contiguous()
    return qmatmul_int8(xq.values, wq.values, xs, ws, out_dtype=out_dtype)
