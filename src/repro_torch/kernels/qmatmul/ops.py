"""Public entry points of the int8 GEMM: ``qmatmul`` (float inputs,
quantized here) and ``qmatmul_prequantized`` (``QTensor`` codes).

Both end in ``qmatmul_int8``: on CPU tensors it runs the plain version
(``ref.qmatmul_ref``), on CUDA tensors it launches one of the two routes of
``csrc/qmatmul.cu`` (:func:`route`, by shape alone) or raises.  The JAX
package sends ``qmatmul_prequantized`` to its jnp reference; the two compute
the same function (equal int32 sums, the same epilogue), and the card has no
integer ``torch.matmul``, so here the tensor's device alone decides.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core import quant, reuse
from repro_torch.kernels import LAUNCHES, PLAIN_DEVICES, build, refuse_dtensor, require_no_grad
from repro_torch.kernels.qmatmul.ref import MAX_K, qmatmul_ref
from repro_torch.roofline import kernel_costs, op_counter

_ALIGN = 16  # bytes: TMA moves rows whose strides are multiples of 16
STREAM_MAX = 64  # the streaming route's largest K and N

# launches per route, beside LAUNCHES["qmatmul"]; only a caller resets it
ROUTES: collections.Counter = collections.Counter()


def route(k: int, n: int) -> str:
    """The kernel route of an (M, K) x (K, N) product on the card.

    ``"stream"``: K and N at most 64, the physics encoders' projections,
    bound by the float32 output.  ``"wide"``: every other shape, on
    ``wgmma`` with the weights K-major."""
    return "stream" if k <= STREAM_MAX and n <= STREAM_MAX else "wide"


@functools.lru_cache(maxsize=None)
def _lib():
    fn = build.library("qmatmul").repro_qmatmul
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    return fn


def qmatmul_int8(
    x: torch.Tensor,  # (M, K) int8 codes
    w: torch.Tensor,  # (K, N) int8 codes
    x_scale: torch.Tensor,  # (M, 1) float32, per row
    w_scale: torch.Tensor,  # (1, N) float32, per column
    *,
    grid_k: int = 1,
    out_dtype: torch.dtype = torch.float32,
    w_kmajor: torch.Tensor | None = None,  # (N, K) int8: w.t().contiguous(), made once
) -> torch.Tensor:
    """``(x @ w) * (x_scale * w_scale)`` with an exact int32 sum, K walked
    in ``grid_k`` sequential chunks (the paper's reuse factor R).

    ``w_kmajor`` is the operand both kernel routes read; without it the
    wrapper makes the copy on every call."""
    refuse_dtensor("qmatmul", x, w, x_scale, w_scale, w_kmajor)
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
    operands = [x, w, x_scale, w_scale]
    if w_kmajor is not None:
        if w_kmajor.shape != (n, k) or w_kmajor.dtype != w.dtype:
            raise ValueError(f"w_kmajor must be w's codes as ({n}, {k}) {w.dtype}, got "
                             f"{tuple(w_kmajor.shape)} {w_kmajor.dtype}")
        operands.append(w_kmajor)
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"qmatmul operands on different devices: {devices}")
    if x.device.type in PLAIN_DEVICES:
        counter = op_counter.ACTIVE
        if counter is None:
            return qmatmul_ref(x, w, x_scale, w_scale, out_dtype)
        with counter.plain_call(kernel_costs.qmatmul(m, k, n)):
            return qmatmul_ref(x, w, x_scale, w_scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"qmatmul runs on cpu, meta or cuda, got {x.device}")
    require_no_grad("qmatmul", *operands)  # the scales carry the float inputs' gradient
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"qmatmul kernel takes int8 codes, got {x.dtype}, {w.dtype}")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise ValueError(f"qmatmul kernel takes float32 scales, got {x_scale.dtype}, "
                         f"{w_scale.dtype}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("qmatmul kernel needs contiguous codes and scales")
    if k >= MAX_K:
        raise ValueError(f"K = {k} overflows the int32 accumulator (K must be < {MAX_K})")
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=out_dtype, device=x.device)
    # Zero columns of x (and of the K-major w) leave the int32 sum unchanged;
    # they are added only when K is not a positive multiple of 16.  The
    # output's rows are padded to a multiple of 4 floats (16 bytes) only when
    # N is not one.
    pk, ldo = max(_ALIGN, k + -k % _ALIGN) - k, n + (-n % 4)
    xp = F.pad(x, (0, pk)) if pk else x
    out = torch.empty((m, ldo), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    wt = w.t() if w_kmajor is None else w_kmajor
    wt = F.pad(wt, (0, pk)).contiguous() if pk else wt.contiguous()
    if xp.data_ptr() % _ALIGN or wt.data_ptr() % _ALIGN:
        raise ValueError("qmatmul kernel needs 16-byte aligned codes")
    path = route(k, n)
    err = _lib()(path == "wide", xp.data_ptr(), wt.data_ptr(), x_scale.data_ptr(),
                 w_scale.data_ptr(), out.data_ptr(), m, n, ldo, k + pk, grid_k, stream)
    build.check(err, "qmatmul")
    LAUNCHES["qmatmul"] += 1
    ROUTES[path] += 1
    if op_counter.ACTIVE is not None:
        op_counter.ACTIVE.launch(kernel_costs.qmatmul(m, k, n))
    if ldo != n:
        out = out[:, :n].contiguous()
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
    xq: quant.QTensor, wq: quant.QTensor, out_dtype: torch.dtype = torch.float32,
    w_kmajor: torch.Tensor | None = None,
) -> torch.Tensor:
    """The GEMM of already-quantized tensors (stages 1 and 4 of the
    streaming MHA): per-row or per-tensor x scales, per-column or
    per-tensor w scales; ``w_kmajor`` as in :func:`qmatmul_int8`."""
    m, n = xq.values.shape[0], wq.values.shape[1]
    xs = (xq.scale.reshape(m, 1) if xq.axis is not None
          else xq.scale.reshape(1, 1).expand(m, 1)).contiguous()
    ws = (wq.scale.reshape(1, n) if wq.axis is not None
          else wq.scale.reshape(1, 1).expand(1, n)).contiguous()
    return qmatmul_int8(xq.values, wq.values, xs, ws, out_dtype=out_dtype, w_kmajor=w_kmajor)
