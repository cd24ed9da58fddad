"""Public attention entry point: ``mha`` over (B, H, L, D) tensors.

On a CPU or ``meta`` tensor it runs the plain version (``ref.mha_ref``); on
a CUDA tensor it launches the hand-written kernel
(``csrc/flash_attention.cu``) or raises.  GQA is mapped by head index
inside the kernel.  V may have its own
head_dim ``dv <= d`` (MLA: q/k 96, V 64); the output has V's.  Every
head_dim runs on the tensor cores:
- 8, 16 and 32: one warp per 16 query rows, heads packed into blocks, K/V
  staged once per head and block by cp.async, float32 as 3xTF32 on
  mma.sync (bf16 on mma.sync too); any contiguous q, k, v (4- or 2-byte
  copies when one is not 16-byte aligned);
- (q/k, V) = (64, 64), (96, 64) and (128, 128): 64 query rows per block,
  bf16 on wgmma, float32 as 3xTF32 on wgmma (each operand split once into
  TF32 halves, V transposed per tile), K/V tiles copied by TMA straight
  from the unpadded tensors (which needs 16-byte aligned q, k, v), the grid
  ordered so the blocks in flight share a few heads' K/V in L2.  At MLA's
  (96, 64) the bf16 route is bound by the softmax and bf16 conversions
  around the products, the float32 route by the splits and the transpose
  on the CUDA cores (PERF.md).
Any other head_dim up to 128 with ``dv == d`` is zero-padded to the next
square instance (zeros add nothing to q.k and give zero output columns,
which are sliced off), with the scale kept at 1/sqrt(true head_dim); any
other (d, dv) pair raises.  Those pad copies (q, k, v in, the output's
slice out) run under the profiler scope ``PAD_SCOPE``.  A ``safe`` row that
sees no key (a window that ends before ``kv_len``) gives the mean of V over
every key, as ``mha_ref``'s softmax of a row masked everywhere; in ``lut``
mode it gives 0, as there.  Under grad mode, with any of q, k, v requiring
grad, the launch goes through ``autograd.Attention`` (the kernel forward, a
backward in torch ops).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core import lut
from repro_torch.kernels import LAUNCHES, PLAIN_DEVICES, build, refuse_dtensor
from repro_torch.kernels.flash_attention import autograd
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.roofline import kernel_costs, op_counter

INSTANCES = ((8, 8), (16, 16), (32, 32), (64, 64), (96, 64), (128, 128))  # (q/k, V)
TMA_DIMS = (64, 96, 128)  # K/V by TMA: q, k, v must be 16-byte aligned
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"safe": 0, "lut": 1}
#: the profiler scope of the zero-pad copies around a padded head_dim's launch
PAD_SCOPE = "flash_attention.pad"


@functools.lru_cache(maxsize=None)
def _lib():
    fn = build.library("flash_attention").repro_flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_float] * 5
        + [ctypes.c_void_p]
    )
    return fn


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple:
    """Device pointers of the exp and 1/x tables (kept alive by ``lut``'s own
    cache) and their index constants: looked up once per device, not per call."""
    exp_tab, inv_tab = lut.exp_table(device), lut.inv_table(device)
    return (exp_tab.data_ptr(), inv_tab.data_ptr(), *lut.index_constants(lut.EXP_SPEC),
            *lut.index_constants(lut.INV_SPEC))


def kernel_head_dims(d: int, dv: int | None = None) -> tuple[int, int]:
    """The (q/k, V) head_dims the kernel runs for true ones ``(d, dv)``: the
    pair itself where an instance takes it; a square pair (``dv == d``, the
    default) zero-padded to the smallest square instance that holds it; any
    other pair raises."""
    dv = d if dv is None else dv
    if (d, dv) in INSTANCES:
        return d, dv
    if dv == d:
        for hd, hv in INSTANCES:
            if hd == hv >= d:
                return hd, hv
        raise ValueError(f"head_dim {d} is above the kernel's largest, {INSTANCES[-1][0]}")
    raise ValueError(f"no kernel instance for q/k head_dim {d} with V head_dim {dv} "
                     f"(instances: {INSTANCES})")


def mha(
    q: torch.Tensor,  # (B, Hq, Lq, D)
    k: torch.Tensor,  # (B, Hkv, Lkv, D)
    v: torch.Tensor,  # (B, Hkv, Lkv, Dv), Dv <= D
    *,
    causal: bool = False,
    window: int | None = None,
    mode: str = "safe",
    kv_len: int | None = None,  # true (unpadded) kv length; keys past it are masked
) -> torch.Tensor:  # (B, Hq, Lq, Dv)
    refuse_dtensor("flash_attention", q, k, v)
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"mha wants q (B,Hq,Lq,D), k (B,Hkv,Lkv,D), v (B,Hkv,Lkv,Dv); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, lq, d = q.shape
    _, hkv, lkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hq % hkv != 0 or v.shape[3] > d:
        raise ValueError(f"incompatible q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)}")
    if mode not in _MODES:
        raise ValueError(f"unknown softmax mode {mode!r}")
    kv_len = lkv if kv_len is None else kv_len
    if not 1 <= kv_len <= lkv or (window is not None and window < 1):
        raise ValueError(f"need 1 <= kv_len <= {lkv} and window >= 1")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v on different devices: {devices}")
    if q.device.type in PLAIN_DEVICES:
        counter = op_counter.ACTIVE
        if counter is None:
            return mha_ref(q, k, v, causal=causal, window=window, mode=mode, kv_len=kv_len)
        with counter.plain_call(cost(q, k, v, causal=causal, window=window, mode=mode,
                                     kv_len=kv_len)):
            return mha_ref(q, k, v, causal=causal, window=window, mode=mode, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"mha runs on cpu, meta or cuda, got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return autograd.attention(q, k, v, causal=causal, window=window, mode=mode,
                                  kv_len=kv_len, forward=_kernel)
    return _kernel(q, k, v, causal=causal, window=window, mode=mode, kv_len=kv_len)


def cost(q, k, v, *, causal, window, mode, kv_len) -> kernel_costs.KernelCost:
    """The work of one ``mha`` call on these tensors."""
    b, hq, lq, d = q.shape
    _, hkv, lkv, _ = k.shape
    return kernel_costs.flash_attention(b, hq, hkv, lq, lkv, d, v.shape[3], q.dtype,
                                        causal=causal, window=window, mode=mode, kv_len=kv_len)


def _kernel(q, k, v, *, causal, window, mode, kv_len):
    """One launch of the kernel on CUDA tensors (validated by ``mha``)."""
    b, hq, lq, d = q.shape
    _, hkv, lkv, _ = k.shape
    dv = v.shape[3]
    dk, dvk = kernel_head_dims(d, dv)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share float32 or bfloat16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("mha kernel needs contiguous q, k, v")
    q_in, k_in, v_in = q, k, v  # the call's own tensors, whose work a counter is told
    if dk != d:  # a square head_dim between instances: fresh, contiguous and aligned
        with torch.profiler.record_function(PAD_SCOPE):  # a profiler's handle on the copies
            q, k, v = (F.pad(t, (0, dk - d)) for t in (q, k, v))
    if dk in TMA_DIMS and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("mha kernel at head_dim 64/96/128 needs 16-byte aligned q, k, v (TMA)")
    out = q.new_empty((b, hq, lq, dvk))
    # a safe row that sees no key (q >= kv_len + window - 1) takes the mean of
    # V over every key, as mha_ref; the kernel computes it into this scratch
    keyless = mode == "safe" and window is not None and lq >= kv_len + window
    vmean = torch.empty((b * hkv, dvk), dtype=torch.float32, device=q.device) if keyless else None
    exp_ptr, inv_ptr, exp_off, exp_step, inv_off, inv_step = _tables(q.device)
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), exp_ptr, inv_ptr,
        None if vmean is None else vmean.data_ptr(),
        b, hq, hkv, lq, lkv, dk, dvk, kv_len, int(causal),
        0 if window is None else window, _MODES[mode], _DTYPES[q.dtype],
        1.0 / (d ** 0.5), exp_off, exp_step, inv_off, inv_step,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    if op_counter.ACTIVE is not None:
        op_counter.ACTIVE.launch(cost(q_in, k_in, v_in, causal=causal, window=window,
                                      mode=mode, kv_len=kv_len))
    if dvk == dv:
        return out
    with torch.profiler.record_function(PAD_SCOPE):
        return out[..., :dv].contiguous()
