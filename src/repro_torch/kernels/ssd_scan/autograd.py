"""Gradients through the SSD chunked-scan kernel.

The kernel (``csrc/ssd_scan.cu``) writes its outputs through raw pointers,
so autograd cannot see through it.  ``SSDScan`` is a
``torch.autograd.Function`` whose forward is that kernel, unchanged (or any
function of the same signature: the tests inject the plain version), and
whose backward is the gradient of the plain chunked scan: it recomputes
``ref.ssd_chunked`` in float32 torch ops on the saved inputs and takes
``torch.autograd.grad`` of it.  The JAX package has no backward kernel
either: its model never calls the Pallas kernel, and trains through
XLA's autodiff of the jnp ``ssd_chunked``, the function recomputed here.

B and C come in by group, (b, l, g, n) with g dividing the h heads, as the
forward takes them; the recompute expands them per head with
``repeat_interleave``, whose gradient sums each group's heads back.  Either
output's cotangent may be ``None`` (a train forward uses y alone): the
backward then differentiates the other output only.  Each gradient comes
back in its input's dtype.  The masked entries of the in-chunk decay are
-inf before the ``exp``, so their gradient is exactly 0, never NaN.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_chunked


def ssd_backward(
    xdt: torch.Tensor,  # (b, l, h, p)
    a: torch.Tensor,  # (b, l, h)
    bmat: torch.Tensor,  # (b, l, g, n)
    cmat: torch.Tensor,  # (b, l, g, n)
    dy: torch.Tensor | None,  # (b, l, h, p): the cotangent of y
    dstate: torch.Tensor | None,  # (b, h, p, n): the cotangent of the final state
    *,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dxdt, da, dB, dC) of ``ssd_with_state`` at its inputs, dB and dC by
    group, each in its input's dtype, computed in float32."""
    rep = xdt.shape[2] // bmat.shape[2]
    f = torch.float32
    ins = [t.detach().to(f).requires_grad_() for t in (xdt, a, bmat, cmat)]
    with torch.enable_grad():
        y, state = ssd_chunked(ins[0], ins[1], ins[2].repeat_interleave(rep, dim=2),
                               ins[3].repeat_interleave(rep, dim=2), chunk=chunk)
        outs = [(o, d.to(f)) for o, d in ((y, dy), (state, dstate)) if d is not None]
        grads = torch.autograd.grad([o for o, _ in outs], ins, [d for _, d in outs],
                                    allow_unused=True) if outs else (None,) * 4
    return tuple(torch.zeros_like(t) if g is None else g.to(t.dtype)
                 for t, g in zip((xdt, a, bmat, cmat), grads))


class SSDScan(torch.autograd.Function):
    """``forward(xdt, a, bmat, cmat, chunk, forward)`` computes (y,
    final_state) (the CUDA kernel in ``ops.ssd_with_state``); the backward
    is :func:`ssd_backward` on the saved inputs."""

    @staticmethod
    def forward(ctx, xdt, a, bmat, cmat, chunk, forward):
        y, state = forward(xdt, a, bmat, cmat, chunk)
        ctx.save_for_backward(xdt, a, bmat, cmat)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # a missing cotangent stays None
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        grads = ssd_backward(*ctx.saved_tensors, dy, dstate, chunk=ctx.chunk)
        return (*grads, None, None)


def ssd_scan(xdt, a, bmat, cmat, *, chunk, forward):
    """``forward``'s scan with the gradient of :class:`SSDScan`."""
    return SSDScan.apply(xdt, a, bmat, cmat, chunk, forward)
