"""Gradients through the staged LayerNorm kernel.

The kernel (``csrc/layernorm.cu``) writes its output through a raw pointer,
so autograd cannot see through it.  ``LayerNorm`` is a
``torch.autograd.Function`` whose forward is that kernel, unchanged (or any
function of the same signature: the tests inject the plain version), and
whose backward is the norm's gradient written as torch ops, the counterpart
of XLA's autodiff of the JAX package's jnp ``layernorm_paper`` / ``rmsnorm``
(the reference trains through those; it has no backward kernel).  The row
statistics are recomputed in float32 from the saved x.  With
g = dout · gamma and x̂ = (x − mean) · inv (LayerNorm) or x · inv (RMSNorm):

- ``rsqrt(var + eps)``: dx = inv · (g − mean(g) − x̂ · mean(g · x̂)), the
  mean(g) term for LayerNorm only;
- the LUT 1/√ (``use_lut``): the lookup picks an entry by rounding and
  carries no gradient, so inv is a constant: dx = inv · (g − mean(g)) for
  LayerNorm (the mean path carries the gradient) and inv · g for RMSNorm;
- dgamma = Σ_rows dout · x̂, dbeta = Σ_rows dout (LayerNorm with a beta).

x may be bf16 or fp16 with float32 params; each gradient comes back in its
input's dtype.  A fixed-point ``precision=`` snap is applied outside the
Function (``ops.layernorm``), and its gradient is that of
``fixed_point.quantize``: zero through the rounding, as the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.core import lut


def layernorm_backward(
    x: torch.Tensor,  # (..., K)
    gamma: torch.Tensor,  # (K,)
    dout: torch.Tensor,  # (..., K)
    *,
    use_lut: bool = False,
    rms: bool = False,
    eps: float = 1e-5,
    beta_dtype: torch.dtype | None = None,  # None: no beta (or RMSNorm)
):
    """(dx, dgamma, dbeta) of the staged norm at x; dbeta is None when
    ``beta_dtype`` is None or for RMSNorm."""
    k = x.shape[-1]
    xf, dof = x.float(), dout.float()
    if rms:
        stat = torch.sum(xf * xf, dim=-1, keepdim=True) / k
    else:
        xf = xf - torch.sum(xf, dim=-1, keepdim=True) / k
        stat = torch.sum(xf * xf, dim=-1, keepdim=True) / k
    inv = lut.lut_rsqrt(stat) if use_lut else torch.rsqrt(stat + eps)
    xhat = xf * inv
    g = dof * gamma.float()
    proj = None if use_lut else torch.sum(g * xhat, dim=-1, keepdim=True) / k
    if not rms:
        g = g - torch.sum(g, dim=-1, keepdim=True) / k
    if proj is not None:  # the gradient through the statistics' 1/sqrt
        g = g - xhat * proj
    dx = (inv * g).to(x.dtype)
    dgamma = torch.sum((dof * xhat).reshape(-1, k), dim=0).to(gamma.dtype)
    dbeta = None
    if beta_dtype is not None and not rms:
        dbeta = torch.sum(dof.reshape(-1, k), dim=0).to(beta_dtype)
    return dx, dgamma, dbeta


class LayerNorm(torch.autograd.Function):
    """``forward(x, gamma, beta, use_lut, rms, eps)`` computes the norm (the
    CUDA kernel in ``ops.layernorm``); the backward is
    :func:`layernorm_backward` on the saved x and gamma."""

    @staticmethod
    def forward(ctx, x, gamma, beta, use_lut, rms, eps, forward):
        out = forward(x, gamma, beta, use_lut, rms, eps)
        ctx.save_for_backward(x, gamma)
        ctx.opts = dict(use_lut=use_lut, rms=rms, eps=eps,
                        beta_dtype=None if beta is None else beta.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = layernorm_backward(x, gamma, dout, **ctx.opts)
        return dx, dgamma, dbeta, None, None, None, None


def layernorm(x, gamma, beta=None, *, use_lut=False, rms=False, eps=1e-5, forward):
    """``forward``'s norm with the gradient of :class:`LayerNorm`."""
    return LayerNorm.apply(x, gamma, None if rms else beta, use_lut, rms, eps, forward)
