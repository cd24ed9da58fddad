"""Distributed-optimization collectives (port of
``repro.distributed.collectives``), over ``torch.distributed``.

1. **Compressed gradient all-reduce with error feedback**: each step
   quantizes (grad + error buffer) to int8 with one scale per leaf,
   all-reduces the dequantized codes, and keeps the quantization residual
   in the error buffer (error feedback makes the compression
   asymptotically unbiased).
2. **Ring collective matmul**: ``x @ w`` with w's contraction rows sharded
   over a mesh axis; each step multiplies the resident shard while the next
   one travels round the ring (``batch_isend_irecv``), hiding the exchange
   behind the products.

Each runs in every rank of the mesh axis it names, as the reference's
``shard_map`` bodies do; the axis's process group is the mesh's
(``DeviceMesh.get_group``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.device import scalar

PyTree = Any


def _axes(axis_name) -> tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def _all_reduce_sum(t: torch.Tensor, mesh, axis_name) -> torch.Tensor:
    for a in _axes(axis_name):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group(a))
    return t


# ---------------------------------------------------------------------------
# int8 compressed all-reduce with error feedback
# ---------------------------------------------------------------------------


def _quantize_block(x: torch.Tensor, bits: int = 8):
    """(int8 codes, float32 scale) of ``x``: one scale, max |x| / qmax,
    and codes round(x / scale), true divisions on both devices
    (``device.scalar``), as the reference's eager arithmetic."""
    qmax = 2 ** (bits - 1) - 1
    amax = torch.clamp_min(torch.max(torch.abs(x)), 1e-12)
    scale = amax / scalar(float(qmax), amax.dtype, str(amax.device))
    codes = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int8)
    return codes, scale


def compressed_psum_leaf(x: torch.Tensor, mesh, axis_name, error: torch.Tensor):
    """One leaf of the compressed all-reduce: (mean over ``axis_name``,
    new error).  ``x`` is this rank's gradient of the leaf."""
    corrected = x.to(torch.float32) + error
    codes, scale = _quantize_block(corrected)
    deq = codes.to(torch.float32) * scale
    new_error = corrected - deq  # residual kept locally (error feedback)
    summed = _all_reduce_sum(codes.to(torch.int32).to(torch.float32) * scale, mesh, axis_name)
    n = _all_reduce_sum(torch.ones((), dtype=torch.float32, device=x.device), mesh, axis_name)
    return (summed / n).to(x.dtype), new_error


def make_compressed_grad_allreduce(mesh, axis_name="data"):
    """``f(grads, errors) -> (mean_grads, new_errors)`` over trees of plain
    tensors, each rank holding its own gradients (data parallelism)."""

    def _fn(grads: PyTree, errors: PyTree):
        if isinstance(grads, dict):
            pairs = {k: _fn(grads[k], errors[k]) for k in grads}
            return ({k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()})
        return compressed_psum_leaf(grads, mesh, axis_name, errors)

    return _fn


def init_error_buffers(grads_abstract: PyTree) -> PyTree:
    """float32 zeros shaped as each gradient leaf, on its device (a ``meta``
    leaf gives a CPU buffer)."""
    if isinstance(grads_abstract, dict):
        return {k: init_error_buffers(v) for k, v in grads_abstract.items()}
    dev = getattr(grads_abstract, "device", None)
    dev = "cpu" if dev is None or dev.type == "meta" else dev
    return torch.zeros(tuple(grads_abstract.shape), dtype=torch.float32, device=dev)


# ---------------------------------------------------------------------------
# Ring collective matmul (the all-gather overlapped with the products)
# ---------------------------------------------------------------------------


def ring_collective_matmul(mesh, x: torch.Tensor, w, axis: str = "model") -> torch.Tensor:
    """``x @ w`` for x (m, k), whole on every rank, and w (k, n) with its
    rows sharded over ``axis``: a DTensor under ``Shard(0)`` there, or this
    rank's (k / shards, n) block as a plain tensor.  Equivalent to ``x @
    all_gather(w)``; every rank ends with the whole product."""
    from torch.distributed.tensor import DTensor

    w_cur = (w.to_local() if isinstance(w, DTensor) else w).contiguous()
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    n_shards = len(ranks)
    idx = mesh.get_local_rank(axis)
    chunk = w_cur.shape[0]
    if chunk * n_shards != x.shape[1]:
        raise ValueError(f"w's {chunk} rows x {n_shards} shards != x's {x.shape[1]} columns")
    send_to, recv_from = ranks[(idx - 1) % n_shards], ranks[(idx + 1) % n_shards]
    acc = torch.zeros((x.shape[0], w_cur.shape[1]), dtype=x.dtype, device=x.device)
    for i in range(n_shards):
        src = (idx + i) % n_shards  # the global k-chunk that w_cur holds
        reqs, w_nxt = [], None
        if i + 1 < n_shards:  # rotate the shards round the ring under the product
            w_nxt = torch.empty_like(w_cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, w_cur, send_to, group),
                dist.P2POp(dist.irecv, w_nxt, recv_from, group),
            ])
        acc = acc + x[:, src * chunk:(src + 1) * chunk] @ w_cur
        for r in reqs:
            r.wait()
        w_cur = w_nxt if w_nxt is not None else w_cur
    return acc
