"""Mixture-of-experts with capacity dispatch (port of ``repro.models.moe``):
top-k routing, per-expert capacity ``C``, (E, C, d) expert batches, batched
expert GEMMs, weighted combine.

The router softmax is the paper's restructured 3-stage form
(``core/softmax.softmax_paper_exact``), in float32.  What the reference
fixes by its ops, this port fixes by construction:

- top-k order on ties: ``jax.lax.top_k`` returns the lower index first;
  ``torch.topk`` promises no order, so the k largest come from a stable
  descending sort;
- capacity: ``int(max(1, round(t * k / e * capacity_factor)))`` with
  Python's ``round``, over every token of the call (pad tokens and idle
  decode slots included; under a data group, of the whole batch), which
  decides the drops;
- dispatch: the reference's stable sort by expert ranks each entry within
  its expert by flat (token, slot) order, and one token routes to an expert
  at most once, so the rank is the token's place among the expert's tokens:
  a cumulative count over tokens, no sort.  Entries of rank >= C are
  dropped, never written;
- combine: the reference scatter-adds each token's k contributions in
  sorted (expert-major) order in ``x.dtype``; here each token's
  contributions are gathered into (t, k, d) in ascending expert order and
  summed in that order in ``x.dtype``, the same additions, and no atomics,
  so the card is deterministic.

MoE has no kernel of its own: the expert products are batched GEMMs
(``torch.bmm``), as the reference's einsums.

Under a data group (``tensor_parallel.DataGroup``: a data-sharded step,
each rank holding a contiguous run of the global flat tokens) the layer is
the reference's over the whole batch, which its jitted step sees: the
capacity counts every shard's tokens; an entry's rank within its expert is
its rank within this shard plus the count of the expert's entries on the
shards before it (an all-gather of the per-expert counts), so a token is
dropped exactly where the whole batch's stable sort drops it; the dropped
count is summed over the shards; and the aux loss takes the whole batch's
``me`` and ``ce`` (``tensor_parallel.data_mean``, whose gradient passes
through unscaled, so that the step's mean of the shards' gradients is the
whole batch's).  The z-loss is a mean of per-token terms: the step's mean
over the shards is already the whole batch's.  Each shard's expert batches
hold min(C, t) rows per expert (C the global capacity, t this shard's
tokens), the most a shard can keep.

Under a model group (``distributed.tensor_parallel``) the router's kernel
holds this rank's experts' columns: their logits are gathered and softmax,
top-k, capacity, dispatch and the aux and z losses run replicated.  Each
rank runs its own experts (or, when the rules split ``mlp`` instead, every
expert on its ``mlp`` columns), and the combine's partial sums are
reduced.  The token rows and the gates enter the rank's experts through
``tensor_parallel.enter``, so the router gets every expert's part of its
gradient.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import softmax as sm
from repro_torch.device import scalar
from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.models import layers
from repro_torch.models.params import ArraySpec


def moe_spec(cfg: ModelConfig, dtype=torch.float32):
    d = cfg.d_model
    e = cfg.moe.n_experts
    ff = cfg.moe.d_expert
    spec = {
        "router": layers.dense_spec(d, e, axes=("embed", "experts"), dtype=dtype),
        "w_up": ArraySpec((e, d, ff), dtype, ("experts", "embed", "mlp"), "fan_in"),
        "w_down": ArraySpec((e, ff, d), dtype, ("experts", "mlp", "embed"), "fan_in"),
    }
    if cfg.gated_mlp:
        spec["w_gate"] = ArraySpec((e, d, ff), dtype, ("experts", "embed", "mlp"), "fan_in")
    return spec


def capacity(cfg: ModelConfig, t: int) -> int:
    """Per-expert capacity for a call over ``t`` tokens (the reference's
    expression, Python ``round`` included)."""
    m = cfg.moe
    return int(max(1, round(t * m.top_k / m.n_experts * m.capacity_factor)))


def route(params, cfg: ModelConfig, flat: torch.Tensor, group=None):
    """Routing of ``flat`` (t, d): (router logits (t, e) float32, probs
    (t, e), expert ids (t, k) int64 and normalised gates (t, k) float32, both
    in descending probability order, the lower expert first on a tie).
    With ``group`` whose layout splits the router's expert columns, the
    local logits are gathered over the group."""
    k = cfg.moe.top_k
    # float32 throughout, whatever the weights' type (jnp promotes the
    # reference's float32 activations against a bf16 kernel the same way)
    router = {name: w.float() for name, w in params["router"].items()}
    tp = tp_lib.active(group)
    if tp is not None and tp.layout.router:
        logits = tp_lib.gather(layers.dense(router, tp_lib.enter(flat, tp).float(), None), tp,
                               dim=-1)
    else:
        logits = layers.dense(router, flat.float(), None)
    probs = sm.softmax_paper_exact(logits, dim=-1)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = gate_vals[:, :k], expert_ids[:, :k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    return logits, probs, expert_ids, gate_vals


def expert_rows(cap: int, t: int, data=None) -> int:
    """Rows per expert batch: ``cap``, or under a data group min(cap, t),
    the most a shard of t tokens can keep of the global capacity."""
    return cap if data is None else min(cap, t)


def dispatch(cfg: ModelConfig, expert_ids: torch.Tensor, cap: int, data=None):
    """Each routed entry's place in the expert batches of ``expert_rows``
    rows: (slot (t, k) int64, ``expert * rows + rank`` for kept entries and
    ``e * rows`` for dropped ones; keep (t, k) bool).  The rank of an entry
    is the number of earlier tokens routed to the same expert, as the
    reference's stable sort gives; it is kept where that rank plus the
    expert's entries on the earlier data shards (``data``, module
    docstring; none without it) is under ``cap``."""
    t, k = expert_ids.shape
    e = cfg.moe.n_experts
    rows = expert_rows(cap, t, data)
    # expert-major (e, t), so the count runs along the inner axis (a scan
    # along the outer axis of a (t, e) tensor is a slow kernel on the card)
    routed = torch.zeros(e, t, dtype=torch.int32, device=expert_ids.device)
    routed.scatter_(0, expert_ids.t(), 1)
    before = torch.cumsum(routed, dim=1, dtype=torch.int32) - routed  # earlier tokens
    rank = torch.gather(before, 0, expert_ids.t()).t().long()
    earlier = torch.zeros(e, dtype=torch.int64, device=expert_ids.device)
    if data is not None:
        counts = tp_lib.data_gather(routed.sum(dim=1)[None], data, 0)  # (shards, e)
        earlier = counts[: data.rank].sum(dim=0).long()
    keep = rank + earlier[expert_ids] < cap
    slot = torch.where(keep, expert_ids * rows + rank, e * rows)
    return slot, keep


def experts(params, cfg: ModelConfig, expert_in: torch.Tensor) -> torch.Tensor:
    """The expert FFNs on their batches (e, cap, d) -> (e, cap, d): batched
    GEMMs, as the reference's einsums."""
    up = torch.bmm(expert_in, params["w_up"])
    if cfg.gated_mlp:
        h = layers.activation(torch.bmm(expert_in, params["w_gate"]), cfg.act) * up
    else:
        h = layers.activation(up, cfg.act)
    return torch.bmm(h, params["w_down"])


def moe_apply(params, cfg: ModelConfig, x: torch.Tensor,
              group=None, data=None) -> tuple[torch.Tensor, dict]:
    """Returns (output (b, s, d) in x's dtype, aux): the router's
    load-balance and z losses and the share of dropped entries.  With
    ``data`` (a ``tensor_parallel.DataGroup``) ``x`` is this rank's shard
    of the batch and the layer is the whole batch's (module docstring).
    With ``group`` whose layout splits the expert leaves, the rank runs its
    shard of them and the output is reduced."""
    mcfg = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = mcfg.n_experts, mcfg.top_k
    n = 1 if data is None else data.size
    flat = x.reshape(t, d)
    tp = tp_lib.active(group)
    if tp is not None and tp.layout.experts is None:
        tp = None  # neither experts nor their columns split: the layer repeats
    by_expert = tp is not None and tp.layout.experts == "experts"
    e_local = e // tp.size if by_expert else e

    logits, probs, expert_ids, gate_vals = route(params, cfg, flat, group=group)
    # aux losses (Switch-style load balance + router z-loss)
    me = probs.mean(dim=0)
    ce = torch.zeros(t, e, dtype=torch.float32, device=x.device).scatter_(
        1, expert_ids, 1.0).mean(dim=0)
    if data is not None:  # the whole batch's means
        me, ce = tp_lib.data_mean(me, data), tp_lib.data_mean(ce, data)
    aux_loss = e * torch.sum(me * ce) * mcfg.router_aux_weight
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * mcfg.router_z_weight

    cap = capacity(cfg, t * n)
    rows = expert_rows(cap, t, data)
    slot, keep = dispatch(cfg, expert_ids, cap, data)
    dropped = (t * k - keep.sum()).float()
    if data is not None:
        dropped = tp_lib.data_sum(dropped, data)

    # expert batches (e, rows, d): each slot's source token, or a zero row for
    # an empty slot; dropped entries write the bin past the last slot
    src = torch.full((e * rows + 1,), t, dtype=torch.int64, device=x.device)
    tokens = torch.arange(t, device=x.device)[:, None].expand(t, k)
    src[slot.reshape(-1)] = tokens.reshape(-1)
    order = torch.argsort(expert_ids, dim=-1)
    slot = torch.gather(slot, 1, order)
    gates = torch.gather(gate_vals, 1, order).to(x.dtype)
    if tp is not None:  # this rank's experts [lo, lo + e_local), its slots renumbered
        lo = tp.rank * e_local if by_expert else 0
        src = src[lo * rows:]
        slot = slot - lo * rows
        slot = torch.where((slot >= 0) & (slot < e_local * rows), slot, e_local * rows)
        flat, gates = tp_lib.enter(flat, tp), tp_lib.enter(gates, tp)
    tokens_in = torch.cat([flat, flat.new_zeros(1, d)])
    expert_out = experts(params, cfg, tokens_in[src[: e_local * rows]].reshape(e_local, rows, d))

    # combine: each token's k contributions in ascending expert order, a
    # dropped entry (or, split, another rank's expert) a zero row, summed
    # one after another in x's dtype
    vals = torch.cat([expert_out.reshape(e_local * rows, d), expert_out.new_zeros(1, d)])
    vals = vals[slot.reshape(-1)].reshape(t, k, d) * gates[..., None]
    out = vals[:, 0]
    for j in range(1, k):
        out = out + vals[:, j]
    if tp is not None:
        out = tp_lib.reduce(out, tp)

    aux = {
        "moe_aux_loss": aux_loss,
        "moe_z_loss": z_loss,
        "moe_dropped_frac": dropped / scalar(float(t * k * n), torch.float32, str(x.device)),
    }
    return out.reshape(b, s, d), aux
