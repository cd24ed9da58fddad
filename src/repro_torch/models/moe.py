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
  decode slots included), which decides the drops;
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
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import softmax as sm
from repro_torch.device import scalar
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


def route(params, cfg: ModelConfig, flat: torch.Tensor):
    """Routing of ``flat`` (t, d): (router logits (t, e) float32, probs
    (t, e), expert ids (t, k) int64 and normalised gates (t, k) float32, both
    in descending probability order, the lower expert first on a tie)."""
    k = cfg.moe.top_k
    # float32 throughout, whatever the weights' type (jnp promotes the
    # reference's float32 activations against a bf16 kernel the same way)
    router = {name: w.float() for name, w in params["router"].items()}
    logits = layers.dense(router, flat.float(), None)
    probs = sm.softmax_paper_exact(logits, dim=-1)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = gate_vals[:, :k], expert_ids[:, :k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    return logits, probs, expert_ids, gate_vals


def dispatch(cfg: ModelConfig, expert_ids: torch.Tensor, cap: int):
    """Each routed entry's place in the expert batches: (slot (t, k) int64,
    ``expert * cap + rank`` for kept entries and ``e * cap`` for dropped
    ones; keep (t, k) bool).  The rank of an entry is the number of earlier
    tokens routed to the same expert, as the reference's stable sort gives."""
    t, k = expert_ids.shape
    e = cfg.moe.n_experts
    # expert-major (e, t), so the count runs along the inner axis (a scan
    # along the outer axis of a (t, e) tensor is a slow kernel on the card)
    routed = torch.zeros(e, t, dtype=torch.int32, device=expert_ids.device)
    routed.scatter_(0, expert_ids.t(), 1)
    before = torch.cumsum(routed, dim=1, dtype=torch.int32) - routed  # earlier tokens
    rank = torch.gather(before, 0, expert_ids.t()).t().long()
    keep = rank < cap
    slot = torch.where(keep, expert_ids * cap + rank, e * cap)
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


def moe_apply(params, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Returns (output (b, s, d) in x's dtype, aux): the router's
    load-balance and z losses and the share of dropped entries."""
    mcfg = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = mcfg.n_experts, mcfg.top_k
    flat = x.reshape(t, d)

    logits, probs, expert_ids, gate_vals = route(params, cfg, flat)
    # aux losses (Switch-style load balance + router z-loss)
    me = probs.mean(dim=0)
    ce = torch.zeros(t, e, dtype=torch.float32, device=x.device).scatter_(
        1, expert_ids, 1.0).mean(dim=0)
    aux_loss = e * torch.sum(me * ce) * mcfg.router_aux_weight
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * mcfg.router_z_weight

    cap = capacity(cfg, t)
    slot, keep = dispatch(cfg, expert_ids, cap)
    dropped = (t * k - keep.sum()).float()

    # expert batches (e, cap, d): each slot's source token, or a zero row for
    # an empty slot; dropped entries write the bin past the last slot
    src = torch.full((e * cap + 1,), t, dtype=torch.int64, device=x.device)
    tokens = torch.arange(t, device=x.device)[:, None].expand(t, k)
    src[slot.reshape(-1)] = tokens.reshape(-1)
    rows = torch.cat([flat, flat.new_zeros(1, d)])
    expert_out = experts(params, cfg, rows[src[: e * cap]].reshape(e, cap, d))

    # combine: each token's k contributions in ascending expert order, a
    # dropped entry a zero row, summed one after another in x's dtype
    order = torch.argsort(expert_ids, dim=-1)
    slot = torch.gather(slot, 1, order)
    gates = torch.gather(gate_vals, 1, order).to(x.dtype)
    vals = torch.cat([expert_out.reshape(e * cap, d), expert_out.new_zeros(1, d)])
    vals = vals[slot.reshape(-1)].reshape(t, k, d) * gates[..., None]
    out = vals[:, 0]
    for j in range(1, k):
        out = out + vals[:, j]

    aux = {
        "moe_aux_loss": aux_loss,
        "moe_z_loss": z_loss,
        "moe_dropped_frac": dropped / scalar(float(t * k), torch.float32, str(x.device)),
    }
    return out.reshape(b, s, d), aux
