"""Plain PyTorch reference of the paper's physics encoder (Table I; the GW
model), in float32 with TF32 off, under its configuration's precision.

Input projection and learned positions, pre-norm blocks (LayerNorm,
multi-head attention over every position, LayerNorm, ReLU MLP), a final
LayerNorm, mean pooling over time and two dense head layers (ReLU between).

``paper_vu13p`` (the paper's VU13P build, Sec. VI-A): every parameter
snapped to ap_fixed<12,6>; the input of every dense layer fake-quantized to
ap_fixed<12,6>; the attention's softmax as the paper's three-stage LUT form
(exp table, no max subtraction, 1/x table of the row sum); every LayerNorm's
1/sqrt(var) from the 1/sqrt table (no epsilon).  ``float``: none of that,
an exact softmax and 1/sqrt(var + eps).

The interface every reference module of ``bench/references`` gives, found
by the configuration file's ``reference``:

- ``build(params, model, policy, **control)``: the reference model of the
  weights the run drew, whose ``logits`` the driver of the cell's traffic
  compares (here ``logits(events)``, as ``bench/drivers/batch_stream.py``
  reads it);
- ``CONTROLS``: each control by name, as the keyword arguments of
  ``build``; here ``tf32`` lets every matrix product round its operands to
  TF32, the nearest precision below the configuration's float32 with TF32
  off;
- the family's model FLOPs (here ``flops_per_event``), which its ``mfu``
  reader takes.
"""

from __future__ import annotations

import torch

from bench.references import numerics

CONTROLS = {"tf32": {"matmul_tf32": True}}


def build(params: dict, model: dict, policy: str, *, matmul_tf32: bool = False) -> "Encoder":
    return Encoder(params, model, policy, matmul_tf32=matmul_tf32)


class Encoder:
    def __init__(self, params: dict, model: dict, policy: str, *, matmul_tf32: bool = False):
        if policy not in ("float", "paper_vu13p"):
            raise ValueError(f"the physics reference knows float and paper_vu13p, not {policy!r}")
        self.m, self.fixed, self.tf32 = model, policy == "paper_vu13p", matmul_tf32
        snap = (lambda t: numerics.ap_fixed(t.float(), 12, 6)) if self.fixed else (
            lambda t: t.float())
        self.p = _map(snap, params)

    def _act(self, x):
        return numerics.ap_fixed_ste_value(x, 12, 6) if self.fixed else x

    def _dense(self, p, x):
        y = torch.matmul(self._act(x), p["kernel"])
        return y + p["bias"] if "bias" in p else y

    def _norm(self, p, x):
        k = x.shape[-1]
        mean = torch.sum(x, dim=-1, keepdim=True) / k
        dm = x - mean
        var = torch.sum(dm * dm, dim=-1, keepdim=True) / k
        inv = (numerics.lookup(var, numerics.RSQRT) if self.fixed
               else torch.rsqrt(var + self.m["norm_eps"]))
        return dm * inv * p["scale"] + p["bias"]

    def _attention(self, p, x):
        b, s, _ = x.shape
        h, hd = self.m["n_heads"], self.m["head_dim"]

        def heads(t):
            return t.reshape(b, s, h, hd).transpose(1, 2)

        q, k, v = (heads(self._dense(p[n], x)) for n in ("wq", "wk", "wv"))
        scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / hd ** 0.5)
        if self.fixed:
            e = numerics.lookup(scores, numerics.EXP)
            probs = e * numerics.lookup(torch.sum(e, dim=-1, keepdim=True), numerics.INV)
        else:
            probs = torch.softmax(scores, dim=-1)
        o = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, h * hd)
        return self._dense(p["wo"], o)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(batch, seq, channels) float32 events -> (batch, n_classes) logits."""
        p = self.p
        h = self._dense(p["input_proj"], x.float()) + p["pos_embed"]
        for i in range(self.m["n_layers"]):
            blk = _map(lambda t, i=i: t[i], p["blocks"])
            h = h + self._attention(blk["attn"], self._norm(blk["ln1"], h))
            up = torch.relu(self._dense(blk["ffn"]["w_up"], self._norm(blk["ln2"], h)))
            h = h + self._dense(blk["ffn"]["w_down"], up)
        pooled = torch.mean(self._norm(p["final_norm"], h), dim=1)
        return self._dense(p["head2"], torch.relu(self._dense(p["head1"], pooled)))

    def logits(self, events: torch.Tensor, rows: int = 8192) -> torch.Tensor:
        """Logits of ``events`` on their device, in blocks of ``rows``."""
        with torch.no_grad(), numerics.matmul_precision(self.tf32):
            return torch.cat([self.forward(events[i:i + rows])
                              for i in range(0, len(events), rows)])


def flops_per_event(m: dict) -> float:
    """Model FLOPs of one forward (``m``: the configuration's
    ``model_config``): the input projection, per block the q/k/v/o
    projections, the attention's QKᵀ and P·V over every pair and the MLP,
    then the two head layers (2 FLOPs per multiply-add)."""
    seq, d, ff = m["seq_len"], m["d_model"], m["d_ff"]
    per_block = 2 * seq * d * d * 4 + 2 * 2 * seq * seq * d + 2 * 2 * seq * d * ff
    return float(2 * seq * m["input_vec_size"] * d + m["n_layers"] * per_block
                 + 2 * d * d + 2 * d * m["n_classes"])


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)
