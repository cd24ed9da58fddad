"""Plain PyTorch reference of a dense GQA decoder (granite-8b's Llama
layout), in float32 with TF32 off, over one sequence at a time, computed
layer by layer.

Token embedding, pre-norm blocks (RMSNorm; q/k/v projections with RoPE on
the two halves of each head, theta from the configuration; causal attention
with the key/value heads shared by groups of query heads; the output
projection; RMSNorm; a SwiGLU MLP, silu(x W_gate) * (x W_up) W_down), a
final RMSNorm and the tied unembedding.

What a serving precision plan does to that, as the engine serves it:

- ``int8_serve``: every weight matrix (the embedding table too) quantized
  to int8 with one scale per output channel over the matrix; every key and
  value vector quantized to int8 with one scale per (token, head); the
  prompt's positions (the prefill) attend through the paper's LUT softmax
  (exp table with no max subtraction, 1/x table of the sum), the decoded
  positions through an exact softmax, as the engine's decode step does.
- ``float``: the served weights as they are, float keys and values, an
  exact softmax everywhere.

The reference module's interface (``bench/references/physics_encoder.py``
gives it in full): ``build`` returns the ``Decoder`` whose
``logits(tokens, prompt_len)`` ``bench/drivers/closed_loop.py`` compares;
``CONTROLS`` replace the weights' format (``weights``: "int8", "int4",
"fp8" or None for the plan's own) and the keys' and values' bits
(``kv_bits``): int4 below an int8 plan, int8 or fp8 (e4m3) below bf16;
``window_flops`` is the family's model FLOPs, which ``mfu.serve`` reads.
"""

from __future__ import annotations

import torch

from bench.references import numerics

CONTROLS = {"int4": {"weights": "int4", "kv_bits": 4}, "int8": {"weights": "int8"},
            "fp8": {"weights": "fp8"}}


def build(params: dict, model: dict, policy: str, **control) -> "Decoder":
    return Decoder(params, model, policy, **control)


class Decoder:
    def __init__(self, params: dict, model: dict, policy: str, *, weights: str | None = None,
                 kv_bits: int | None = None):
        if policy not in ("float", "int8_serve"):
            raise ValueError(f"the decoder reference knows float and int8_serve, not {policy!r}")
        self.m = model
        self.lut_prefill = policy == "int8_serve"
        weights = weights or ("int8" if policy == "int8_serve" else None)
        self.kv_bits = kv_bits if kv_bits is not None else (8 if policy == "int8_serve" else None)
        quant = {None: lambda t: t.float(),
                 "int8": lambda t: numerics.int_per_channel(t, 8),
                 "int4": lambda t: numerics.int_per_channel(t, 4),
                 "fp8": numerics.fp8_per_channel}[weights]
        self.table = quant(params["embed"]["table"])
        self.blocks = []
        for i in range(model["n_layers"]):
            blk = params["blocks"]
            self.blocks.append({
                "ln1": blk["ln1"]["scale"][i].float(), "ln2": blk["ln2"]["scale"][i].float(),
                **{n: quant(blk["attn"][n]["kernel"][i]) for n in ("wq", "wk", "wv", "wo")},
                **{n: quant(blk["ffn"][n]["kernel"][i]) for n in ("w_up", "w_gate", "w_down")},
            })
        self.final_norm = params["final_norm"]["scale"].float()
        hd = model["head_dim"]
        self.freqs = 1.0 / (model["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=self.table.device) / hd))

    def _rms(self, x, scale):
        ms = torch.sum(x * x, dim=-1, keepdim=True) / x.shape[-1]
        return x * torch.rsqrt(ms + self.m["norm_eps"]) * scale

    def _rope(self, x, cos, sin):
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, b, x, cos, sin, prompt_len: int, head_block: int):
        s = x.shape[0]
        h, hkv, hd = self.m["n_heads"], self.m["n_kv_heads"], self.m["head_dim"]
        q = self._rope((x @ b["wq"]).reshape(s, h, hd).transpose(0, 1), cos, sin)
        k = self._rope((x @ b["wk"]).reshape(s, hkv, hd).transpose(0, 1), cos, sin)
        v = (x @ b["wv"]).reshape(s, hkv, hd).transpose(0, 1)
        if self.kv_bits is not None:
            k, v = numerics.int_per_vector(k, self.kv_bits), numerics.int_per_vector(v, self.kv_bits)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        lut_rows = (torch.arange(s, device=x.device) < prompt_len)[:, None]
        out = torch.empty(h, s, hd, device=x.device)
        for lo in range(0, h, head_block):
            hs = slice(lo, min(h, lo + head_block))
            kv = torch.arange(hs.start, hs.stop, device=x.device) // (h // hkv)
            scores = torch.matmul(q[hs], k[kv].transpose(-1, -2)) / hd ** 0.5
            exact = torch.softmax(torch.where(causal, scores, -1e30), dim=-1)
            if self.lut_prefill:
                e = torch.where(causal, numerics.lookup(scores, numerics.EXP), 0.0)
                lut = e * numerics.lookup(torch.sum(e, dim=-1, keepdim=True), numerics.INV)
                exact = torch.where(lut_rows, lut, exact)
            out[hs] = torch.matmul(exact, v[kv])
        return out.transpose(0, 1).reshape(s, h * hd) @ b["wo"]

    def logits(self, tokens: torch.Tensor, prompt_len: int, head_block: int = 8) -> torch.Tensor:
        """(L,) token ids -> (L, vocab) float32 logits, position j predicting
        token j + 1; positions below ``prompt_len`` are the prompt."""
        with torch.no_grad(), numerics.matmul_precision(False):
            return self._logits(tokens, prompt_len, head_block)

    def _logits(self, tokens: torch.Tensor, prompt_len: int, head_block: int) -> torch.Tensor:
        pos = torch.arange(tokens.shape[0], dtype=torch.float32, device=tokens.device)
        ang = pos[:, None] * self.freqs
        cos, sin = torch.cos(ang), torch.sin(ang)
        x = self.table[tokens]
        for b in self.blocks:
            x = x + self._attention(b, self._rms(x, b["ln1"]), cos, sin, prompt_len, head_block)
            hmid = self._rms(x, b["ln2"])
            x = x + (torch.nn.functional.silu(hmid @ b["w_gate"]) * (hmid @ b["w_up"])) @ b["w_down"]
        return self._rms(x, self.final_norm) @ self.table.t()


def params_per_token(m: dict) -> float:
    """Weights one token multiplies through: GQA attention, a gated MLP and
    the (tied) unembedding."""
    d, hd = m["d_model"], m["head_dim"]
    attn = d * hd * (m["n_heads"] + 2 * m["n_kv_heads"]) + m["n_heads"] * hd * d
    mlp = 3 * d * m["d_ff"]
    return float(m["n_layers"] * (attn + mlp) + d * m["vocab_size"])


def window_flops(m: dict, tokens: float, prompt_sq_half: float, decode_context: float) -> float:
    """Model FLOPs of ``tokens`` processed (prompt and decoded): 2 x the
    weights per token each, plus QKᵀ and P·V, where a prompt of L tokens
    attends L²/2 pairs and a decoded token its whole context
    (``prompt_sq_half``: Σ L²/2 over prompts, ``decode_context``: Σ context
    over decoded tokens)."""
    per_pair = 2 * 2 * m["n_heads"] * m["head_dim"]
    return float(2 * params_per_token(m) * tokens
                 + m["n_layers"] * per_pair * (prompt_sq_half + decode_context))
