"""Token sampling for the serving engine (port of ``repro.serve.sampling``).

The knobs are per-slot ``(B,)`` tensors next to the per-slot ``eos``:
temperature, top-k, top-p and seed.  Greedy is a ``where`` on
``temperature > 0``, never a Python branch, so one batch mixes greedy and
sampled rows.  Encodings (host ``None`` -> sentinel, see
``serve.scheduler.encode_sampling``):

* ``temperature <= 0`` -> greedy (argmax)
* ``top_k <= 0``       -> top-k off
* ``top_p >= 1``       -> top-p off
* ``seed < 0``         -> the engine's own stream

Draws are Gumbel-max: ``argmax(scaled + g)`` with ``g = -log(-log(u))``.
A seeded row takes its uniforms ``u`` from a counter-based integer hash of
(seed, position, vocab index), computed in torch integer ops, so its
stream depends only on (seed, position of the processed token): never on
the batch, the row, the dispatch schedule or the replica, and the CPU and
the card draw the same token up to float ties in ``log``.  An unseeded
row hashes a key drawn from the engine's ``torch.Generator`` (salted by
the replica index) instead of the seed.  The reference keys its rows with
``fold_in(PRNGKey(seed), position)``, which torch cannot reproduce: the
port keeps its invariances, not its tokens.
"""

from __future__ import annotations

import dataclasses

import torch

_M32 = 0xFFFFFFFF
#: domain tags, so a seeded row and an engine-keyed row never share a stream
_SEEDED, _ENGINE = 0x5EED, 0x0E4E


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request generation knobs for ``Engine.submit``.  ``None`` means
    the engine default: ``ServeConfig.temperature`` for temperature, off
    for top-k / top-p, the engine's generator for the seed.
    ``temperature=0.0`` is greedy whatever the other knobs."""

    max_new_tokens: int = 16
    eos_id: int | None = None
    #: softmax temperature; None = ServeConfig.temperature, 0.0 = greedy
    temperature: float | None = None
    #: keep only the k highest logits (tie-inclusive); None/0 = off
    top_k: int | None = None
    #: nucleus sampling mass in (0, 1]; None/1.0 = off
    top_p: float | None = None
    #: pins the sampled stream per (seed, position); None = engine stream
    seed: int | None = None


def _mask_top_k(scaled: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Mask all but each row's ``top_k`` highest logits to the dtype
    minimum.  ``top_k`` is per row; ``<= 0`` disables the mask.
    Tie-inclusive: values equal to the k-th largest all survive."""
    v = scaled.shape[-1]
    k = torch.where(top_k > 0, top_k, v).to(torch.int64)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, -1, (k - 1).clamp(0, v - 1)[:, None])
    return scaled.masked_fill(scaled < kth, torch.finfo(scaled.dtype).min)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis in ``x``'s dtype: exp and quotient
    rounded to it, the sum accumulated in float32 (the reference's
    ``jax.nn.softmax`` on the CPU, bit for bit in bfloat16)."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


_SCAN_BLOCK = 16


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in the reference's order:
    XLA runs ``jnp.cumsum`` as a blocked scan (sequential sums, rounded
    to the dtype at each step, over blocks of 16; the block totals scanned
    the same way, recursively; each block then offset by the sum of the
    blocks before it).  ``torch.cumsum`` rounds once per output, so its
    bfloat16 sums differ, and a top-p cut at a boundary with them."""
    n = x.shape[-1]
    if n > _SCAN_BLOCK:
        nb = -(-n // _SCAN_BLOCK)
        blocks = _cumsum(torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n))
                         .reshape(*x.shape[:-1], nb, _SCAN_BLOCK))
        before = torch.nn.functional.pad(_cumsum(blocks[..., -1])[..., :-1], (1, 0))
        return (blocks + before[..., None]).reshape(*x.shape[:-1], -1)[..., :n]
    acc, out = torch.zeros_like(x[..., 0]), []
    for i in range(n):
        acc = acc + x[..., i]
        out.append(acc)
    return torch.stack(out, -1)


def _mask_top_p(scaled: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus mask: keep each row's smallest set of tokens whose
    probability mass reaches ``top_p`` (the top token always survives).
    ``top_p`` is per row; ``>= 1`` disables the mask."""
    desc = torch.sort(scaled, dim=-1, descending=True).values
    probs = _softmax(desc)
    cum = _cumsum(probs)
    keep = (cum - probs) < top_p[:, None].to(probs.dtype)
    thresh = torch.where(keep, desc, torch.full_like(desc, float("inf"))).amin(-1, keepdim=True)
    masked = scaled.masked_fill(scaled < thresh, torch.finfo(scaled.dtype).min)
    return torch.where(top_p[:, None] >= 1.0, scaled, masked)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser on int64 tensors holding values in
    [0, 2^32): multipliers below 2^31 keep every product under 2^63, so the
    arithmetic is exact (no wrap) on every device."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def _row_keys(seed: torch.Tensor, positions: torch.Tensor, drawn: torch.Tensor) -> torch.Tensor:
    """One 32-bit key per row: (seed, position) for a seeded row
    (``seed >= 0``), (drawn key, position) for the others."""
    seeded = seed >= 0
    base = torch.where(seeded, seed.to(torch.int64), drawn.to(torch.int64)) & _M32
    tag = torch.where(seeded, _SEEDED, _ENGINE)
    k = _mix32(base ^ tag)
    return _mix32(k ^ (positions.to(torch.int64) & _M32))


def _gumbel(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, V) float32 Gumbel noise from the row keys and the vocab index."""
    idx = _mix32(torch.arange(1, vocab + 1, dtype=torch.int64, device=keys.device))
    h = _mix32(keys[:, None] ^ idx[None, :])
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    return -torch.log(-torch.log(u))


def draw_keys(generator: torch.Generator, batch: int, device) -> torch.Tensor:
    """(B,) keys for the unseeded rows of one sampling call, from the
    engine's generator (on the generator's device, no host sync)."""
    return torch.randint(0, 1 << 31, (batch,), generator=generator, device=device,
                         dtype=torch.int64)


def sample_tokens(
    logits: torch.Tensor,  # (B, V)
    drawn: torch.Tensor,   # (B,) int64 engine keys for the unseeded rows
    *,
    temperature: torch.Tensor,  # (B,) float32; <= 0 = greedy
    top_k: torch.Tensor,        # (B,) int32;   <= 0 = off
    top_p: torch.Tensor,        # (B,) float32; >= 1 = off
    seed: torch.Tensor,         # (B,) int32;   <  0 = engine key
    positions: torch.Tensor,    # (B,) int32 position of the processed token
) -> torch.Tensor:
    """Per-slot sampling with knob tensors: greedy and sampled rows share
    one call through a ``where`` on ``temperature > 0``.  Returns (B,)
    int32 tokens on the logits' device; no host synchronisation."""
    greedy = logits.argmax(-1).to(torch.int32)
    temp = temperature.to(device=logits.device, dtype=torch.float32)
    # float32 knobs promote the quotient to float32, as in the reference
    scaled = logits / torch.where(temp > 0, temp, 1.0)[:, None]
    scaled = _mask_top_k(scaled, top_k.to(logits.device))
    scaled = _mask_top_p(scaled, top_p.to(logits.device))
    keys = _row_keys(seed.to(logits.device), positions.to(logits.device), drawn)
    sampled = (scaled.float() + _gumbel(keys, logits.shape[-1])).argmax(-1).to(torch.int32)
    return torch.where(temp > 0, sampled, greedy)


def sample(
    logits: torch.Tensor,  # (B, V)
    generator: torch.Generator,
    *,
    temperature: float = 0.0,
    top_k: int | None = None,
) -> torch.Tensor:
    """Greedy when temperature == 0, else (top-k) temperature sampling: one
    temperature and top-k for the whole batch, draws from ``generator``.
    The serving loop uses :func:`sample_tokens`; this stays for direct
    callers."""
    if temperature == 0.0:
        return logits.argmax(-1).to(torch.int32)
    scaled = logits / temperature
    if top_k is not None:
        cut = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        # a dtype-aware sentinel: -1e30 would overflow under float16 logits
        scaled = scaled.masked_fill(scaled < cut, torch.finfo(scaled.dtype).min)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (scaled.float() - torch.log(-torch.log(u))).argmax(-1).to(torch.int32)
