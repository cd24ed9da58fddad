"""Deterministic synthetic LM token stream, shard-aware and restart-exact
(port of ``repro.data.synthetic``, numpy only, so the same seed gives the
reference's tokens).

A stationary Markov-ish process with learnable structure: the next token
follows the previous one through a fixed random permutation, or is noise.
Batches are addressed by (step, shard), so any host can regenerate any
shard of any step: the property exact restarts rely on.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLMConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.8  # prob of following the deterministic successor


class SyntheticLM:
    def __init__(self, cfg: SyntheticLMConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.successor = rng.permutation(cfg.vocab_size)

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """Batch shard for (step, shard): a pure function of its arguments."""
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not split into "
                             f"{n_shards} shards")
        local = cfg.global_batch // n_shards
        rng = np.random.default_rng((cfg.seed * 1_000_003 + step) * 65_537 + shard)
        toks = np.empty((local, cfg.seq_len), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, local)
        follow = rng.random((local, cfg.seq_len)) < cfg.structure
        noise = rng.integers(0, cfg.vocab_size, (local, cfg.seq_len))
        for t in range(1, cfg.seq_len):
            succ = self.successor[toks[:, t - 1]]
            toks[:, t] = np.where(follow[:, t], succ, noise[:, t])
        return {"tokens": toks}


def make_batch_fn(vocab_size, seq_len, global_batch, seed=0):
    ds = SyntheticLM(SyntheticLMConfig(vocab_size, seq_len, global_batch, seed))
    return ds.batch
