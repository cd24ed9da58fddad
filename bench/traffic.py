"""The benchmark's input generators, read by every traffic mix's parameters.

``gw_events`` is a frozen copy of ``repro_torch.data.physics.gw_data`` (the
LIGO-like strain of the paper's GW benchmark: sine-Gaussian chirps on
coloured noise) with the per-row convolution written as a sum of shifted
slices, so a pool of 131,072 events is made in about a second.  It draws
the same quantities in the same order as the original, from a stream keyed
by the run's seed.

``RequestStream`` makes a closed-loop serving mix: the k-th request of the
run is fixed by the seed and k alone.  Prompt and output lengths come from
even grids of ``CYCLE`` values each over the mix's ranges, paired and
ordered once by a fixed permutation (``ORDER_SEED``); request k takes pair
k mod ``CYCLE``, so any ``CYCLE`` consecutive requests hold every pair
once, and every seed sends the same sizes in the same order.  The seed
draws the token ids.  (The order of the
sizes changes the work: the engine prefills the requests of one bucket
admitted in one step together, at a fixed row count, so orders drawn from
the seed moved tokens/s by up to 8 % between seeds, and rotations of one
cycle by up to 6 %, while a seed repeated its own reading.)
"""

from __future__ import annotations

import numpy as np

#: pairs of (prompt, output) lengths in one cycle of a serving mix, and the
#: seed of the one order in which every run sends them
CYCLE = 32
ORDER_SEED = 0


def seed_sequence(seed: int, *words: int) -> np.random.SeedSequence:
    if seed < 0:
        raise ValueError(f"seeds are whole numbers >= 0, got {seed}")
    return np.random.SeedSequence([seed, *words])


def gw_events(n: int, seed: int, seq_len: int = 100, n_ch: int = 2) -> np.ndarray:
    """(n, seq_len, n_ch) float32 events; half carry an injected signal."""
    rng = np.random.default_rng(seed_sequence(seed, 0))
    y = rng.integers(0, 2, n)
    t = np.linspace(-1, 1, seq_len)
    white = rng.standard_normal((n, n_ch, seq_len))
    kernel = np.exp(-0.5 * (np.arange(-4, 5) / 1.8) ** 2)
    kernel /= kernel.sum()
    # np.convolve(row, kernel, "same") for every row at once (kernel symmetric)
    half = len(kernel) // 2
    padded = np.pad(white, ((0, 0), (0, 0), (half, half)))
    noise = np.zeros_like(white)
    for j, w in enumerate(kernel):
        noise += w * padded[..., j:j + seq_len]
    f0 = rng.uniform(4, 12, (n, 1, 1))
    q = rng.uniform(3, 9, (n, 1, 1))
    t0 = rng.uniform(-0.4, 0.4, (n, 1, 1))
    amp = rng.uniform(0.6, 1.4, (n, 1, 1))
    sg = amp * np.exp(-((t - t0) ** 2) * q) * np.sin(2 * np.pi * f0 * (t - t0))
    x = (noise + y[:, None, None] * sg).transpose(0, 2, 1)
    x = (x - x.mean(axis=1, keepdims=True)) / (x.std(axis=1, keepdims=True) + 1e-6)
    return np.ascontiguousarray(x, dtype=np.float32)


def length_grid(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` whole lengths spread evenly over [lo, hi]."""
    return np.rint(np.linspace(lo, hi, n)).astype(np.int64)


class RequestStream:
    """The requests of one closed-loop run: ``prompt(k)`` and ``max_new(k)``
    of the k-th request sent, token ids uniform over [0, vocab)."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        if seed < 0:
            raise ValueError(f"seeds are whole numbers >= 0, got {seed}")
        self.seed, self.vocab = seed, vocab
        order = np.random.default_rng(seed_sequence(ORDER_SEED, 1))
        self.prompts = order.permutation(length_grid(*mix["prompt_tokens"], CYCLE))
        self.outputs = order.permutation(length_grid(*mix["output_tokens"], CYCLE))

    def prompt_len(self, k: int) -> int:
        return int(self.prompts[k % CYCLE])

    def max_new(self, k: int) -> int:
        return int(self.outputs[k % CYCLE])

    def prompt(self, k: int) -> list[int]:
        rng = np.random.default_rng(seed_sequence(self.seed, 2, k))
        return rng.integers(0, self.vocab, self.prompt_len(k)).tolist()
