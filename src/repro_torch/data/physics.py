"""Synthetic physics datasets mirroring the paper's three benchmarks
(a numpy copy of the JAX package's ``data/physics.py`` generators, so the
port feeds the same seeded events without importing that package).

The real datasets (FordA/UCR, CMS open data, LIGO O3a) are not available
offline; these generators produce statistically similar, *learnable*
classification problems with the exact input shapes of paper Table I, so
the QAT/PTQ fidelity pipeline (AUC-ratio-vs-bits, Figs. 9-11) runs
end-to-end.  All generators are seeded and deterministic.

  engine  : 1-ch time series (seq 50); anomalies inject harmonic distortion
            + noise bursts into an engine-like periodic signal.
  btagging: 15 "tracks" x 6 features; b-jets have displaced-vertex-like
            shifts in impact-parameter features (the paper's Sec. V-B
            physics), light jets are prompt.
  gw      : 2-ch strain (seq 100); signals are sine-Gaussian chirps
            injected on colored noise, as in the paper's O3a setup.
"""

from __future__ import annotations

import numpy as np


def engine_anomaly_data(n: int, seed: int = 0, seq_len: int = 50):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, seq_len)
    y = rng.integers(0, 2, n)
    freq = rng.uniform(0.8, 1.2, (n, 1))
    phase = rng.uniform(0, 2 * np.pi, (n, 1))
    base = np.sin(freq * t[None, :] + phase)
    base += 0.3 * np.sin(3 * freq * t[None, :] + phase)
    noise = 0.25 * rng.standard_normal((n, seq_len))
    # anomaly: 2nd-harmonic distortion + localized burst
    distort = 0.55 * np.sin(2 * freq * t[None, :] + phase * 1.7)
    burst_pos = rng.integers(5, seq_len - 10, n)
    burst = np.zeros((n, seq_len))
    for i in range(n):
        if y[i]:
            burst[i, burst_pos[i] : burst_pos[i] + 6] += rng.normal(
                0, 0.8, 6
            )
    x = base + noise + y[:, None] * distort + burst
    x = (x - x.mean(axis=1, keepdims=True)) / (x.std(axis=1, keepdims=True) + 1e-6)
    return x[..., None].astype(np.float32), y.astype(np.int32)


def btagging_data(n: int, seed: int = 0, seq_len: int = 15, n_feat: int = 6):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)  # 0 light, 1 c, 2 b
    # per-track features ~ (pt, eta, phi, d0, z0, quality)
    x = rng.standard_normal((n, seq_len, n_feat)).astype(np.float32)
    x[..., 0] = np.abs(rng.standard_normal((n, seq_len))) * 2 + 0.5  # pt
    # displaced-vertex signature: heavy flavours shift impact parameters of
    # their leading tracks, with b > c (longer lifetime)
    lifetime = np.where(y == 2, 1.0, np.where(y == 1, 0.45, 0.0))
    n_displ = rng.integers(2, 6, n)
    for i in range(n):
        k = n_displ[i]
        x[i, :k, 3] += lifetime[i] * np.abs(rng.standard_normal(k)) * 2.2
        x[i, :k, 4] += lifetime[i] * np.abs(rng.standard_normal(k)) * 1.4
    return x, y.astype(np.int32)


def gw_data(n: int, seed: int = 0, seq_len: int = 100, n_ch: int = 2):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    t = np.linspace(-1, 1, seq_len)
    # colored background noise (smoothed white noise + lines)
    white = rng.standard_normal((n, n_ch, seq_len))
    kernel = np.exp(-0.5 * (np.arange(-4, 5) / 1.8) ** 2)
    kernel /= kernel.sum()
    noise = np.apply_along_axis(
        lambda m: np.convolve(m, kernel, mode="same"), -1, white
    )
    # sine-Gaussian injections (paper Sec. V-C) with random Q/f0/t0
    f0 = rng.uniform(4, 12, (n, 1, 1))
    q = rng.uniform(3, 9, (n, 1, 1))
    t0 = rng.uniform(-0.4, 0.4, (n, 1, 1))
    amp = rng.uniform(0.6, 1.4, (n, 1, 1))
    sg = amp * np.exp(-((t - t0) ** 2) * q) * np.sin(
        2 * np.pi * f0 * (t - t0)
    )
    x = noise + y[:, None, None] * sg
    x = x.transpose(0, 2, 1)  # (n, seq, ch)
    x = (x - x.mean(axis=1, keepdims=True)) / (x.std(axis=1, keepdims=True) + 1e-6)
    return x.astype(np.float32), y.astype(np.int32)


GENERATORS = {
    "engine_anomaly": engine_anomaly_data,
    "btagging": btagging_data,
    "gw": gw_data,
}


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks with ties averaged (Mann-Whitney midranks)."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), np.float64)
    i = 0
    xs = x[order]
    while i < len(x):
        j = i
        while j + 1 < len(x) and xs[j + 1] == xs[i]:
            j += 1
        ranks[order[i : j + 1]] = (i + j) / 2 + 1
        i = j + 1
    return ranks


def auc_score(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Binary ROC AUC via the Mann-Whitney rank statistic (midranks for
    ties)."""
    y_true = np.asarray(y_true)
    scores = np.asarray(scores, np.float64)
    pos_mask = y_true == 1
    n_pos = int(pos_mask.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = _average_ranks(scores)
    r_pos = ranks[pos_mask].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def multiclass_auc(y_true: np.ndarray, probs: np.ndarray) -> float:
    """Macro one-vs-rest AUC (b-tagging has 3 classes)."""
    aucs = [auc_score((y_true == c).astype(int), probs[:, c]) for c in range(probs.shape[-1])]
    return float(np.nanmean(aucs))
