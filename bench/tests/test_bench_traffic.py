"""The traffic generators are fixed by the seed, and every seed gets the
same sizes."""

import numpy as np

from bench import traffic

MIX = {"prompt_tokens": [1536, 3584], "output_tokens": [8, 32]}
N = traffic.CYCLE


def test_gw_events_are_deterministic_in_the_seed():
    a, b = traffic.gw_events(64, 2**31 + 11), traffic.gw_events(64, 2**31 + 11)
    assert a.dtype == np.float32 and a.shape == (64, 100, 2)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, traffic.gw_events(64, 2**31 + 12))


def test_gw_events_are_normalised_per_channel():
    x = traffic.gw_events(32, 5)
    assert np.allclose(x.mean(axis=1), 0, atol=1e-5)
    assert np.allclose(x.std(axis=1), 1, atol=1e-3)


def test_gw_events_convolve_as_numpy_does():
    # the noise of the original generator, one row at a time
    rng = np.random.default_rng(0)
    white = rng.standard_normal(100)
    kernel = np.exp(-0.5 * (np.arange(-4, 5) / 1.8) ** 2)
    kernel /= kernel.sum()
    padded = np.pad(white, (4, 4))
    ours = sum(w * padded[j:j + 100] for j, w in enumerate(kernel))
    assert np.allclose(ours, np.convolve(white, kernel, mode="same"), atol=1e-12)


def test_request_stream_is_deterministic_in_the_seed():
    a, b = traffic.RequestStream(MIX, 2**31 + 3, 49152), traffic.RequestStream(MIX, 2**31 + 3, 49152)
    for k in (0, 5, 31, 32, 100):
        assert a.prompt(k) == b.prompt(k)
        assert a.max_new(k) == b.max_new(k)
    c = traffic.RequestStream(MIX, 2**31 + 4, 49152)
    assert any(a.prompt(k) != c.prompt(k) for k in range(4))


def test_every_seed_sends_the_same_sizes_in_the_same_order():
    streams = [traffic.RequestStream(MIX, seed, 49152) for seed in (1, 2, 2**31 + 99)]
    sent = [[(s.prompt_len(k), s.max_new(k)) for k in range(100)] for s in streams]
    assert sent[0] == sent[1] == sent[2]
    assert N == 32 and sent[0][:N] == sent[0][N:2 * N]  # one cycle of every pair
    for start in (0, 5, 40):
        sizes = []
        for s in streams:
            ks = range(start, start + N)
            sizes.append((sorted(s.prompt_len(k) for k in ks), sorted(s.max_new(k) for k in ks)))
        assert sizes[0] == sizes[1] == sizes[2]
        assert sizes[0][0][0] == 1536 and sizes[0][0][-1] == 3584
        assert sizes[0][1][0] == 8 and sizes[0][1][-1] == 32


def test_prompt_tokens_lie_in_the_vocabulary():
    s = traffic.RequestStream(MIX, 7, 1000)
    p = s.prompt(3)
    assert len(p) == s.prompt_len(3) and min(p) >= 0 and max(p) < 1000
