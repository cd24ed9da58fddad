"""The end-to-end arithmetic counts every request and the whole window."""

import math

import pytest

from bench import stats


def test_percentile_is_nearest_rank():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile(vals, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0


def test_a_missing_request_counts_above_every_answer():
    answered = [0.1] * 95
    assert stats.percentile(answered + [math.inf] * 5, 95) == 0.1
    assert stats.percentile(answered + [math.inf] * 6, 95) == math.inf


def test_rate_is_over_the_whole_window():
    # 1000 events in the first second of a ten-second window
    times = [i / 1000 for i in range(1000)]
    assert stats.rate(stats.in_window(times, 0.0, 10.0), 10.0) == 100.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_a_stall_inside_the_window_moves_the_rate_and_the_tail():
    steady = [i * 0.01 for i in range(1000)]  # 10 s of answers, 100/s
    stalled = [t if t < 5 else t + 2.0 for t in steady]  # 2 s stall in the middle
    assert stats.in_window(stalled, 0, 10) < stats.in_window(steady, 0, 10)
    waits = [0.05] * 100
    stalled_waits = waits[:90] + [2.05] * 10  # the requests the stall held
    assert stats.percentile(stalled_waits, 95) > stats.percentile(waits, 95)
