"""The metric arithmetic: rate over the window, percentiles over all
requests, idle share over the run's own window, the Myers least time."""

import math

import pytest

from portbench.harness import devtrace, peaks, stats


def test_percentile_is_nearest_rank_over_all_requests():
    values = list(range(1, 101))
    assert stats.percentile(values, 50) == 50
    assert stats.percentile(values, 95) == 95
    assert stats.percentile([3.0, math.inf, 1.0], 50) == 3.0
    assert stats.percentile([1.0] * 19 + [math.inf], 95) == 1.0
    assert stats.percentile([1.0] * 18 + [math.inf] * 2, 95) == math.inf
    assert stats.percentile([], 50) is None


def test_rate_counts_in_flight_posts_pro_rata_and_failures_as_nothing():
    posts = [stats.Post(0, 100, 0.0, 2.0, 200),
             stats.Post(0, 100, 2.0, 12.0, 200),     # half inside
             stats.Post(1, 100, 0.0, 1.0, 500),
             stats.Post(1, 100, 11.0, 13.0, 200)]    # starts after the close
    rate, latencies = stats.window_figures(posts, 0.0, 10.0)
    assert rate == pytest.approx((100 + 80) / 10.0)
    assert latencies[:2] == [pytest.approx(2000.0), pytest.approx(10000.0)]
    assert latencies[2] == math.inf
    assert len(latencies) == 3
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_busy_time_is_the_union_clipped_to_the_window():
    intervals = [(0, 4), (2, 6), (8, 12), (-5, -1)]
    assert stats.union_length(intervals, 1, 10) == 5 + 2
    assert stats.gaps(intervals, 1, 10) == [(6, 8)]
    assert stats.gaps([(3, 4)], 0, 10) == [(0, 3), (4, 10)]


class _Event:
    def __init__(self, name, start, dur, device):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        import torch

        return (torch.autograd.DeviceType.CUDA if self._dev
                else torch.autograd.DeviceType.CPU)


def test_the_trace_reads_only_the_runs_own_window():
    events = [_Event(devtrace.WINDOW_RANGE, 1000, 10_000, False),
              _Event("before", 0, 1500, True),           # 500 inside
              _Event("k1", 3000, 2000, True),
              _Event("Memcpy HtoD", 4000, 2000, True),   # overlaps k1
              _Event("after", 10_500, 5000, True),       # 500 inside
              _Event("late", 20_000, 100, True)]
    trace = devtrace.summarize(events, mono_at_window_start=900)
    assert trace.window_s == pytest.approx(10_000 / 1e9)
    assert trace.busy_s == pytest.approx((500 + 3000 + 500) / 1e9)
    assert trace.launches == 3
    assert trace.offset_ns == 100
    assert trace.idle == [(1500, 3000), (6000, 10_500)]
    spans = [("score", 5000, 9000), ("POST", 0, 20_000)]
    gaps = trace.idle_gaps(spans)
    assert gaps[0] == ["score", pytest.approx(4500 / 1e9)]
    assert gaps[1] == ["POST", pytest.approx(1500 / 1e9)]
    assert devtrace.summarize(events[1:], 0) is None


def test_the_myers_least_time_is_bounded_by_ops_or_bytes():
    peak = 64 * 132 * 1980e6
    q, c, l = 2048, 8192, 32
    steps = 12.0 * c * q
    t = peaks.myers_least_seconds(q, c, l, steps, peak)
    assert t == pytest.approx(steps * peaks.OPS_PER_WORD_STEP / peak)
    tiny = peaks.myers_least_seconds(q, c, l, 1.0, peak)
    assert tiny == pytest.approx(4 * (q * l + q + c * l + c + q * c)
                                 / peaks.PEAK_BYTES_PER_S)
    assert peaks.kernel_words(32) == 1 and peaks.kernel_words(33) == 2
