"""The metric arithmetic: rates over the window, percentiles over all
requests, device busy time over the run's own window.  Pure functions,
held by ``portbench/tests/test_portbench_metrics.py``."""

import math


def percentile(values, q):
    """Nearest-rank ``q``-th percentile (0 < q <= 100) of all ``values``;
    a failed request is ``math.inf`` and so sits above any limit."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(count, seconds):
    """Work per second over a window: all of the work, all of the time."""
    if seconds <= 0:
        raise ValueError("an empty window has no rate")
    return count / seconds


class Post:
    """One POST as its client saw it."""

    __slots__ = ("client", "records", "start", "end", "status")

    def __init__(self, client, records, start, end, status):
        self.client = client
        self.records = records
        self.start = start
        self.end = end
        self.status = status

    @property
    def ok(self):
        return self.status == 200

    @property
    def latency_ms(self):
        if not self.ok or self.end is None:
            return math.inf
        return (self.end - self.start) * 1e3


def window_figures(posts, t0, t1):
    """records/s over [t0, t1] and the latencies (ms) of every POST sent
    in the window.  A POST answered 200 counts its records spread evenly
    over its own service time, so the part of a POST in flight at the
    close that fell inside the window counts, and no more."""
    done = 0.0
    for p in posts:
        if not p.ok or p.end is None:
            continue
        span = p.end - p.start
        inside = min(p.end, t1) - max(p.start, t0)
        if inside <= 0:
            continue
        done += p.records * (inside / span if span > 0 else 1.0)
    sent = [p for p in posts if t0 <= p.start < t1]
    return rate(done, t1 - t0), [p.latency_ms for p in sent]


def union_length(intervals, lo, hi):
    """Length of the union of [start, end) intervals clipped to [lo, hi]."""
    total, edge = 0.0, lo
    for start, end in sorted(intervals):
        start, end = max(start, edge), min(end, hi)
        if end > start:
            total += end - start
            edge = end
    return total


def gaps(intervals, lo, hi):
    """The idle [start, end) stretches of [lo, hi] between intervals."""
    out, edge = [], lo
    for start, end in sorted(intervals):
        if start > edge and start <= hi:
            out.append((edge, min(start, hi)))
        edge = max(edge, min(end, hi))
        if edge >= hi:
            break
    if edge < hi:
        out.append((edge, hi))
    return out

