"""Sub-range heat maps.

The federation router's range stats stop at whole ranges: a range can
look evenly loaded while 80% of its traffic lands in 5% of its keyspace,
which makes the midpoint split the rebalancer would pick today exactly
wrong.  Each ``FederationRouter`` owns a ``HeatMap`` that buckets every
routed record's ``route_key`` into a fixed 256-bucket histogram over the
owning range's ``[lo, hi)`` span, fed on the ingest path with a plain
``counts[i] += 1`` -- no lock, same stance as the engine's unlocked
QUERY_BLOCKS counters: increments from concurrent submit threads may
rarely tear, and a heat map that is 99.9% accurate still points at the
same hot band.  Counts reset when a range's bounds change (splits /
migrations re-key the span, so old buckets would lie).

Bucket math: ``bucket = min(255, (key - lo) * 256 // (hi - lo))``.

Scrape rolls the buckets up as
``duke_fed_subrange_records_total{range,bucket}`` (non-zero buckets
only -- 256 series x N ranges of zeros would drown the exposition), and
``GET /debug/loadmap`` serves per-range bucket arrays plus a suggested
split point: the bucket boundary whose prefix sum best bisects the
observed load (ties to the lower key).  Routing notes fire on every
routing pass, so a record re-routed after a live migration is counted
once per attempt -- a <1-in-10^4 event bounded by migration frequency,
and irrelevant to where the hot band is.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .registry import FamilySnapshot

N_BUCKETS = 256


class HeatMap:
    """Per-router sub-range load histogram, keyed by range_id."""

    __slots__ = ("_ranges",)

    def __init__(self) -> None:
        # range_id -> [lo, hi, counts]; written by submit threads and
        # replaced wholesale on bound changes (dict assignment is
        # atomic); counts increments are intentionally unlocked.
        self._ranges: Dict[str, list] = {}

    def note(self, rng, key: int) -> None:
        """Count one routed record for ``rng`` (a federation ``Range``)."""
        entry = self._ranges.get(rng.range_id)
        if entry is None or entry[0] != rng.lo or entry[1] != rng.hi:
            entry = [rng.lo, rng.hi, [0] * N_BUCKETS]
            self._ranges[rng.range_id] = entry
        span = entry[1] - entry[0]
        if span <= 0:
            return
        bucket = (key - entry[0]) * N_BUCKETS // span
        if 0 <= bucket < N_BUCKETS:
            entry[2][bucket] += 1

    def snapshot(self) -> List[Tuple[str, int, int, List[int]]]:
        """[(range_id, lo, hi, counts-copy)] sorted by range_id."""
        out = []
        for range_id, entry in sorted(self._ranges.items()):
            out.append((range_id, entry[0], entry[1], list(entry[2])))
        return out

    def _reset_for_tests(self) -> None:
        self._ranges.clear()


def suggest_split(lo: int, hi: int, counts: List[int]) -> Optional[str]:
    """The bucket boundary best bisecting observed load, as a 16-hex-digit
    route key (None when the range saw no traffic or has a unit span)."""
    total = sum(counts)
    if total <= 0 or hi - lo < 2:
        return None
    best_k, best_err, prefix = 1, float("inf"), 0
    for k in range(1, N_BUCKETS):
        prefix += counts[k - 1]
        err = abs(prefix - total / 2)
        if err < best_err:
            best_k, best_err = k, err
    split = lo + (hi - lo) * best_k // N_BUCKETS
    if split <= lo or split >= hi:
        return None
    return f"{split:016x}"


def loadmap(heatmap: Optional[HeatMap]) -> Dict[str, object]:
    """``GET /debug/loadmap`` payload for one router's heat map."""
    ranges = []
    for range_id, lo, hi, counts in (heatmap.snapshot() if heatmap else []):
        total = sum(counts)
        hot_share = max(counts) / total if total else 0.0
        ranges.append({
            "range": range_id,
            "lo": f"{lo:016x}",
            "hi": f"{hi:016x}",
            "records_total": total,
            "buckets": counts,
            "hot_bucket_share": round(hot_share, 4),
            "suggested_split": suggest_split(lo, hi, counts),
        })
    return {"n_buckets": N_BUCKETS, "ranges": ranges}


def collect_family(heatmap: Optional[HeatMap]) -> FamilySnapshot:
    """``duke_fed_subrange_records_total`` rollup for the federation
    scrape (non-zero buckets only)."""
    samples = []
    for range_id, _lo, _hi, counts in (heatmap.snapshot() if heatmap else []):
        for bucket, n in enumerate(counts):
            if n:
                samples.append(
                    ("", (("range", range_id), ("bucket", str(bucket))),
                     float(n)))
    return FamilySnapshot(
        "duke_fed_subrange_records_total", "counter",
        "Records routed per 256th of each owned range's keyspan "
        "(non-zero buckets only); the rebalancer's split-point signal",
        samples)
