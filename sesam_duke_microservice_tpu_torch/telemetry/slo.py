"""Always-on runtime SLO signals (a copy of the JAX package's
``telemetry/slo.py``).

Scrape-served latency-objective families an autoscaling controller and a
push-delivery consumer-lag contract can consume at runtime:

  * ``SloTracker`` — per (signal, workload) latency accounting measured
    from SCHEDULER ARRIVAL for ingest (the queueing delay closed-loop
    benches hide) and from handler
    entry for feed reads.  Each tracker keeps a latency histogram on the
    shared ``DEFAULT_LATENCY_BUCKETS`` ladder, a monotone violation
    counter, a coarse 10 s slot ring of request counts covering the
    longest window, and the **burn-rate ring**: a bounded deque of
    ``(timestamp, exemplar trace id)`` violation entries from which the
    5 m / 1 h windowed violation counts are recomputed exactly at scrape
    time.  The exemplar is the sampled trace id active when the
    violating request was recorded (None when unsampled), so
    ``GET /debug/slo`` can link a burn-rate alert straight to a causal
    tree in ``/debug/traces``.
  * burn rate (Google SRE Workbook multi-window discipline): the
    fraction of the error budget consumed per unit time —
    ``(violations/requests in window) / (1 - target)``.  A burn rate of
    1.0 spends exactly the budget; alerting pairs a fast window (5m)
    with a slow one (1h) so a page needs both to fire.
  * ``FeedLagMeter`` — per-workload ``duke_feed_lag_seconds``: age of
    the oldest link-feed row written since the last time a ``?since=``
    consumer drained the feed (0 when caught up).  Writers touch plain
    attributes (dispatcher thread / feed handler); torn reads are
    tolerated, the /stats stance.

Recording takes the tracker's leaf lock ONCE per dispatched microbatch
(``record_batch``) — never on the scoring path, never while any other
lock is held, so the lock hierarchy gains only leaves.

Env knobs: ``DUKE_SLO_INGEST_MS`` (default 1000), ``DUKE_SLO_FEED_MS``
(default 500) set the per-signal latency objectives;
``DUKE_SLO_TARGET`` (default 0.99) the success-ratio target shared by
the burn-rate gauges.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from ..env import env_float
from .registry import (DEFAULT_LATENCY_BUCKETS, FamilySnapshot,
                       histogram_snapshot)

# (label value, window seconds) — multi-window burn-rate pairs; the 5m
# window catches fast burns, the 1h window keeps slow burns visible.
WINDOWS: Tuple[Tuple[str, float], ...] = (("5m", 300.0), ("1h", 3600.0))

_SLOT_S = 10.0
_N_SLOTS = int(WINDOWS[-1][1] / _SLOT_S) + 1  # covers the longest window
_VIOLATION_RING = 8192  # burn-rate ring capacity (violation timestamps)


def _objective_seconds(signal: str) -> float:
    if signal == "feed":
        return env_float("DUKE_SLO_FEED_MS", 500.0) / 1000.0
    return env_float("DUKE_SLO_INGEST_MS", 1000.0) / 1000.0


def _target() -> float:
    # clamp away 1.0: a zero error budget makes burn rate undefined
    return min(env_float("DUKE_SLO_TARGET", 0.99), 0.9999)


class SloTracker:
    """Latency-objective accounting for one (signal, workload) pair.

    All mutable state is guarded by the leaf ``_lock``; nothing is ever
    called with another lock held (the rollup/scrape rule)."""

    __slots__ = ("objective_s", "target", "_lock", "_slots",
                 "_violation_ts", "violations_total", "_counts", "_sum",
                 "_count")

    def __init__(self, objective_s: float, target: float):
        self.objective_s = objective_s
        self.target = target
        self._lock = threading.Lock()
        # [slot_index, requests] per 10s slot, lazily recycled
        self._slots: List[List[float]] = [
            [-1, 0] for _ in range(_N_SLOTS)]  # guarded by: self._lock
        # the burn-rate ring: (monotonic ts, exemplar trace id or None)
        self._violation_ts: Deque[Tuple[float, Optional[str]]] = deque(
            maxlen=_VIOLATION_RING)  # guarded by: self._lock
        self.violations_total = 0  # guarded by: self._lock
        # latency histogram on the shared ladder (+Inf slot last)
        self._counts = [0] * (len(DEFAULT_LATENCY_BUCKETS) + 1)  # guarded by: self._lock
        self._sum = 0.0  # guarded by: self._lock
        self._count = 0  # guarded by: self._lock

    def record_batch(self, latencies: Sequence[float],
                     now: Optional[float] = None,
                     trace_ids: Optional[Sequence[Optional[str]]] = None
                     ) -> None:
        """One lock acquisition for a whole dispatched microbatch.

        ``trace_ids`` (parallel to ``latencies`` when given) supplies
        the sampled exemplar trace id per request; None entries mean
        the request's trace was unsampled."""
        if not latencies:
            return
        now = time.monotonic() if now is None else now
        slot_idx = int(now // _SLOT_S)
        with self._lock:
            cell = self._slots[slot_idx % _N_SLOTS]
            if cell[0] != slot_idx:
                cell[0], cell[1] = slot_idx, 0
            cell[1] += len(latencies)
            for i, lat in enumerate(latencies):
                self._counts[bisect_left(DEFAULT_LATENCY_BUCKETS, lat)] += 1
                self._sum += lat
                self._count += 1
                if lat > self.objective_s:
                    self.violations_total += 1
                    exemplar = trace_ids[i] if trace_ids else None
                    self._violation_ts.append((now, exemplar))

    def record(self, latency_s: float, now: Optional[float] = None,
               trace_id: Optional[str] = None) -> None:
        self.record_batch((latency_s,), now, (trace_id,))

    def scrape(self, now: Optional[float] = None):
        """(hist_samples_state, violations_total, {window: (requests,
        violations, burn_rate)}) under one lock hold."""
        now = time.monotonic() if now is None else now
        budget = 1.0 - self.target
        with self._lock:
            counts = list(self._counts)
            total, count = self._sum, self._count
            violations_total = self.violations_total
            windows = {}
            for wname, wsec in WINDOWS:
                min_slot = int((now - wsec) // _SLOT_S)
                requests = sum(int(c[1]) for c in self._slots
                               if c[0] >= min_slot)
                cutoff = now - wsec
                violations = sum(1 for t, _tid in self._violation_ts
                                 if t >= cutoff)
                rate = ((violations / requests) / budget) if requests else 0.0
                windows[wname] = (requests, violations, rate)
        return (counts, total, count), violations_total, windows

    def recent_violations(self, limit: int = 20
                          ) -> List[Tuple[float, Optional[str]]]:
        """Newest-first (monotonic ts, exemplar trace id) entries."""
        with self._lock:
            tail = list(self._violation_ts)[-limit:]
        tail.reverse()
        return tail


_TRACKERS: Dict[Tuple[str, str, str], SloTracker] = {}  # guarded by: _REG_LOCK [writes]
_REG_LOCK = threading.Lock()


def tracker(signal: str, kind: str, name: str) -> SloTracker:
    """Get-or-create the tracker for (signal, kind, workload); the
    steady state is one dict hit (callers may also cache the return)."""
    key = (signal, kind, name)
    t = _TRACKERS.get(key)
    if t is None:
        with _REG_LOCK:
            t = _TRACKERS.get(key)
            if t is None:
                t = SloTracker(_objective_seconds(signal), _target())
                _TRACKERS[key] = t
    return t


class FeedLagMeter:
    """Per-workload feed-cursor lag: plain attributes, single writer per
    field (dispatcher notes writes, feed handler notes drains)."""

    __slots__ = ("last_write_unix", "oldest_pending_unix")

    def __init__(self):
        self.last_write_unix = 0.0
        self.oldest_pending_unix = 0.0

    def note_write(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        self.last_write_unix = now
        if not self.oldest_pending_unix:
            self.oldest_pending_unix = now

    def note_drain(self) -> None:
        """A ``?since=`` consumer just drained the feed — caught up."""
        self.oldest_pending_unix = 0.0

    def lag_seconds(self, now: Optional[float] = None) -> float:
        pending = self.oldest_pending_unix
        if not pending:
            return 0.0
        now = time.time() if now is None else now
        return max(0.0, now - pending)


_METERS: Dict[Tuple[str, str], FeedLagMeter] = {}  # guarded by: _REG_LOCK [writes]


def feed_meter(kind: str, name: str) -> FeedLagMeter:
    key = (kind, name)
    m = _METERS.get(key)
    if m is None:
        with _REG_LOCK:
            m = _METERS.get(key)
            if m is None:
                m = FeedLagMeter()
                _METERS[key] = m
    return m


def _reset_for_tests() -> None:
    with _REG_LOCK:
        _TRACKERS.clear()
        _METERS.clear()


def collect() -> List[FamilySnapshot]:
    """Scrape-time collector (registered on ``telemetry.GLOBAL``).

    Each tracker's lock is taken once, sequentially — never nested with
    any other lock."""
    with _REG_LOCK:
        trackers = sorted(_TRACKERS.items())
        meters = sorted(_METERS.items())
    now = time.monotonic()
    ingest_hist, feed_hist = [], []
    violations, burn, objective = [], [], []
    for (signal, kind, name), t in trackers:
        base = (("kind", kind), ("workload", name))
        (counts, total, count), v_total, windows = t.scrape(now)
        hist = histogram_snapshot(DEFAULT_LATENCY_BUCKETS, counts, total,
                                  count, base)
        (feed_hist if signal == "feed" else ingest_hist).extend(hist)
        sig = base + (("signal", signal),)
        violations.append(("", sig + (("window", "all"),), v_total))
        for wname, (_requests, wviol, rate) in windows.items():
            violations.append(("", sig + (("window", wname),), wviol))
            burn.append(("", sig + (("window", wname),), rate))
        objective.append(("", sig, t.objective_s))
    lag = [("", (("kind", kind), ("workload", name)), m.lag_seconds())
           for (kind, name), m in meters]
    return [
        FamilySnapshot(
            "duke_slo_ingest_latency_seconds", "histogram",
            "Per-workload ingest latency measured from scheduler arrival "
            "to microbatch completion (includes queueing delay)",
            ingest_hist),
        FamilySnapshot(
            "duke_slo_feed_latency_seconds", "histogram",
            "Per-workload ?since= feed read latency measured at the "
            "handler", feed_hist),
        FamilySnapshot(
            "duke_slo_violations_total", "counter",
            "Requests over the latency objective; window=all is the "
            "monotone total, window=5m/1h are recomputed at scrape from "
            "the violation-timestamp ring", violations),
        FamilySnapshot(
            "duke_slo_burn_rate", "gauge",
            "Error-budget burn rate per window: (violation ratio) / "
            "(1 - DUKE_SLO_TARGET); 1.0 spends exactly the budget",
            burn),
        FamilySnapshot(
            "duke_slo_objective_seconds", "gauge",
            "Latency objective per signal (DUKE_SLO_INGEST_MS / "
            "DUKE_SLO_FEED_MS)", objective),
        FamilySnapshot(
            "duke_feed_lag_seconds", "gauge",
            "Age of the oldest link-feed row written since a ?since= "
            "consumer last drained the feed (0 when caught up)", lag),
    ]


def debug_snapshot(limit: int = 20) -> Dict[str, object]:
    """``GET /debug/slo`` payload: per-tracker objective, totals and
    burn-rate windows plus the newest violations with exemplar trace
    links (``/debug/traces/<id>``) where the violating request's trace
    was sampled."""
    with _REG_LOCK:
        trackers = sorted(_TRACKERS.items())
    now_mono = time.monotonic()
    now_unix = time.time()
    out = []
    for (signal, kind, name), t in trackers:
        _hist, v_total, windows = t.scrape(now_mono)
        violations = []
        for ts, trace_id in t.recent_violations(limit):
            violations.append({
                "unix_ts": round(now_unix - (now_mono - ts), 3),
                "age_seconds": round(now_mono - ts, 3),
                "trace_id": trace_id,
                "trace": f"/debug/traces/{trace_id}" if trace_id else None,
            })
        out.append({
            "signal": signal,
            "kind": kind,
            "workload": name,
            "objective_seconds": t.objective_s,
            "target": t.target,
            "violations_total": v_total,
            "windows": {
                wname: {"requests": req, "violations": viol,
                        "burn_rate": round(rate, 6)}
                for wname, (req, viol, rate) in windows.items()
            },
            "recent_violations": violations,
        })
    return {"trackers": out}
