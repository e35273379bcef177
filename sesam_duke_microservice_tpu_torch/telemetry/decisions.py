"""Match-decision flight recorder, quality-drift monitors, audit log (a
copy of the JAX package's ``telemetry/decisions.py``).

The engine's whole output is a stream of *decisions* (match / maybe /
reject / pruned, per scored pair), while the phase recorder and the
latency histograms observe only time.  This module makes decisions
observable without touching the scoring hot path's complexity budget:

  * ``DecisionRecorder`` — one per processor, written ONLY by the
    coordinating thread that already emits listener events serially
    (single-writer, the ProfileStats/PhaseRecorder discipline), so every
    update is plain attribute math with no locks on the engine path.
    It maintains:

      - **drift monitors**: outcome counters
        (``duke_decisions_total{outcome}``), a device-vs-host
        disagreement counter, a pair-logit distribution histogram, a
        decisive-band margin-slack histogram, and per-property
        similarity histograms (fed from the sampled breakdowns only —
        the one non-O(1) piece).  All are scrape-time snapshots
        (service/metrics.py); the engine never writes a registry child.
      - **the decision ring**: a sampled, byte-bounded ``LatchedRing``
        of full decision records (``GET /debug/decisions``).  The tail
        latch keeps every *disagreement* and every
        *near-threshold band skip* regardless of the sample rate — the
        two decision classes an operator tuning thresholds or auditing
        the f32 device path actually needs.

  * ``AuditLog`` — optional append-only JSONL of confirmed link
    decisions (``DUKE_AUDIT_LOG=path``), flushed through the shared
    write-behind machinery (links.write_behind.WriteBehindBuffer) so a
    slow audit disk can never block scoring: past the pending cap the
    OLDEST batch drops (counted), the opposite of the link store's
    backpressure stance — links are truth, audit is evidence.

Disagreement definition (the ``duke_decision_disagreements_total``
contract): the float32 device verdict — classify(sigmoid(device_logit +
host_bound)) — lands on a different side of the thresholds than the
exact f64 rescore.  For schemas whose every property has a device kernel
(``host_bound == 0``) this is a true f32-vs-f64 numeric disagreement;
with host-scored properties the device term is the optimistic filter
bound, so the counter also surfaces how often the filter's optimism
crossed a threshold the exact rescore did not.  Near-threshold band
skip: a pruned survivor whose slack below the decisive bound is within
one certified margin — the skips that would flip first if the margin
were wrong.

Env knobs (read at recorder construction):
  DUKE_DECISION_RECORD   0 disables the whole subsystem (bench baseline)
  DUKE_DECISION_SAMPLE   ring/breakdown sample rate, default 0.01
  DUKE_DECISION_RING     ring capacity in records, default 256
  DUKE_DECISION_RING_KB  ring byte budget, default 512 KiB
  DUKE_AUDIT_LOG         JSONL path; unset disables the audit log
"""

from __future__ import annotations

import hashlib
import itertools
import json
import logging
import math
import random
import threading
import time
from bisect import bisect_left
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.bayes import probability_logit
from .env import env_flag, env_float, env_int, env_str
from .logctx import current_request_id
from .registry import histogram_snapshot
from .rings import LatchedRing
from .tracing import current_trace_id

logger = logging.getLogger("decisions")

__all__ = [
    "DecisionRecorder",
    "PairDecision",
    "AuditLog",
    "audit_log",
    "classify",
    "probability_to_logit",
    "explanation_digest",
]

# Pair-logit distribution bounds: symmetric, dense around the typical
# threshold region (logit(0.8)=1.39, logit(0.95)=2.94), clamped wide for
# multi-property certainty sums.
PAIR_LOGIT_BOUNDS: Tuple[float, ...] = (
    -30.0, -20.0, -10.0, -5.0, -3.0, -2.0, -1.0, -0.5, 0.0,
    0.5, 1.0, 2.0, 3.0, 5.0, 10.0, 20.0, 30.0,
)

# Decisive-band slack (prune_logit - device_logit, logit units): log-ish
# ladder from "a whisker inside the band" to "nowhere near emitting".
MARGIN_SLACK_BOUNDS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
)

# Comparator similarity in [0, 1]; finer near the top where Duke's
# quadratic probability map actually moves.
SIMILARITY_BOUNDS: Tuple[float, ...] = (
    0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.99,
)

# THE engine's clamped logit (core.bayes): the drift monitors must
# report the same log-odds the Bayes fold actually sums, not a copy
# that could diverge on a clamp change
probability_to_logit = probability_logit


def classify(prob: float, threshold: float,
             maybe: Optional[float]) -> str:
    """The engine's threshold decision (engine.processor emit rules)."""
    if prob > threshold:
        return "match"
    if maybe is not None and maybe != 0.0 and prob > maybe:
        return "maybe"
    return "reject"


def explanation_digest(digest1: bytes, digest2: bytes,
                       probability: float) -> str:
    """Stable short digest joining an audit row to a later ``/explain``
    replay: record CONTENT digests (store.records.record_digest — so a
    re-indexed record changes the digest) plus the emitted probability."""
    h = hashlib.sha256(digest1)
    h.update(digest2)
    h.update(repr(float(probability)).encode())
    return h.hexdigest()[:16]


class _MonitorHist:
    """Single-writer histogram state (the PhaseRecorder discipline):
    plain attribute math on the engine path, ``samples()`` renders the
    Prometheus shape at scrape time."""

    __slots__ = ("bounds", "counts", "total", "count")

    def __init__(self, bounds: Sequence[float]):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect_left(self.bounds, value)] += 1
        self.total += value
        self.count += 1

    def samples(self, labels: Tuple[Tuple[str, str], ...]):
        return histogram_snapshot(
            self.bounds, list(self.counts), self.total, self.count, labels
        )


class PairDecision:
    """One finalized pair's decision inputs, built by the finalize
    workers (cheap tuple-of-scalars) and consumed serially by the
    coordinator's ``DecisionRecorder.observe``."""

    __slots__ = ("candidate_id", "device_logit", "skipped", "probability",
                 "path")

    def __init__(self, candidate_id: str, device_logit: Optional[float],
                 skipped: bool, probability: Optional[float],
                 path: Optional[str] = None):
        self.candidate_id = candidate_id
        self.device_logit = device_logit
        self.skipped = skipped
        self.probability = probability
        # which finalization path skipped the pair: None (band skip /
        # rescored) or "device_certified" (dd certified reject)
        self.path = path


_DECISION_SEQ = itertools.count(1)


class DecisionRecorder:
    """Per-processor decision observability (see module docstring).

    ``breakdown(query, candidate)`` is the per-property explanation
    callable (engine.explain.host_breakdown bound to the schema) — only
    invoked for decisions entering the ring, so its cost rides the
    sample rate, not the pair rate.  ``resolver`` maps a candidate id to
    its live Record for that breakdown.
    """

    def __init__(self, threshold: float, maybe: Optional[float], *,
                 breakdown: Optional[Callable] = None,
                 resolver: Optional[Callable] = None,
                 sample_rate: Optional[float] = None,
                 capacity: Optional[int] = None,
                 byte_budget: Optional[int] = None,
                 enabled: Optional[bool] = None,
                 workload: str = "", kind: str = ""):
        if enabled is None:
            enabled = env_flag("DUKE_DECISION_RECORD", True)
        self.enabled = enabled
        self.threshold = float(threshold)
        self.maybe = maybe
        self._breakdown = breakdown
        self._resolver = resolver
        self.workload = workload
        self.kind = kind
        if sample_rate is None:
            sample_rate = env_float("DUKE_DECISION_SAMPLE", 0.01)
        self.sample_rate = min(1.0, max(0.0, sample_rate))
        if capacity is None:
            capacity = env_int("DUKE_DECISION_RING", 256)
        if byte_budget is None:
            byte_budget = env_int("DUKE_DECISION_RING_KB", 512) * 1024
        self.ring = LatchedRing(max(1, capacity), byte_budget)
        self._rng = random.Random()
        # single-writer drift-monitor state (scrape-time snapshots)
        self.outcomes: Dict[str, int] = {
            "match": 0, "maybe": 0, "reject": 0, "pruned": 0,
            "device_certified": 0,
        }
        self.disagreements = 0
        self.latched = 0
        self.sampled = 0
        self.pair_logit_hist = _MonitorHist(PAIR_LOGIT_BOUNDS)
        self.margin_slack_hist = _MonitorHist(MARGIN_SLACK_BOUNDS)
        self.similarity_hists: Dict[str, _MonitorHist] = {}

    # -- the engine-path write (single writer: the event coordinator) --------

    def observe(self, query, decisions: Sequence[PairDecision], *,
                prune: Optional[float] = None,
                margin: Optional[float] = None,
                host_bound: float = 0.0) -> None:
        """Fold one query's finalized pair decisions into the monitors
        and (sampled / latched) the ring.  ``prune`` and ``margin`` are
        the block's decisive-band bound and certified f32 margin
        (None on backends without a decisive band)."""
        if not self.enabled or not decisions:
            return
        threshold, maybe = self.threshold, self.maybe
        for d in decisions:
            latch = None
            pair_logit = None
            if d.skipped:
                if getattr(d, "path", None) == "device_certified":
                    # dd certified reject: not a band skip —
                    # the dd logit sat ABOVE the prune bound, so the
                    # band-slack histogram and near-band latch do not
                    # apply (its own certification band is ~1e-10 and
                    # residue pairs go to the host instead of
                    # skipping).  Ring SAMPLING below still does:
                    # certified rejects must stay auditable.
                    outcome = "device_certified"
                else:
                    outcome = "pruned"
                    if prune is not None and d.device_logit is not None:
                        slack = prune - d.device_logit
                        self.margin_slack_hist.observe(slack)
                        if margin is not None and slack <= margin:
                            # the skips that would flip first if the
                            # certified margin were wrong: always
                            # retained
                            latch = "near-band-skip"
            else:
                outcome = classify(d.probability, threshold, maybe)
                pair_logit = probability_to_logit(d.probability)
                self.pair_logit_hist.observe(pair_logit)
                if d.device_logit is not None:
                    f32_prob = 1.0 / (
                        1.0 + math.exp(-(d.device_logit + host_bound))
                    )
                    if classify(f32_prob, threshold, maybe) != outcome:
                        self.disagreements += 1
                        latch = "disagreement"
            self.outcomes[outcome] += 1
            sampled = (self.sample_rate > 0.0
                       and self._rng.random() < self.sample_rate)
            if latch is None and not sampled:
                continue
            if latch is not None:
                self.latched += 1
            if sampled:
                self.sampled += 1
            self._capture(query, d, outcome, pair_logit, prune, margin,
                          latch, sampled)

    def _capture(self, query, d: PairDecision, outcome: str,
                 pair_logit: Optional[float], prune: Optional[float],
                 margin: Optional[float], latch: Optional[str],
                 sampled: bool) -> None:
        """Build the full decision record (ring path only — never the
        per-pair fast path)."""
        record: Dict[str, Any] = {
            "id": f"d{next(_DECISION_SEQ):08d}",
            "time_unix": round(time.time(), 3),
            "query": query.record_id,
            "candidate": d.candidate_id,
            "outcome": outcome,
            "sampled": sampled,
            "latched": latch,
            "trace_id": current_trace_id(),
            "request_id": current_request_id(),
        }
        if d.device_logit is not None:
            record["device_logit"] = round(d.device_logit, 6)
        if prune is not None:
            record["decisive_prune_logit"] = round(prune, 6)
            if d.device_logit is not None and d.skipped:
                record["margin_slack"] = round(prune - d.device_logit, 6)
        if margin is not None:
            record["certified_margin"] = round(margin, 9)
        if d.probability is not None:
            record["probability"] = d.probability
            record["pair_logit"] = round(pair_logit, 6)
        if self._breakdown is not None and self._resolver is not None:
            candidate = self._resolver(d.candidate_id)
            if candidate is not None:
                try:
                    explained = self._breakdown(query, candidate)
                except Exception:  # degraded record, never a dead batch
                    logger.exception("decision breakdown failed")
                    explained = None
                if explained is not None:
                    record["properties"] = explained["properties"]
                    record["host_pair_logit"] = round(
                        explained["pair_logit"], 6)
                    for prop in explained["properties"]:
                        sim = prop.get("best_similarity")
                        if sim is None:
                            continue
                        hist = self.similarity_hists.get(prop["name"])
                        if hist is None:
                            hist = _MonitorHist(SIMILARITY_BOUNDS)
                            self.similarity_hists[prop["name"]] = hist
                        hist.observe(sim)
        nbytes = len(json.dumps(record, separators=(",", ":")))
        self.ring.put(record["id"], record, remarkable=latch is not None,
                      nbytes=nbytes)

    # -- host-engine convenience ---------------------------------------------

    def observe_pairs(self, query,
                      pairs: Sequence[Tuple[str, float]]) -> None:
        """Host-engine entry: (candidate_id, probability) pairs with no
        device pre-score (no band, no disagreement surface)."""
        if not self.enabled or not pairs:
            return
        self.observe(query, [
            PairDecision(cid, None, False, prob) for cid, prob in pairs
        ])

    # -- scrape-time reads ----------------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        return self.ring.records()

    def get(self, decision_id: str) -> Optional[Dict[str, Any]]:
        return self.ring.get(decision_id)


# -- audit log ----------------------------------------------------------------


class AuditLog:
    """Append-only JSONL of confirmed link decisions.

    Entries buffer through a ``WriteBehindBuffer`` (the link store's
    machinery) with ``drop_on_overflow`` — the audit file is evidence,
    not truth, so a stalled disk drops oldest batches (counted in
    ``dropped``) instead of backpressuring ingest.  A flush failure
    disables the log (logged once); scoring proceeds.
    """

    def __init__(self, path: str, *, max_pending: int = 64):
        from ..links.write_behind import WriteBehindBuffer

        self.path = path
        self.entries = 0
        self._disabled = False
        self._lock = threading.Lock()
        self._wb = WriteBehindBuffer(
            self._write_batch, max_pending=max_pending,
            drop_on_overflow=True, name="audit-log",
        )

    @property
    def dropped(self) -> int:
        return self._wb.dropped

    @property
    def disabled(self) -> bool:
        return self._disabled

    def _write_batch(self, batch: List[str]) -> None:
        with open(self.path, "a", encoding="utf-8") as f:
            f.write("".join(batch))

    def append(self, entry: Dict[str, Any]) -> None:
        """Buffer one entry; never raises into the scoring path."""
        if self._disabled:
            return
        try:
            line = json.dumps(entry, separators=(",", ":")) + "\n"
            with self._lock:
                self._wb.add(line)
        except Exception:
            self._disabled = True
            logger.exception(
                "audit log disabled after write-behind failure (%s)",
                self.path,
            )
            return
        self.entries += 1

    def flush(self) -> None:
        """Seal the buffered entries for the background flusher (called
        from listener ``batch_done`` — the persist phase, off the
        scoring loop)."""
        if self._disabled:
            return
        try:
            self._wb.commit()
        except Exception:
            self._disabled = True
            logger.exception("audit log disabled (flush enqueue failed)")

    def drain(self) -> None:
        if self._disabled:
            return
        try:
            self._wb.drain()
        except Exception:
            self._disabled = True
            logger.exception("audit log disabled (drain failed)")

    def close(self) -> None:
        self._wb.close()


_AUDIT_LOCK = threading.Lock()
_AUDIT: Optional[AuditLog] = None
_AUDIT_PATH: Optional[str] = None


def audit_log() -> Optional[AuditLog]:
    """The process-wide audit log for ``DUKE_AUDIT_LOG``, or None.

    One instance per path (multiple workloads share the single
    background writer, so JSONL lines never interleave mid-record); the
    env var is re-read so tests can point at a fresh temp file.
    """
    global _AUDIT, _AUDIT_PATH
    path = env_str("DUKE_AUDIT_LOG") or None
    with _AUDIT_LOCK:
        if path != _AUDIT_PATH:
            if _AUDIT is not None:
                _AUDIT.close()
            _AUDIT = AuditLog(path) if path else None
            _AUDIT_PATH = path
        return _AUDIT
