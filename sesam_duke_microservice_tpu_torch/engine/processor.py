"""The matching engine: the host reference implementation.

Counterpart of the JAX package's ``engine/processor.py``, with its phase
recorder, cost-ledger writes, trace spans and decision monitors.
It reproduces the Duke 1.2 ``Processor.deduplicate(List<Record>)``
contract the reference drives for both workloads (App.java:1005,
App.java:1159):

    batch_ready(n)
    index every record; commit the blocking database
    for each record: candidates = database.find_candidate_matches(record)
        for each candidate (skipping self): prob = compare(record, candidate)
            prob > threshold        -> matches()
            prob > maybe_threshold  -> matches_perhaps()
        no qualifying candidate     -> no_match_for()
    batch_done()

Pair probability: per comparison property, the max over value pairs of
``Property.compare_probability``, folded with naive Bayes from a 0.5 prior;
properties with no values on either side contribute nothing.  The device
backends finalize with the same ``compare`` (the exact f64 oracle).

With ``backend="host"`` this engine over ``index.inverted.InvertedIndex``
is the whole backend (the JAX package's default and conformance oracle).
``threads`` mirrors the reference's ``Processor.setThreads``
(App.java:344) by fanning the per-record loop over a thread pool.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, fields
from typing import List, Optional, Sequence

from ..core.bayes import combine_probabilities
from ..core.config import DukeSchema
from ..core.records import Record
from ..index.base import CandidateIndex
from ..telemetry import PhaseRecorder, costs, tracing
from .listeners import MatchListener

# Per-batch engine phases recorded into each processor's PhaseRecorder
# (surfaced as the duke_engine_phase_seconds histogram and the /stats
# phase_seconds map):
#   encode   — record indexing + index commit (feature extraction and
#              the device corpus append live inside commit on the device
#              backends)
#   retrieve — candidate retrieval (host index walk / device scoring
#              program wait)
#   score    — pair scoring + host finalization of survivors
#   persist  — listener batch_done work (link-database flush)
PHASE_ENCODE = "encode"
PHASE_RETRIEVE = "retrieve"
PHASE_SCORE = "score"
PHASE_PERSIST = "persist"


@dataclass
class ProfileStats:
    batches: int = 0
    records_processed: int = 0
    candidates_retrieved: int = 0
    pairs_compared: int = 0
    # host-finalization split: survivors rescored with the exact f64
    # compare vs survivors skipped by decisive-band pruning
    pairs_rescored: int = 0
    pairs_skipped: int = 0
    # device-certified finalization (DUKE_DEVICE_FINALIZE): certified
    # rejects that skipped the host compare, and the survivors left to
    # the host residue by reason -- inside the dd margin band, no
    # certifiable property, or an ``unsafe`` dd lane (tensors that may
    # have truncated the record, or a Jaro-Winkler value on a branch
    # boundary)
    pairs_device_certified: int = 0
    dd_blocks: int = 0           # blocks the dd rescore program ran on
    dd_residue_margin: int = 0
    dd_residue_kind: int = 0
    dd_residue_truncation: int = 0
    # host clocks.  The host engine writes retrieval and scoring per
    # record.  The device backends write the pass's true intervals
    # (``DeviceProcessor``): dispatch (query preparation, the corpus
    # upload, the scorer's launches), wait (the block's results and any
    # width escalation), dd (the dd rescore's gate, program and copy
    # back) and finalize (the host f64 loop and the listener events).
    # ``retrieval_total`` / ``compare_total`` read either engine's.
    retrieval_seconds: float = 0.0
    compare_seconds: float = 0.0
    dispatch_seconds: float = 0.0
    wait_seconds: float = 0.0
    dd_seconds: float = 0.0
    finalize_seconds: float = 0.0
    # the device backends' CUDA-event time of the pass's programs (0 on
    # the CPU) and the bytes they handed host to device
    device_seconds: float = 0.0
    h2d_bytes: int = 0

    def retrieval_total(self) -> float:
        """Retrieval seconds of either engine: the host engine's own
        clock, or the device backends' dispatch plus wait."""
        return self.retrieval_seconds + self.dispatch_seconds \
            + self.wait_seconds

    def compare_total(self) -> float:
        """Scoring seconds of either engine: the host engine's own clock,
        or the device backends' dd rescore plus host finalization."""
        return self.compare_seconds + self.dd_seconds \
            + self.finalize_seconds

    def merge(self, other: "ProfileStats") -> None:
        """Add ``other``'s counters and clocks into this one."""
        for f in fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


class Processor:
    """``deduplicate`` over a candidate index, plus the naive-Bayes pair
    probability (``compare``) every backend emits its confidences with.
    ``database`` may be None for a caller that only compares pairs."""

    def __init__(self, schema: DukeSchema,
                 database: Optional[CandidateIndex] = None, *,
                 group_filtering: bool = False, threads: int = 1):
        self.schema = schema
        self.database = database
        self.group_filtering = group_filtering
        self.threads = max(1, threads)
        self.listeners: List[MatchListener] = []
        self.stats = ProfileStats()
        # single-writer (one thread runs a workload's batches at a time):
        # plain attribute math, no locks on the scoring path; /metrics and
        # /stats read it lock-free like the ProfileStats counters
        self.phases = PhaseRecorder()
        self._listener_lock = threading.Lock()
        # decision monitors and ring: host pairs carry no device
        # pre-score, so only outcome counters, the pair-logit histogram
        # and sampled ring records apply; writes serialize on the
        # listener lock (the threaded per-record loop's emission barrier)
        from ..telemetry.decisions import DecisionRecorder
        from .explain import host_breakdown

        self.decisions = DecisionRecorder(
            schema.threshold, schema.maybe_threshold,
            breakdown=lambda q, c: host_breakdown(schema, q, c),
            # a bare-compare embedder passes no database; sampled
            # records then skip the breakdown
            resolver=(database.find_record_by_id
                      if database is not None else None),
        )

    def add_match_listener(self, listener: MatchListener) -> None:
        self.listeners.append(listener)

    # -- pair scoring -------------------------------------------------------

    def compare(self, r1: Record, r2: Record) -> float:
        """Naive-Bayes pair probability over comparison properties."""
        probs = []
        for prop in self.schema.comparison_properties():
            vs1 = [v for v in r1.get_values(prop.name) if v]
            vs2 = [v for v in r2.get_values(prop.name) if v]
            if not vs1 or not vs2:
                continue
            best = 0.0
            for v1 in vs1:
                for v2 in vs2:
                    p = prop.compare_probability(v1, v2)
                    if p > best:
                        best = p
            probs.append(best)
        return combine_probabilities(probs)

    # -- batch processing ---------------------------------------------------

    def deduplicate(self, records: Sequence[Record]) -> None:
        for listener in self.listeners:
            listener.batch_ready(len(records))
        t0 = time.monotonic()
        with tracing.span(PHASE_ENCODE, {"records": len(records)}):
            for record in records:
                self.database.index(record)
            self.database.commit()
        t1 = time.monotonic()
        retrieval0 = self.stats.retrieval_seconds
        compare0 = self.stats.compare_seconds
        match_ns = time.monotonic_ns()
        if self.threads == 1:
            for record in records:
                self._match_record(record)
        else:
            # worker threads adopt the request's trace context so any
            # spans they open land in the same tree (tracing.attach)
            ctx = tracing.current_context()
            with ThreadPoolExecutor(max_workers=self.threads) as pool:
                list(pool.map(
                    lambda r: self._match_record_in_ctx(ctx, r), records))
        self.stats.batches += 1
        t2 = time.monotonic()
        with tracing.span(PHASE_PERSIST):
            for listener in self.listeners:
                listener.batch_done()
        # per-batch phase observations (per-record splits accumulated in
        # ProfileStats above; the histogram granule is the batch)
        retrieve_dt = self.stats.retrieval_seconds - retrieval0
        score_dt = self.stats.compare_seconds - compare0
        persist_dt = time.monotonic() - t2
        self.phases.observe(PHASE_ENCODE, t1 - t0)
        self.phases.observe(PHASE_RETRIEVE, retrieve_dt)
        self.phases.observe(PHASE_SCORE, score_dt)
        self.phases.observe(PHASE_PERSIST, persist_dt)
        # the same four durations feed the process-wide busy ledger, so
        # per-workload phase counters reconcile against it by definition
        costs.note_busy((t1 - t0) + retrieve_dt + score_dt + persist_dt)
        # retrieval and scoring interleave per record (and across the
        # thread pool): the shared aggregate-span layout
        tracing.add_phase_spans(match_ns, retrieve_dt, score_dt)

    def _match_record_in_ctx(self, ctx, record: Record) -> None:
        """Pool-thread entry: re-enter the submitting request's trace."""
        if ctx is None:
            self._match_record(record)
            return
        with tracing.attach(ctx):
            self._match_record(record)

    def _match_record(self, record: Record) -> None:
        t0 = time.monotonic()
        candidates = self.database.find_candidate_matches(
            record, group_filtering=self.group_filtering)
        t1 = time.monotonic()

        found = False
        threshold = self.schema.threshold
        maybe = self.schema.maybe_threshold
        pairs = 0
        scored = [] if self.decisions.enabled else None
        for candidate in candidates:
            if candidate.record_id == record.record_id:
                continue
            prob = self.compare(record, candidate)
            pairs += 1
            if scored is not None:
                scored.append((candidate.record_id, prob))
            if prob > threshold:
                found = True
                self._emit("matches", record, candidate, prob)
            elif maybe is not None and maybe != 0.0 and prob > maybe:
                found = True
                self._emit("matches_perhaps", record, candidate, prob)
        if not found:
            with self._listener_lock:
                for listener in self.listeners:
                    listener.no_match_for(record)
        if scored:
            # the recorder is single-writer; the listener lock is the
            # serialization point the threaded loop already has
            with self._listener_lock:
                self.decisions.observe_pairs(record, scored)

        t2 = time.monotonic()
        self.stats.records_processed += 1
        self.stats.candidates_retrieved += len(candidates)
        self.stats.pairs_compared += pairs
        self.stats.retrieval_seconds += t1 - t0
        self.stats.compare_seconds += t2 - t1

    def _emit(self, event: str, r1: Record, r2: Record, prob: float) -> None:
        with self._listener_lock:
            for listener in self.listeners:
                getattr(listener, event)(r1, r2, prob)
