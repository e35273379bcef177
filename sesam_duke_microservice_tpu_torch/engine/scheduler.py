"""Continuous cross-request microbatching scheduler.

A copy of the JAX package's ``engine/scheduler.py``: same knobs, same
defaults, same dispatch order, and the same telemetry (the ingest SLO
tracker and feed-lag meter per microbatch, the single-writer queue
counters and histograms the /metrics ``duke_sched_*`` families and
``duke_tenant_throttled_total`` read), plus the port's own account of
the workload lock's contention: ``lock_requeues`` and ``lock_wait_s``
per queue, and a ``sched.lock_wait`` span under the head request's
trace.

The inference-serving "continuous batching" pattern (Orca, OSDI '22; vLLM,
SOSP '23) applied to record matching: instead of each HTTP POST walking the
engine alone under the per-workload lock — device launch shapes being
whatever batch size clients happen to send, overload answered by a bare
busy-503 — a per-workload bounded ingest queue sits between HTTP and the
engine and a single dispatcher thread:

  * **coalesces** concurrent POSTs into device-shaped microbatches: each
    pick drains the queue and, when the drained total still sits below its
    padding-bucket boundary (``engine.device_matcher.query_buckets`` — the
    ladder the jitted scorer shapes compile against), waits up to
    ``DUKE_SCHED_WINDOW_MS`` for more arrivals so the launch pads less.
    The window anchors on the HEAD request's enqueue time, so no request
    ever waits more than one window for a fuller launch;
  * **dispatches** each microbatch under the workload lock through
    ``Workload._run_merged`` — the same conflict-splitting merge the
    opportunistic lock-winner path uses — so per-request conversion
    errors stay per-request and event streams / link rows are
    bit-identical to serialized (queue-order) execution;
  * **admits** with an SLO estimate instead of lock-contention 503s:
    past ``DUKE_SCHED_QUEUE_MAX`` pending requests per workload,
    ``submit`` raises :class:`SchedulerReject` carrying a ``Retry-After``
    derived from the queued record count and the observed per-record
    dispatch rate (EWMA) — the HTTP layer maps it to 429;
  * **schedules fairly** across workloads with deficit round-robin
    (``DUKE_SCHED_QUANTUM`` records of quantum per round), so one hot
    tenant's deep queue cannot starve the others — their requests ride
    the next round, not the end of the hot queue;
  * **enforces per-tenant quotas**: ``DUKE_TENANT_WEIGHT`` scales each
    tenant's per-round quantum (``kind/name=2,name=0.5`` comma map) and
    ``DUKE_TENANT_MIN_SHARE`` is the starvation-proof floor every tenant
    earns regardless of weight.  Deficit-starved rounds count into
    ``duke_tenant_throttled_total``, and a down-weighted tenant's 429
    Retry-After scales by its weight so its clients back off at the rate
    it actually drains.

``DUKE_SCHEDULER=0`` disables the subsystem entirely; the HTTP layer then
falls back to today's lock-winner merge in ``Workload.submit_batch``.

Queues are keyed by (kind, name), and the dispatcher re-resolves the
workload from the live registry at dispatch time: a registry that replaces
the workload retargets queued requests at the replacement, and one that
REMOVES it fails them with :class:`WorkloadGone` (the HTTP layer's 404).
The dispatcher is the one thread that runs device work from its first
dispatch on; nothing the port arms per thread (the device trace, the
scorer's one-block lookahead, the current CUDA stream) assumes the HTTP
handler thread.  Shutdown drains: ``shutdown()`` stops admission and the
dispatcher completes every queued request before exiting, so no request
is ever lost or completed twice.
"""

from __future__ import annotations

import contextlib
import logging
import math
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..env import env_flag, env_float, env_int, env_str
from ..telemetry import slo, tracing
from ..telemetry.decisions import _MonitorHist

logger = logging.getLogger("ingest-scheduler")

__all__ = [
    "DatasetGone",
    "IngestScheduler",
    "SchedulerClosed",
    "SchedulerReject",
    "WorkloadGone",
    "parse_tenant_weights",
    "scheduler_enabled",
]


def scheduler_enabled() -> bool:
    """``DUKE_SCHEDULER=0`` restores the pre-scheduler ingest path."""
    return env_flag("DUKE_SCHEDULER", True)


# ONE copy of the smoothing/clamp policy shared by every Retry-After
# source (the scheduler's sec/record estimator here and the workload
# lock-hold tracker in engine.workload) — tuning it cannot diverge.
EWMA_ALPHA = 0.3


def fold_ewma(prev: Optional[float], sample: float) -> float:
    """Exponentially-weighted fold; ``prev`` None seeds with the sample."""
    if prev is None:
        return sample
    return (1.0 - EWMA_ALPHA) * prev + EWMA_ALPHA * sample


def retry_after_seconds(estimate: float) -> int:
    """Whole-second Retry-After: ceil'd, clamped to [1, 60]."""
    return int(min(60, max(1, math.ceil(estimate))))


def parse_tenant_weights(spec: Optional[str] = None) -> Dict[str, float]:
    """``DUKE_TENANT_WEIGHT`` parse: a comma map of ``key=weight`` where
    key is ``kind/name`` (most specific) or bare ``name``.  Weights
    scale each tenant's DRR quantum; unlisted tenants weigh 1.0.
    Malformed entries are skipped with a log line — a typo must never
    take admission down."""
    if spec is None:
        spec = env_str("DUKE_TENANT_WEIGHT", "")
    out: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, value = part.partition("=")
        try:
            if not sep or not key.strip():
                raise ValueError("missing '=' or empty key")
            out[key.strip()] = max(0.0, float(value))
        except ValueError:
            logger.warning("ignoring malformed DUKE_TENANT_WEIGHT "
                           "entry %r", part)
    return out


class SchedulerReject(Exception):
    """Admission refused: the workload's queue is at DUKE_SCHED_QUEUE_MAX.

    ``retry_after`` is the SLO estimate in whole seconds (>= 1) the HTTP
    layer forwards as the 429's Retry-After header."""

    def __init__(self, retry_after: int, depth: int):
        super().__init__(
            f"ingest queue full ({depth} requests pending); "
            f"retry in ~{retry_after}s"
        )
        self.retry_after = retry_after
        self.depth = depth


class SchedulerClosed(Exception):
    """Submitted during shutdown: the scheduler no longer admits work."""


class WorkloadGone(Exception):
    """A config reload removed the workload while requests were queued."""

    def __init__(self, kind: str, name: str):
        super().__init__(f"workload {kind}/{name} removed by config reload")
        self.kind = kind
        self.name = name


class DatasetGone(Exception):
    """A config reload replaced the workload with one that no longer
    defines the request's dataset — the queued request was validated
    against the OLD workload, so dispatch re-checks against the
    replacement (the HTTP layer's unknown-dataset 404)."""

    def __init__(self, kind: str, name: str, dataset_id: str):
        super().__init__(
            f"dataset {dataset_id} gone from workload {kind}/{name} "
            f"after config reload"
        )
        self.kind = kind
        self.name = name
        self.dataset_id = dataset_id


class _SchedRequest:
    """One queued ingest request.

    Duck-types ``engine.workload._BatchRequest`` (dataset_id, entities,
    event, error) so ``Workload._run_merged`` completes it in place."""

    __slots__ = ("dataset_id", "entities", "event", "error", "records",
                 "enqueued", "trace_ctx")

    def __init__(self, dataset_id: str, entities, trace_ctx=None):
        self.dataset_id = dataset_id
        self.entities = entities
        # the submitting request's trace context: the dispatcher attaches
        # the head request's, so the engine's spans land in its tree
        self.trace_ctx = trace_ctx
        self.event = threading.Event()
        self.error: Optional[Exception] = None
        # one entity converts to one record; the count drives bucket fill
        # and DRR accounting without waiting for conversion
        self.records = max(1, len(entities))
        self.enqueued = time.monotonic()


# wait-time buckets: sub-window waits up to reload-stall territory
_WAIT_BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, 30.0)
# microbatch fill in records: the ladder region the coalescer targets
_FILL_BOUNDS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
                1024.0, 2048.0, 4096.0)


class _TenantQueue:
    """Per-(kind, name) bounded queue + DRR deficit + plain counters.

    Counter writes happen under the scheduler condition (submit) or from
    the single dispatcher thread; /metrics and /stats read them lock-free
    like every other single-writer engine counter."""

    __slots__ = ("kind", "name", "weight", "pending", "queued", "deficit",
                 "admitted", "rejected", "throttled", "microbatches",
                 "merged_requests", "dispatched_records", "wait_hist",
                 "fill_hist", "lock_requeues", "lock_wait_s",
                 "lock_failed_ns")

    def __init__(self, kind: str, name: str, weight: float = 1.0):
        self.kind = kind
        self.name = name
        # per-tenant DRR weight: scales the quantum this
        # queue earns per round; immutable after creation (re-resolved
        # when a reload recreates the queue)
        self.weight = weight
        # rounds where this tenant's head request exceeded its
        # accumulated deficit — it waited for later rounds' quantum
        # (delayed, never starved: the min-share floor keeps earning)
        self.throttled = 0  # guarded by: self._cv [writes]
        self.pending: Deque[_SchedRequest] = deque()  # guarded by: self._cv [writes]
        # record count mirror of ``pending``, maintained under the
        # scheduler condition — /metrics and /stats read it (and
        # len(pending)) lock-free, so they must never ITERATE the deque
        # (a concurrent append would raise "deque mutated during
        # iteration" and 500 the scrape)
        self.queued = 0  # guarded by: self._cv [writes]
        self.deficit = 0  # guarded by: self._cv [writes]
        self.admitted = 0  # guarded by: self._cv [writes]
        self.rejected = 0  # guarded by: self._cv [writes]
        self.microbatches = 0  # single-writer: dispatcher thread
        self.merged_requests = 0  # single-writer: dispatcher thread
        self.dispatched_records = 0  # single-writer: dispatcher thread
        self.wait_hist = _MonitorHist(_WAIT_BOUNDS)
        self.fill_hist = _MonitorHist(_FILL_BOUNDS)
        # the workload lock held by another thread (a feed page read, a
        # transform, a reload): microbatches requeued because the
        # non-blocking acquire failed, and the seconds from a microbatch's
        # first failed acquire to the acquire that succeeded (the
        # ``sched.lock_wait`` span); ``lock_failed_ns`` marks an open wait
        self.lock_requeues = 0  # single-writer: dispatcher thread
        self.lock_wait_s = 0.0  # single-writer: dispatcher thread
        self.lock_failed_ns: Optional[int] = None  # single-writer: dispatcher thread

    def queued_records(self) -> int:
        return self.queued


def _default_buckets() -> Tuple[int, ...]:
    """The device padding ladder (the ladder is only a shaping hint —
    host backends coalesce toward the same sizes harmlessly)."""
    from .device_matcher import query_buckets

    return query_buckets()


class IngestScheduler:
    """The per-app ingest scheduler: bounded queues, one dispatcher.

    ``resolve(kind, name)`` returns the LIVE workload for a queue key (or
    None once a reload removed it) — the scheduler never caches workload
    references across microbatches, which is the whole reload story.
    """

    def __init__(self, resolve: Callable[[str, str], object], *,
                 start: bool = True):
        self._resolve = resolve
        self._cv = threading.Condition()
        self._queues: Dict[Tuple[str, str], _TenantQueue] = {}  # guarded by: self._cv
        self._order: List[Tuple[str, str]] = []  # DRR rotation order; guarded by: self._cv
        self._rr_index = 0  # guarded by: self._cv
        self._closed = False  # guarded by: self._cv
        self._thread: Optional[threading.Thread] = None
        self.window_seconds = max(
            0.0, env_float("DUKE_SCHED_WINDOW_MS", 5.0) / 1000.0)
        self.queue_max = max(1, env_int("DUKE_SCHED_QUEUE_MAX", 256))
        self.quantum = max(1, env_int("DUKE_SCHED_QUANTUM", 4096))
        # per-tenant quota knobs: DUKE_TENANT_WEIGHT scales
        # each tenant's per-round quantum; DUKE_TENANT_MIN_SHARE is the
        # starvation-proof floor — even a zero-weighted tenant earns
        # max(1, quantum * min_share) records per round, so weights
        # shape throughput, never availability
        self.min_share = min(1.0, max(
            0.0, env_float("DUKE_TENANT_MIN_SHARE", 0.05)))
        self._weights = parse_tenant_weights()
        self._buckets = _default_buckets()
        # sec/record EWMA over dispatched microbatches (dispatcher-written,
        # admission-read): the Retry-After estimator.  Starts None — the
        # first rejections before any dispatch fall back to 1s.
        self._ewma_sec_per_record: Optional[float] = None  # guarded by: self._cv [writes]
        if start:
            self.start()

    # -- client side --------------------------------------------------------

    def submit(self, kind: str, name: str, dataset_id: str,
               entities) -> None:
        """Enqueue one ingest request and block until its microbatch
        commits.  Raises the request's own error (conversion errors stay
        per-request), :class:`SchedulerReject` when the queue is full,
        :class:`WorkloadGone` when a reload removed the workload, or
        :class:`SchedulerClosed` during shutdown."""
        req = _SchedRequest(dataset_id, entities, tracing.current_context())
        with self._cv:
            if self._closed:
                raise SchedulerClosed("scheduler is shutting down")
            key = (kind, name)
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = _TenantQueue(
                    kind, name, self._weight_for(kind, name))
                self._order.append(key)
            if len(q.pending) >= self.queue_max:
                q.rejected += 1
                raise SchedulerReject(self._retry_after_locked(q),
                                      len(q.pending))
            q.admitted += 1
            q.pending.append(req)
            q.queued += req.records
            self._cv.notify_all()
        with tracing.span("sched.queued", {
            "workload": name, "kind": kind, "records": req.records,
        }):
            req.event.wait()
        if req.error is not None:
            raise req.error

    def retry_after_hint(self, kind: str, name: str) -> int:
        """Current backlog-drain estimate in whole seconds."""
        with self._cv:
            q = self._queues.get((kind, name))
            return self._retry_after_locked(q) if q is not None else 1

    def _weight_for(self, kind: str, name: str) -> float:
        """``kind/name`` (most specific) wins over bare ``name``."""
        w = self._weights.get(f"{kind}/{name}")
        if w is None:
            w = self._weights.get(name, 1.0)
        return w

    def _quantum_for(self, q: _TenantQueue) -> int:
        """Per-round deficit grant: the weighted quantum with the
        min-share floor (a weight of 0 still drains, just last)."""
        floor = max(1, int(self.quantum * self.min_share))
        return max(floor, int(round(self.quantum * q.weight)))

    def _retry_after_locked(self, q: _TenantQueue) -> int:
        per_record = self._ewma_sec_per_record
        if per_record is None:
            return 1
        est = q.queued_records() * per_record
        if q.weight != 1.0:
            # a down-weighted tenant drains at weight * the fleet rate:
            # its 429s must say so, or a flooding tenant retries on an
            # estimate computed for capacity it no longer gets
            est /= max(q.weight, self.min_share, 1e-9)
        return retry_after_seconds(est)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._thread_main, name="ingest-scheduler", daemon=True)
        self._thread.start()

    def _thread_main(self) -> None:
        """Dispatcher entry: a crash must fail queued requests loudly,
        never leave them (and every future submit) hanging while
        admission keeps accepting."""
        try:
            self._dispatch_loop()
        except BaseException:
            logger.exception(
                "ingest dispatcher died; failing pending requests and "
                "closing admission")
            err = SchedulerClosed("ingest dispatcher died (see logs)")
            with self._cv:
                self._closed = True
                for q in self._queues.values():
                    while q.pending:
                        req = q.pending.popleft()
                        q.queued -= req.records
                        req.error = err
                        req.event.set()
                self._cv.notify_all()
            raise

    def shutdown(self, timeout: float = 60.0) -> None:
        """Stop admission, drain every queue, join the dispatcher.

        Queued requests complete normally (no lost requests); requests
        submitted after this point raise :class:`SchedulerClosed`."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():  # pragma: no cover - wedged lock
                logger.warning("scheduler drain did not finish in %ss",
                               timeout)
            self._thread = None

    # -- dispatcher ---------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                while not self._closed and not any(
                        q.pending for q in self._queues.values()):
                    self._cv.wait()
                if self._closed and not any(
                        q.pending for q in self._queues.values()):
                    return
            dispatched, next_deadline = self._run_round()
            if dispatched == 0:
                # nothing was dispatchable: every non-empty queue is
                # either inside its coalesce window (wake at the earliest
                # head deadline — or sooner, when an arrival notifies the
                # condition and may complete a bucket) or banking deficit
                # (brief yield; the next round's quantum unblocks it)
                now = time.monotonic()
                wait = (min(0.05, max(0.0, next_deadline - now))
                        if next_deadline is not None else 0.001)
                with self._cv:
                    if not self._closed:
                        self._cv.wait(timeout=wait)

    def _run_round(self):
        """One DRR round: every queue earns a quantum; queues whose
        drained total fills its padding bucket (or whose head-anchored
        coalesce window expired) dispatch a microbatch; under-filled
        queues inside their window are requeued untouched — the single
        dispatcher thread NEVER sleeps on one tenant's fill while another
        tenant has work ready.  A head larger than the accumulated
        deficit waits for later rounds (its deficit keeps growing, so it
        is delayed by rounds, never starved).  Returns ``(dispatched,
        next_deadline)`` — the microbatch count and the earliest coalesce
        deadline among the queues still waiting for fill."""
        with self._cv:
            order = list(self._order)
            start = self._rr_index % max(1, len(order))
            self._rr_index += 1
        dispatched = 0
        next_deadline: Optional[float] = None
        for key in order[start:] + order[:start]:
            with self._cv:
                q = self._queues.get(key)
                if q is None:
                    continue
                if not q.pending:
                    q.deficit = 0  # classic DRR: idle queues bank nothing
                    # age out drained queues whose workload the registry
                    # dropped — otherwise dead tenants pad every round
                    if self._resolve(q.kind, q.name) is None:
                        del self._queues[key]
                        self._order.remove(key)
                    continue
                q.deficit += self._quantum_for(q)
            batch, deadline = self._collect(q)
            if batch:
                if self._dispatch(q, batch):
                    dispatched += 1
                    with self._cv:
                        if not q.pending:
                            q.deficit = 0
                else:
                    # lock contention requeued the batch: back off like a
                    # coalesce deadline instead of re-polling at the idle
                    # loop's 1 ms tick for the whole hold (a reload can
                    # hold workload locks for minutes)
                    deadline = time.monotonic() + 0.05
            if (deadline is not None
                    and (next_deadline is None or deadline < next_deadline)):
                next_deadline = deadline
        return dispatched, next_deadline

    def _collect(self, q: _TenantQueue):
        """Pop a microbatch from ``q``: up to its DRR deficit, coalescing
        toward the padding-bucket boundary.  Never blocks: an under-filled
        batch whose head-anchored window has not expired is requeued
        intact and ``(None, deadline)`` returned — the dispatch loop
        sleeps until the earliest such deadline (or an arrival), so no
        request waits more than one window for a fuller launch and no
        tenant's window ever stalls another tenant's dispatch."""
        batch: List[_SchedRequest] = []
        total = 0
        ladder_max = self._buckets[-1]
        with self._cv:
            while q.pending:
                head = q.pending[0]
                if batch and (total + head.records > q.deficit
                              or total >= ladder_max):
                    break
                if not batch and head.records > q.deficit:
                    # earns more deficit next round; the counter is the
                    # quota-throttle signal (duke_tenant_throttled_total)
                    q.throttled += 1
                    return None, None
                q.pending.popleft()
                q.queued -= head.records
                batch.append(head)
                total += head.records
            if not batch:
                return None, None
            # coalesce window: when the drained total under-fills its
            # padding bucket, hold the batch for more arrivals.  The
            # target anchors on the FIRST drain's boundary — arrivals
            # that overshoot it dispatch immediately instead of
            # escalating the wait toward the next rung.
            target = self._bucket_for(total)
            deadline = batch[0].enqueued + self.window_seconds
            if (total < target and total < q.deficit
                    and not self._closed  # drain ignores windows
                    and time.monotonic() < deadline):
                q.pending.extendleft(reversed(batch))
                q.queued += total
                return None, deadline
            # DRR: consumed quantum leaves the deficit (idle queues are
            # zeroed by the round loop)
            q.deficit -= total
        return batch, None

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _dispatch(self, q: _TenantQueue, batch: List[_SchedRequest]) -> bool:
        """Run one microbatch under the live workload's lock.  Returns
        False when the lock was unavailable and the batch was requeued —
        the ONLY dispatcher thread must not block on one workload's long
        hold (a transform, a reload, a wedged writer) while other
        tenants' locks are free; the round loop retries on later rounds
        (the requests' expired windows make the retry dispatch-ready)."""
        try:
            while True:
                wl = self._resolve(q.kind, q.name)
                if wl is None:
                    err = WorkloadGone(q.kind, q.name)
                    for req in batch:
                        req.error = err
                        req.event.set()
                    with self._cv:  # age the dead tenant's queue out too
                        if not q.pending and (q.kind, q.name) in self._queues:
                            del self._queues[(q.kind, q.name)]
                            self._order.remove((q.kind, q.name))
                    return True
                # re-validate datasets against the (possibly reloaded)
                # workload: admission validated against the OLD one, and
                # _run_merged would surface a missing dataset as a bare
                # KeyError (a 500) instead of the unknown-dataset 404
                live: List[_SchedRequest] = []
                for req in batch:
                    if req.dataset_id not in wl.datasources:
                        req.error = DatasetGone(q.kind, q.name,
                                                req.dataset_id)
                        req.event.set()
                    else:
                        live.append(req)
                batch = live
                if not batch:
                    return True
                total = sum(r.records for r in batch)
                if not wl.lock.acquire(blocking=False):
                    q.lock_requeues += 1
                    if q.lock_failed_ns is None:
                        q.lock_failed_ns = time.monotonic_ns()
                    with self._cv:
                        q.pending.extendleft(reversed(batch))
                        q.queued += total
                        q.deficit += total  # restore the consumed quantum
                    return False
                acquired_ns = time.monotonic_ns()
                try:
                    if wl.closed:
                        continue  # reload swapped it: re-resolve
                    t0 = time.monotonic()
                    for req in batch:
                        q.wait_hist.observe(t0 - req.enqueued)
                    # engine spans land in the HEAD request's trace; the
                    # merged siblings' trace ids ride as an attribute so
                    # a tail-latched slow microbatch still names every
                    # constituent (their own traces show the queue wait)
                    ctx = batch[0].trace_ctx
                    attach = (tracing.attach(ctx) if ctx is not None
                              else contextlib.nullcontext())
                    merged_ids = [
                        r.trace_ctx[0].trace_id for r in batch[:8]
                        if r.trace_ctx is not None
                    ]
                    failed_ns, q.lock_failed_ns = q.lock_failed_ns, None
                    with attach:
                        if failed_ns is not None:
                            q.lock_wait_s += (acquired_ns - failed_ns) / 1e9
                            tracing.add_span("sched.lock_wait", failed_ns,
                                             acquired_ns, {
                                                 "workload": q.name,
                                                 "kind": q.kind})
                        with tracing.span("sched.microbatch", {
                            "workload": q.name, "kind": q.kind,
                            "requests": len(batch), "records": total,
                            "bucket": self._bucket_for(total),
                            "merged_trace_ids": ",".join(merged_ids),
                        }):
                            wl._run_merged(list(batch))
                    hold = time.monotonic() - t0
                    wl.note_lock_hold(hold)
                finally:
                    wl.lock.release()
                # always-on SLO signal: per-request ingest latency from
                # SCHEDULER ARRIVAL to microbatch completion -- the
                # queueing delay included -- folded under ONE leaf tracker
                # lock per microbatch, taken with no other lock held; the
                # feed-lag meter marks the rows this batch may have minted
                # (plain attribute write).
                done = time.monotonic()
                slo.tracker("ingest", q.kind, q.name).record_batch(
                    [done - req.enqueued for req in batch], done,
                    # exemplar trace ids for violation entries: only
                    # sampled traces link anywhere, so unsampled -> None
                    [(req.trace_ctx[0].trace_id
                      if req.trace_ctx is not None
                      and req.trace_ctx[0].sampled else None)
                     for req in batch])
                slo.feed_meter(q.kind, q.name).note_write()
                q.microbatches += 1
                q.merged_requests += len(batch)
                q.dispatched_records += total
                q.fill_hist.observe(float(total))
                # once per microbatch, and admission reads the estimator
                # under _cv — fold under the same lock so a Retry-After
                # computed mid-fold can never mix old/new EWMA state
                with self._cv:
                    self._ewma_sec_per_record = fold_ewma(
                        self._ewma_sec_per_record, hold / max(1, total))
                return True
        except Exception as e:  # never lose a request on dispatcher errors
            logger.exception("microbatch dispatch failed for %s/%s",
                             q.kind, q.name)
            for req in batch:
                if not req.event.is_set():
                    req.error = e
                    req.event.set()
            return True

    # -- observability ------------------------------------------------------

    def queues(self) -> List[_TenantQueue]:
        """Stable snapshot of the tenant queues for scrape-time walkers."""
        with self._cv:
            return list(self._queues.values())

    def stats_snapshot(self) -> dict:
        """The /stats scheduler block."""
        out = {
            "window_ms": round(self.window_seconds * 1000.0, 3),
            "queue_max": self.queue_max,
            "quantum_records": self.quantum,
            "min_share": self.min_share,
            "sec_per_record_ewma": (
                round(self._ewma_sec_per_record, 9)
                if self._ewma_sec_per_record is not None else None
            ),
            "workloads": [],
        }
        for q in self.queues():
            waits = q.wait_hist
            out["workloads"].append({
                "kind": q.kind,
                "name": q.name,
                "weight": q.weight,
                "depth": len(q.pending),
                "queued_records": q.queued_records(),
                "admitted": q.admitted,
                "rejected": q.rejected,
                "throttled": q.throttled,
                "microbatches": q.microbatches,
                "merged_requests": q.merged_requests,
                "records_dispatched": q.dispatched_records,
                "avg_wait_ms": (
                    round(waits.total / waits.count * 1000.0, 3)
                    if waits.count else None
                ),
                "retry_after_hint": self.retry_after_hint(q.kind, q.name),
            })
        return out
