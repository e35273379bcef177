"""Write-behind persistence: generic buffer + the link-database wrapper
(a copy of the JAX package's ``links/write_behind.py``).

``WriteBehindLinkDatabase`` buffers writes in arrival order and flushes
them on a single background thread (one ``assert_links`` transaction +
``commit`` per batch), so the durable flush overlaps the next batch's
scoring instead of extending the persist phase.

Consistency contract (the link wrapper):

  * **Ordering** -- writes apply in arrival order; ``commit()`` seals the
    current buffer as one batch and enqueues it (non-blocking).
  * **Durability** -- with a ``LinkJournal`` attached (the default for
    sqlite-backed workloads, ``DUKE_JOURNAL``), sealing a batch appends
    it to the append-only journal -- rows + monotonic batch seq + CRC,
    synced per ``DUKE_JOURNAL_SYNC`` -- BEFORE ``commit()`` returns, i.e.
    before the HTTP ack.  The background flusher is then a redo-log
    applier: it advances the journal's applied watermark after each
    durable store commit, and startup ``recover()`` replays any journaled
    batch a crash stranded through the idempotent ``assert_links`` path.
    Without a journal an acked batch lives only in this buffer until the
    flush lands (in-memory link-DB semantics for that window).
  * **Drain barrier** -- every row-returning read (feed, the one-to-one
    flush's batched link fetch, delete-retraction lookups) drains
    buffered and in-flight writes first, so a reader can never observe a
    torn batch.  ``close()`` and the workload's corpus-snapshot save
    drain too.  ``count()`` alone is non-draining.
  * **Failure** -- a background flush failure is retried per batch
    (``DUKE_FLUSH_RETRIES``, default 3, capped exponential backoff with
    full jitter) before latching the wrapper: transient disk errors heal
    in place, while a persistent error latches and every subsequent
    write/commit/drain raises the latched error, so ingest cannot
    silently run ahead of a dead link store.  With the journal, the
    latched batches replay at the next start.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

from .. import telemetry
from ..env import env_int
from ..telemetry import tracing
from ..utils import faults
from ..utils.backoff import full_jitter_delay
from .base import Link, LinkDatabase, LinkKind, LinkStatus
from .journal import LinkJournal

logger = logging.getLogger("links-write-behind")

# one link on the wire and in the journal: a plain tuple (a copy of the
# JAX package's ``links.replica.encode_link`` / ``decode_link``)
LinkRow = Tuple[str, str, str, str, float, int]


def encode_link(link: Link) -> LinkRow:
    return (link.id1, link.id2, link.status.value, link.kind.value,
            link.confidence, link.timestamp)


def decode_link(row: Sequence) -> Link:
    id1, id2, status, kind, confidence, timestamp = row
    return Link(id1, id2, LinkStatus(status), LinkKind(kind), confidence,
                timestamp=timestamp)

# flush-retry backoff shape (transient disk errors must not poison the
# wrapper until restart); the retry COUNT is the env knob, the shape is
# policy
_RETRY_BASE_S = 0.05
_RETRY_CAP_S = 2.0


def _flush_retries() -> int:
    """Per-batch transient-failure retries before the latch (resolved at
    failure time so tests and operators can flip it on a live process —
    the failure path is rare, the env read is not hot)."""
    return max(0, env_int("DUKE_FLUSH_RETRIES", 3))


class WriteBehindBuffer:
    """Generic arrival-order write-behind core.

    Items accumulate in an open buffer; ``commit()`` seals the buffer as
    one batch and enqueues it for the background flusher, which hands
    each batch to ``flush`` (one call per batch -- the transaction
    boundary).  ``drain()`` is the read barrier; a flush failure latches
    the buffer (every later ``add``/``commit``/``drain`` raises).

    ``max_pending`` bounds the sealed-batch queue.  Past it, ``commit()``
    either blocks (backpressure -- the link-database stance: a slow disk
    must throttle ingest, not grow memory) or, with
    ``drop_on_overflow=True``, discards the oldest pending batch and
    counts it in ``dropped`` (the audit-log stance: observability output
    must never block scoring).
    """

    def __init__(self, flush: Callable[[List], None], *,
                 max_pending: int = 4, drop_on_overflow: bool = False,
                 name: str = "write-behind",
                 seal: Optional[Callable] = None,
                 retries: Optional[Callable[[], int]] = None):
        self._flush = flush
        # optional batch-sealing hook, called under self._cv the moment
        # commit() closes a batch and BEFORE it is enqueued -- the link
        # wrapper journals the batch here, so the durability point
        # precedes both the ack and the background flush.  May transform
        # the batch (the flusher receives its return value); raising
        # restores the items to the open buffer and propagates to the
        # committer (no durability -> no ack).
        self._seal = seal
        # transient-flush-failure retries before the latch (callable so
        # the env knob is read at failure time); None = never retry
        self._retries = retries
        self._max_pending = max(1, max_pending)
        self._drop_on_overflow = drop_on_overflow
        self._name = name
        self._cv = threading.Condition()
        self._buf: List = []  # guarded by: self._cv
        self._queue: deque = deque()  # guarded by: self._cv
        self._inflight = False  # guarded by: self._cv
        self._error: Optional[BaseException] = None  # guarded by: self._cv [writes]
        self._closed = False  # guarded by: self._cv
        self._thread: Optional[threading.Thread] = None  # guarded by: self._cv
        # batches discarded by the overflow policy; read lock-free by stats
        self.dropped = 0  # guarded by: self._cv [writes]

    # -- worker --------------------------------------------------------------

    def _ensure_thread(self) -> None:
        # called with self._cv held
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, daemon=True, name=self._name
            )
            self._thread.start()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:
                    return  # closed and drained
                batch = self._queue.popleft()
                self._inflight = True
            error = self._flush_with_retries(batch)
            if error is not None:  # latch: readers/writers must see it
                with self._cv:
                    self._error = error
                    self._inflight = False
                    self._queue.clear()
                    self._cv.notify_all()
                return
            with self._cv:
                self._inflight = False
                self._cv.notify_all()

    def _flush_with_retries(self, batch) -> Optional[BaseException]:
        """One batch through ``flush``, retried with capped-exponential
        full-jitter backoff for transient failures (each attempt re-runs
        the WHOLE batch -- the one-transaction/idempotent-assert contract
        makes that safe).  Returns the terminal error, or None."""
        attempt = 0
        while True:
            try:
                self._flush(batch)
                return None
            except BaseException as e:
                limit = self._retries() if self._retries is not None else 0
                if attempt >= limit:
                    logger.exception(
                        "%s flush failed terminally (%d attempt(s))",
                        self._name, attempt + 1,
                    )
                    return e
                attempt += 1
                delay = full_jitter_delay(attempt, _RETRY_BASE_S,
                                          _RETRY_CAP_S)
                logger.warning(
                    "%s flush failed (attempt %d/%d; retrying in "
                    "%.3f s): %r", self._name, attempt, limit, delay, e,
                )
                time.sleep(delay)

    def _raise_latched(self) -> None:
        # called with self._cv held
        if self._error is not None:
            raise RuntimeError(
                f"{self._name} flush failed; the backing store is stale"
            ) from self._error

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    # -- writes (buffered, arrival order) ------------------------------------

    def add(self, item) -> None:
        with self._cv:
            self._raise_latched()
            self._buf.append(item)

    def add_many(self, items: Sequence) -> None:
        with self._cv:
            self._raise_latched()
            self._buf.extend(items)

    def commit(self) -> None:
        """Seal the buffered writes as one batch and enqueue the flush;
        returns immediately unless the flusher is ``max_pending`` batches
        behind (then it blocks -- or drops the oldest pending batch under
        ``drop_on_overflow``)."""
        with self._cv:
            self._raise_latched()
            if not self._buf:
                return
            while len(self._queue) >= self._max_pending:
                if self._drop_on_overflow:
                    self._queue.popleft()
                    self.dropped += 1
                    continue
                self._cv.wait()
                self._raise_latched()
            batch, self._buf = self._buf, []
            if self._seal is not None:
                try:
                    batch = self._seal(batch)
                except BaseException:
                    # the durability point failed (journal append/sync):
                    # put the items back so nothing is silently dropped,
                    # and surface the error to the committer -- an
                    # unjournaled batch must never be acked
                    self._buf = batch + self._buf
                    raise
            self._queue.append(batch)
            self._ensure_thread()
            self._cv.notify_all()

    def drain(self) -> None:
        """Block until every buffered and queued write is durably applied
        (the read barrier; re-raises a latched flush failure)."""
        self.commit()
        with self._cv:
            while (self._queue or self._inflight) and self._error is None:
                self._cv.wait()
            self._raise_latched()

    def latch(self, error: BaseException) -> None:
        """Latch ``error`` from outside the flusher (the overlapped
        recovery thread): every later add/commit/drain raises,
        exactly as a terminal flush failure would -- a wrapper whose
        startup replay failed must never silently serve writes over a
        store missing acked batches."""
        with self._cv:
            if self._error is None:
                self._error = error
            self._cv.notify_all()

    def close(self) -> None:
        """Drain (best-effort past a latched failure) and stop the
        flusher thread.  Does NOT close whatever ``flush`` writes to —
        that remains the embedder's resource."""
        try:
            self.drain()
        except RuntimeError:
            pass  # latched failure: nothing left to save
        except Exception:
            # a seal failure (journal device error) surfacing through
            # the drain's commit: the batch stays in the open buffer and
            # is lost with the process, but shutdown must still stop the
            # thread and let the embedder close its resources
            logger.exception("%s: drain failed during close", self._name)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=10.0)


class WriteBehindLinkDatabase(LinkDatabase):
    # backpressure: at most this many sealed batches may be pending
    # behind the flusher; commit() blocks past it, so a slow disk turns
    # into ingest backpressure instead of unbounded queue growth -- and
    # every drain barrier (reads, scrapes) is bounded by a handful of
    # flush transactions rather than an arbitrary backlog
    _MAX_PENDING = 4

    def __init__(self, inner: LinkDatabase,
                 journal: Optional[LinkJournal] = None):
        self.inner = inner
        # durable redo log: sealed batches append here before the ack;
        # None keeps the volatile-ack window (DUKE_JOURNAL=0)
        self.journal = journal
        self._wb = WriteBehindBuffer(
            self._flush_batch, max_pending=self._MAX_PENDING,
            name="link write-behind", seal=self._seal_batch,
            retries=_flush_retries,
        )
        # recovery-overlap fence: set = no startup replay in
        # flight.  Writes (and the ingest-path reads that FEED writes)
        # wait on it; feed/monitoring reads deliberately do not -- they
        # serve the replay's committed prefix behind the X-Recovering
        # staleness header.
        self._recovered = threading.Event()
        self._recovered.set()
        self._recovery_thread: Optional[threading.Thread] = None
        # journaled batches replayed by recover() (the startup redo)
        self.replayed = 0
        # seconds of the durable commit: the journal append plus its sync
        # on the committing thread, before the ack (``links.journal``
        # spans), and the store applies on the flusher thread, one
        # ``links.flush`` trace each; each clock has one writer
        self.journal_seconds = 0.0
        self.flush_seconds = 0.0

    def _seal_batch(self, links: List[Link]):
        """Batch-sealing hook (runs inside ``commit()``): journal the
        batch durably and stamp it with its redo sequence.  THE
        durability point -- everything after (enqueue, flush, ack) may
        crash and the batch still replays."""
        seq = None
        if self.journal is not None:
            rows = [encode_link(link) for link in links]
            t0 = time.monotonic()
            before = self.journal.appended_bytes
            try:
                with tracing.span("links.journal", {
                        "links": len(rows),
                        "sync": self.journal.sync_policy}) as sp:
                    seq = self.journal.append_batch(rows)
                    if sp is not None:
                        sp.set_attribute(
                            "bytes", self.journal.appended_bytes - before)
            finally:
                self.journal_seconds += time.monotonic() - t0
            faults.check_crash("post_journal_append")
        return (seq, links)

    def _flush_batch(self, sealed) -> None:
        seq, links = sealed
        t0 = time.monotonic()
        # the flusher thread's own root trace, like a prober cycle
        try:
            with tracing.start_trace("links.flush", attributes={
                    "links": len(links), "seq": seq}):
                plan = faults.active()
                if plan is not None:
                    plan.check_crash("pre_flush")
                    # chaos hook (DUKE_FAULTS flush_fail): a raised
                    # injection takes the retry ladder and then the latch
                    # exactly like a real disk failure
                    plan.check_flush("link write-behind")
                self.inner.assert_links(links)
                if plan is not None:
                    plan.check_crash("mid_flush")
                self.inner.commit()
                if plan is not None:
                    plan.check_crash("post_flush_pre_truncate")
                if self.journal is not None and seq is not None:
                    self.journal.mark_applied(seq)
        finally:
            self.flush_seconds += time.monotonic() - t0

    def recover(self) -> int:
        """Replay journaled-but-unapplied batches into the durable store
        (startup only, before any concurrent use): the redo half of the
        crash-consistency contract.  Replays ride the same idempotent
        ``assert_links`` the flusher uses -- an identical re-assert is a
        no-op, so a batch that WAS applied (crash before its watermark
        marker) converges instead of double-writing, and the feed sees
        no spurious timestamp bumps.  Returns the batch count replayed
        (also added to ``self.replayed``)."""
        if self.journal is None:
            return 0
        batches = self.journal.unapplied()
        # replay in arrival order, coalesced into bounded transactions:
        # assert_links applies a concatenated run of batches identically
        # to applying them one by one (each key's final effective state
        # wins either way), and one watermark marker per chunk covers
        # every batch at or below it -- a 10k-batch backlog replays in a
        # few dozen transactions instead of 10k commits
        chunk_size = 256
        # progress gauges: while /readyz still says `recovering`,
        # remaining counts down per chunk so an operator can tell "almost
        # done" from "wedged".  inc/dec (not set) so concurrent
        # per-workload overlapped recoveries sum correctly.
        telemetry.RECOVERY_REPLAY_REMAINING.inc(len(batches))
        for start in range(0, len(batches), chunk_size):
            chunk = batches[start:start + chunk_size]
            self.inner.assert_links(
                [decode_link(r) for _, rows in chunk for r in rows])
            self.inner.commit()
            self.journal.mark_applied(chunk[-1][0])
            telemetry.RECOVERY_REPLAY_APPLIED.inc(len(chunk))
            telemetry.RECOVERY_REPLAY_REMAINING.dec(len(chunk))
        self.journal.compact()
        if batches:
            self.replayed += len(batches)
            telemetry.RECOVERY_REPLAYED.inc(len(batches))
            logger.warning(
                "recovered %d journaled link batch(es) the previous "
                "process never applied (crash between ack and flush)",
                len(batches),
            )
        return len(batches)

    def recover_async(self, scope: str = "") -> int:
        """Overlapped startup recovery: replay journaled-but-
        unapplied batches on a background thread while feed/monitoring
        reads serve the growing committed prefix.  Returns immediately
        with 0 when there is a backlog (the thread owns the count), or
        runs the (cheap) recovery inline when there is nothing to
        replay.

        Safety argument, in one place:

          * **Writes fence** -- ``assert_link``/``assert_links``/
            ``commit`` (and the ingest-path reads below) block until
            replay completes, so no new batch can interleave with -- or
            be journaled behind, yet applied before -- the replayed
            backlog; arrival order is preserved exactly as serial
            recovery preserves it.
          * **Reads see a monotonic prefix** -- replay applies whole
            batches in arrival order inside chunked transactions on its
            own sqlite connection, so a concurrent feed read observes
            complete batches only, each page extending the last (no
            torn batch, no duplicate -- the idempotent assert skips
            identical re-asserts without a timestamp bump).
          * **Ingest-path reads fence too** -- ``get_all_links_for`` /
            ``get_links_for_ids`` / ``get_all_links`` feed retraction
            and one-to-one decisions; a prefix read there could miss a
            link the replay was about to restore, so they wait exactly
            like writes.  The feed/monitoring reads
            (``get_changes_since``/``get_changes_page``/``count``)
            stay overlap-served.
          * **Failure latches** -- a replay error latches the buffer
            (``WriteBehindBuffer.latch``), so the fence lifting can
            never silently serve writes over a store missing acked
            batches.

        The recovery scope is marked on THIS thread before returning,
        so no response can observe the wrapper serving with
        the replay thread not yet started."""
        from . import journal as journal_mod

        if self.journal is None or self.journal.pending_batches == 0:
            return self.recover()
        self._recovered.clear()
        journal_mod.recovery_begin(scope)
        t = threading.Thread(
            target=self._recover_overlapped, args=(scope,), daemon=True,
            name="link-recovery",
        )
        self._recovery_thread = t
        t.start()
        return 0

    def _recover_overlapped(self, scope: str) -> None:
        from . import journal as journal_mod

        try:
            self.recover()
        except BaseException as e:
            logger.exception(
                "overlapped journal recovery failed; latching the "
                "wrapper (writes refused until restart)")
            self._wb.latch(e)
        finally:
            journal_mod.recovery_end(scope)
            self._recovered.set()

    @property
    def recovering(self) -> bool:
        """True while an overlapped startup replay is in flight (the
        write fence is up; reads serve the committed prefix)."""
        return not self._recovered.is_set()

    def _await_recovery(self) -> None:
        # the write fence: bounded by the replay duration (finite), and
        # a replay failure sets the event after latching, so waiters
        # surface the latched error instead of hanging
        if not self._recovered.is_set():
            self._recovered.wait()

    @property
    def flush_error(self) -> Optional[BaseException]:
        """The latched background-flush failure, or None (read lock-free
        by health probes: a dead persistence thread must be visible to
        orchestrators without waiting for a read to drain into it)."""
        return self._wb.error

    # -- writes (buffered, arrival order; fenced during recovery) ------------

    def assert_link(self, link: Link) -> None:
        self._await_recovery()
        self._wb.add(link)

    def assert_links(self, links: List[Link]) -> None:
        self._await_recovery()
        self._wb.add_many(links)

    def commit(self) -> None:
        self._await_recovery()
        self._wb.commit()

    def drain(self) -> None:
        with tracing.span("links.drain"):
            self._wb.drain()

    # -- reads (drain first; the ingest-path reads fence during recovery
    # because their results feed writes -- see recover_async) -----------------

    def get_all_links_for(self, record_id: str) -> List[Link]:
        self._await_recovery()
        self.drain()
        return self.inner.get_all_links_for(record_id)

    def get_links_for_ids(self, record_ids) -> List[Link]:
        self._await_recovery()
        self.drain()
        return self.inner.get_links_for_ids(record_ids)

    def get_all_links(self) -> List[Link]:
        self._await_recovery()
        self.drain()
        return self.inner.get_all_links()

    def count(self) -> int:
        # deliberately NOT drained: count feeds /metrics and /stats
        # gauges, and a scrape must neither block on in-flight flush
        # transactions nor seal another thread's in-progress batch buffer
        # into a separate transaction.  The value trails the buffered
        # writes by at most a batch or two (exact again after any drain
        # point); every row-returning read keeps the full barrier.
        return self.inner.count()

    def get_changes_since(self, since: int) -> List[Link]:
        self.drain()
        return self.inner.get_changes_since(since)

    def get_changes_page(self, since: int, limit: int) -> List[Link]:
        self.drain()
        return self.inner.get_changes_page(since, limit)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        try:
            # an in-flight overlapped replay finishes first: interrupting
            # it is crash-safe (the journal keeps the backlog for the
            # next start) but a graceful shutdown should leave the store
            # caught up and the journal compacted
            self._await_recovery()
            self._wb.close()
        finally:
            # journal and inner store close even if the drain blew up —
            # fd/connection leaks on a failing shutdown would compound
            # the original failure.  A drained close leaves an EMPTY
            # journal (compacted when the watermark caught the head) —
            # the graceful-shutdown contract: nothing to replay next
            # start.
            if self.journal is not None:
                self.journal.close()
            self.inner.close()
