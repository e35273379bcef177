"""Match-event listeners.

Reproduces the reference's listener chain: Duke's ``MatchListener`` event
protocol (startProcessing/batchReady/matches/matchesPerhaps/noMatchFor/
batchDone/endProcessing — BaseLinkDatabaseMatchListener.java:53-109), the
link-database-forwarding listener, and the service listener that additionally
accumulates per-entity matches for http-transform responses
(BaseLinkDatabaseMatchListener.java:44-46,84-88,115-136) and can be switched
off while a transform runs (lines 111-113).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

from ..core.records import (
    DATASET_ID_PROPERTY_NAME,
    ORIGINAL_ENTITY_ID_PROPERTY_NAME,
    Record,
    record_digest,
)
from ..links.base import Link, LinkDatabase, LinkKind, LinkStatus
from ..telemetry.decisions import audit_log, explanation_digest


class MatchListener:
    def start_processing(self) -> None: ...
    def batch_ready(self, size: int) -> None: ...
    def matches(self, r1: Record, r2: Record, confidence: float) -> None: ...
    def matches_perhaps(self, r1: Record, r2: Record, confidence: float) -> None: ...
    def no_match_for(self, record: Record) -> None: ...
    def batch_done(self) -> None: ...
    def end_processing(self) -> None: ...


class LinkMatchListener(MatchListener):
    """Duke's LinkDatabaseMatchListener: persist match events as links.

    With ``batch=True`` (the default) the batch's links are collected and
    handed to the database as ONE ``assert_links`` call at ``batch_done``
    — a single transaction on the durable backend instead of a
    query+commit per link, which dominated the persist phase on
    match-heavy batches.  Timestamps are assigned at event time (Link
    construction), so the deferred write is invisible to ``?since=``
    pollers.  ``batch=False`` preserves the legacy per-event write for
    embedders that read the database mid-batch.

    When ``DUKE_AUDIT_LOG`` is set, every confirmed link decision that
    reaches this listener (post one-to-one resolution — only links that
    are actually asserted) also appends an audit entry carrying the two
    records' content digests and the explanation digest that a later
    ``POST /explain`` replay of the same pair reproduces
    (telemetry.decisions).  The audit file flushes write-behind at
    ``batch_done``; it can never block scoring.
    """

    def __init__(self, linkdb: LinkDatabase, batch: bool = True,
                 audit_context: Optional[Tuple[str, str]] = None):
        self.linkdb = linkdb
        self.batch = batch
        self._pending: List[Link] = []
        # (kind, workload-name) stamped into audit rows
        self._audit_context = audit_context or ("", "")
        self._audit = None

    def batch_ready(self, size: int) -> None:
        # a batch that aborted mid-scoring must not leak its buffered
        # links into the next batch's flush transaction
        self._pending = []
        # re-resolved per batch so env changes (tests, ops toggles) take
        # effect without a workload rebuild
        self._audit = audit_log()

    def _assert(self, link: Link) -> None:
        if self.batch:
            self._pending.append(link)
        else:
            self.linkdb.assert_link(link)

    def _audit_entry(self, r1: Record, r2: Record, confidence: float,
                     kind: str) -> None:
        if self._audit is None:
            return
        d1, d2 = record_digest(r1), record_digest(r2)
        self._audit.append({
            "time_unix": round(time.time(), 3),
            "kind": self._audit_context[0],
            "workload": self._audit_context[1],
            "id1": r1.record_id,
            "id2": r2.record_id,
            "link_kind": kind,
            "confidence": confidence,
            "record_digest1": d1.hex(),
            "record_digest2": d2.hex(),
            "explanation_digest": explanation_digest(d1, d2, confidence),
        })

    def matches(self, r1: Record, r2: Record, confidence: float) -> None:
        self._assert(
            Link(r1.record_id, r2.record_id, LinkStatus.INFERRED,
                 LinkKind.DUPLICATE, confidence)
        )
        self._audit_entry(r1, r2, confidence, "duplicate")

    def matches_perhaps(self, r1: Record, r2: Record, confidence: float) -> None:
        self._assert(
            Link(r1.record_id, r2.record_id, LinkStatus.INFERRED,
                 LinkKind.MAYBE, confidence)
        )
        self._audit_entry(r1, r2, confidence, "maybe")

    def flush_pending(self) -> None:
        """Hand the collected links to the database now (one batched
        call), without ending the batch.  The one-to-one flush calls this
        before its conflict prefetch so this batch's pass-through
        maybe-link upserts are visible to the prefetched link state,
        exactly as the legacy per-event writes were."""
        pending, self._pending = self._pending, []
        if pending:
            self.linkdb.assert_links(pending)

    def batch_done(self) -> None:
        self.flush_pending()
        self.linkdb.commit()
        if self._audit is not None:
            # seal the batch's audit entries for the background flusher
            # (write-behind: the persist phase never waits on the file)
            self._audit.flush()


class ServiceMatchListener(MatchListener):
    """The workload listener: forwards to the link DB (unless disabled for
    http-transform) and accumulates per-entity matches for the transform
    response (``duke_links``)."""

    def __init__(self, workload_name: str, linkdb: LinkDatabase,
                 kind: str = "deduplication", one_to_one: bool = False,
                 record_resolver=None):
        self._wrapped = LinkMatchListener(
            linkdb, audit_context=(kind, workload_name))
        self.link_database_updates_disabled = False
        self._entity_matches: Dict[str, List[Tuple[Record, float]]] = {}
        # one-to-one enforcement (opt-in): the reference parses
        # link-mode="one-to-one" but never reads the flag (SURVEY.md quirk
        # Q5), so by default every above-threshold pair links.  With
        # ``one_to_one`` definite matches are buffered per batch and
        # resolved by descending confidence with displacement repair (see
        # _flush_one_to_one) so each record links to at most one
        # counterpart; maybe-matches pass through.
        self.one_to_one = one_to_one
        self._pending_matches: List[Tuple[float, Record, Record]] = []
        # runner-up pairs kept across recent batches so a record displaced
        # by a stronger later link can fall back to its next-best candidate
        # (deferred-acceptance repair); capped per record and pruned by
        # batch age.  Entries carry the batch number they were seen in;
        # ``record_resolver`` (id -> live Record or None, wired to the
        # index by the workload) re-validates both endpoints at replay so
        # deleted/re-indexed records are never resurrected from stale pairs.
        self._alternatives: Dict[str, List[Tuple[float, Record, Record]]] = {}
        self._alt_batch: Dict[str, int] = {}
        self._batch_no = 0
        self._record_resolver = record_resolver
        self._maybe_seen: set = set()
        prefix = (
            "recordLinkageMatchListener" if kind == "recordlinkage"
            else "deduplicationMatchListener"
        )
        self.logger = logging.getLogger(f"{prefix}-{workload_name}")
        self._batch_start: Optional[float] = None

    def set_link_database_updates_disabled(self, disabled: bool) -> None:
        self.link_database_updates_disabled = disabled

    def batch_ready(self, size: int) -> None:
        self._entity_matches = {}
        self._pending_matches = []
        self._maybe_seen = set()
        self._batch_start = time.monotonic()
        self.logger.info("batchReady(size=%d)", size)
        if not self.link_database_updates_disabled:
            self._wrapped.batch_ready(size)

    def batch_done(self) -> None:
        if self.one_to_one:
            if not self.link_database_updates_disabled:
                # maybe-matches passed straight through during scoring and
                # sit in the wrapped listener's batch buffer; hand them to
                # the DB before the flush's conflict prefetch reads link
                # state, matching the legacy immediate-write visibility
                self._wrapped.flush_pending()
            self._flush_one_to_one()
        if not self.link_database_updates_disabled:
            self._wrapped.batch_done()
        if self._batch_start is not None:
            self.logger.info(
                "batchDone() batchElapsedTime: %s seconds.",
                time.monotonic() - self._batch_start,
            )

    # runner-up pairs remembered per record for displacement repair, and
    # how many batches they stay replayable (bounds both memory and the
    # staleness of a replayed pair's confidence)
    _ALTERNATIVE_CAP = 8
    _ALTERNATIVE_MAX_AGE = 32

    def _flush_one_to_one(self) -> None:
        """Max-confidence one-to-one assignment with displacement repair.

        Pairs are resolved in descending confidence order — within the
        batch AND against links asserted by earlier batches (one batched
        link fetch; a stronger new pair retracts the weaker existing link,
        a weaker one is suppressed).  When an existing link is retracted,
        its displaced endpoint re-enters the queue with its remembered
        runner-up candidates (deferred-acceptance style), so displacement
        chains settle instead of stranding records.  Ties break on record
        ids so the output is deterministic under threaded scoring.

        Event-protocol note: a record whose every buffered definite match
        is suppressed here gets an explicit ``no_match_for`` at the end of
        the flush (unless it produced a maybe-match), keeping the listener
        contract's "every processed record emits some event" property.
        """
        import heapq

        pending = self._pending_matches
        self._pending_matches = []
        batch_queries: Dict[str, Record] = {
            t[1].record_id: t[1] for t in pending
        }

        transform = self.link_database_updates_disabled
        self._batch_no += 1
        if self._batch_no % self._ALTERNATIVE_MAX_AGE == 0:
            self._prune_alternatives()
        links_by_id: Dict[str, List[Link]] = {}
        # ids whose links are COMPLETE in links_by_id (the batched fetch
        # also surfaces links of out-of-batch endpoints — those entries are
        # partial and must not suppress the lazy per-record fetch)
        fetched: set = set()
        if not transform and pending:
            ids = {t[1].record_id for t in pending} | {
                t[2].record_id for t in pending
            }
            # seed every id so unlinked records (the steady-state common
            # case) don't fall through to per-record lazy DB lookups
            links_by_id = {rid: [] for rid in ids}
            fetched = set(ids)
            for link in self._wrapped.linkdb.get_links_for_ids(ids):
                links_by_id.setdefault(link.id1, []).append(link)
                links_by_id.setdefault(link.id2, []).append(link)

        # heap orders by (-confidence, ids, tie-counter); the counter makes
        # every entry totally ordered BEFORE comparison could reach the
        # Record payloads (Record has __eq__ but no __lt__ — a tie on the
        # string keys would otherwise raise TypeError); seen_pairs guards
        # against the same pair re-entering via both endpoints' alternative
        # lists
        tie = iter(range(1 << 62))
        heap: List[tuple] = [
            (-conf, r1.record_id, r2.record_id, next(tie), r1, r2)
            for conf, r1, r2 in pending
        ]
        heapq.heapify(heap)
        seen_pairs: set = set()
        taken: set = set()

        while heap:
            negconf, id1, id2, _, r1, r2 = heapq.heappop(heap)
            confidence = -negconf
            pkey = tuple(sorted((id1, id2)))
            if pkey in seen_pairs:
                continue
            seen_pairs.add(pkey)
            if id1 in taken or id2 in taken:
                self._remember_alternative(confidence, r1, r2)
                continue
            if not transform:
                blocked, to_retract = self._existing_conflicts(
                    links_by_id, fetched, id1, id2, confidence
                )
                if blocked:
                    self._remember_alternative(confidence, r1, r2)
                    continue
                for link in to_retract:
                    link.retract()
                    self._wrapped.linkdb.assert_link(link)
                    for rid in (link.id1, link.id2):
                        peers = links_by_id.get(rid)
                        if peers and link in peers:
                            peers.remove(link)
                    # the displaced endpoint re-competes with its
                    # remembered runner-ups; both endpoints of a replayed
                    # pair must still resolve to live records (a stale
                    # pair must never resurrect a deleted/re-indexed id)
                    displaced = link.id2 if link.id1 in (id1, id2) else link.id1
                    for alt_conf, a1, a2 in self._alternatives.get(
                        displaced, ()
                    ):
                        akey = tuple(sorted((a1.record_id, a2.record_id)))
                        if akey in seen_pairs:
                            continue
                        if not self._replay_live(a1, a2):
                            continue
                        heapq.heappush(
                            heap,
                            (-alt_conf, a1.record_id, a2.record_id,
                             next(tie), a1, a2),
                        )
                self._wrapped.matches(r1, r2, confidence)
                new = Link(id1, id2, LinkStatus.INFERRED,
                           LinkKind.DUPLICATE, confidence)
                links_by_id.setdefault(id1, []).append(new)
                links_by_id.setdefault(id2, []).append(new)
            taken.add(id1)
            taken.add(id2)
            self._record_entity_match(r1, r2, confidence)

        # ADVICE drift fix: suppressed-everywhere batch records still end
        # the batch with an event
        for rid, record in batch_queries.items():
            if rid not in taken and rid not in self._maybe_seen:
                self.no_match_for(record)

    def _remember_alternative(self, confidence: float, r1: Record,
                              r2: Record) -> None:
        # transform-mode pairs are transient probe queries — they must
        # never become assertable link material in a later real batch
        if self.link_database_updates_disabled:
            return
        pair = tuple(sorted((r1.record_id, r2.record_id)))
        for rid in (r1.record_id, r2.record_id):
            alts = self._alternatives.setdefault(rid, [])
            # one slot per pair: a repeatedly-suppressed pair must not
            # fill the cap with copies and evict distinct runner-ups
            alts[:] = [
                t for t in alts
                if tuple(sorted((t[1].record_id, t[2].record_id))) != pair
            ]
            alts.append((confidence, r1, r2))
            self._alt_batch[rid] = self._batch_no
            if len(alts) > self._ALTERNATIVE_CAP:
                alts.sort(key=lambda t: (-t[0], t[1].record_id,
                                         t[2].record_id))
                del alts[self._ALTERNATIVE_CAP:]

    def _replay_live(self, r1: Record, r2: Record) -> bool:
        """Both endpoints of a remembered pair still resolve to live
        records WITH the remembered content.  A re-indexed record
        invalidates its remembered pairs — their confidences were computed
        from the old values.  Fail closed when no resolver is wired: a
        listener constructed without one (any embedder bypassing
        build_workload) must not re-assert links from batch-old remembered
        confidences for records that may have been re-indexed or deleted
        since (displacement repair degrades gracefully; correctness wins)."""
        if self._record_resolver is None:
            return False
        for rec in (r1, r2):
            live = self._record_resolver(rec.record_id)
            if live is None or live.is_deleted() or live != rec:
                return False
        return True

    def _prune_alternatives(self) -> None:
        cutoff = self._batch_no - self._ALTERNATIVE_MAX_AGE
        stale = [rid for rid, b in self._alt_batch.items() if b <= cutoff]
        for rid in stale:
            self._alt_batch.pop(rid, None)
            self._alternatives.pop(rid, None)

    def _existing_conflicts(self, links_by_id: Dict[str, List[Link]],
                            fetched: set, id1: str, id2: str,
                            confidence: float):
        """Definite links from earlier batches touching either record.

        Returns (blocked, to_retract): blocked when an existing link with
        >= confidence already claims one of the records; otherwise the
        weaker existing links to retract before asserting the new pair.
        ``fetched`` is the set of ids whose links are COMPLETE in
        ``links_by_id`` (the batched prefetch also creates partial entries
        for out-of-batch endpoints of fetched links — completeness, not
        mere presence, decides whether the lazy per-record fetch runs).
        """
        pair = {id1, id2}
        blocked = False
        to_retract = []
        for rid in pair:
            if rid not in fetched:
                fetched.add(rid)
                known = links_by_id.setdefault(rid, [])
                keys = {l.key() for l in known}
                for link in self._wrapped.linkdb.get_all_links_for(rid):
                    if link.key() not in keys:
                        known.append(link)
            for link in links_by_id[rid]:
                if link.kind != LinkKind.DUPLICATE:
                    continue
                if link.status == LinkStatus.RETRACTED:
                    continue
                if {link.id1, link.id2} == pair:
                    continue  # same pair: plain re-assert
                if link.confidence >= confidence:
                    blocked = True
                else:
                    to_retract.append(link)
        return blocked, to_retract

    def matches(self, r1: Record, r2: Record, confidence: float) -> None:
        if self.one_to_one:
            self._pending_matches.append((confidence, r1, r2))
            return
        if not self.link_database_updates_disabled:
            self._wrapped.matches(r1, r2, confidence)
        self._record_entity_match(r1, r2, confidence)

    def matches_perhaps(self, r1: Record, r2: Record, confidence: float) -> None:
        if self.one_to_one:
            self._maybe_seen.add(r1.record_id)
        if not self.link_database_updates_disabled:
            self._wrapped.matches_perhaps(r1, r2, confidence)
        self._record_entity_match(r1, r2, confidence)

    def no_match_for(self, record: Record) -> None:
        if not self.link_database_updates_disabled:
            self._wrapped.no_match_for(record)

    def start_processing(self) -> None:
        if not self.link_database_updates_disabled:
            self._wrapped.start_processing()

    def end_processing(self) -> None:
        if not self.link_database_updates_disabled:
            self._wrapped.end_processing()

    def _record_entity_match(self, r1: Record, r2: Record, confidence: float) -> None:
        entity_id = r1.get_value(ORIGINAL_ENTITY_ID_PROPERTY_NAME)
        self._entity_matches.setdefault(entity_id, []).append((r2, confidence))

    def get_links_for_entity(self, entity_id: str) -> List[dict]:
        """duke_links rows for one input entity
        (BaseLinkDatabaseMatchListener.java:115-136)."""
        out = []
        for record, confidence in self._entity_matches.get(entity_id, []):
            out.append(
                {
                    "datasetId": record.get_value(DATASET_ID_PROPERTY_NAME),
                    "entityId": record.get_value(ORIGINAL_ENTITY_ID_PROPERTY_NAME),
                    "confidence": confidence,
                }
            )
        return out
