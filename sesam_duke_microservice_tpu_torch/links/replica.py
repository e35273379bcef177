"""Replicated link serving: the leader-side publisher, the follower-side
replica link database, and the ``?since=`` feed-row materialization.

Counterpart of the JAX package's ``links/replica.py``.  Every process of
a serving group (``parallel/dispatch.py``) but the frontend keeps a
replica of each workload's link database and serves feed polls itself:

  * ``PublishingLinkDatabase`` -- leader-side wrapper the dispatcher
    installs around each workload's link database.  Writes pass through;
    ``commit()`` seals the arrival-ordered batch (scoring matches,
    one-to-one retractions and rewrites, delete retractions), assigns the
    next sequence number and hands the encoded rows to a publish callback
    (``Dispatcher.broadcast``).  Rows are encoded *at assert time*,
    because callers mutate Link objects in place (retract, re-assert).
  * ``ReplicaLinkDatabase`` -- follower-side replica: an in-memory link
    DB applying published batches under a monotonic applied-seq
    watermark.  A duplicate batch drops; a sequence *gap* raises
    ``ReplicaGap`` (a replica that missed a batch must resync, never
    serve a hole).  Leader timestamps are kept verbatim, so a replica
    feed page is bit-identical to the leader's at the same watermark.

``feed_row``/``links_feed_page`` are THE feed-row materialization:
``engine.workload.Workload`` and the follower read plane
(``service/replica_plane.py``) both call them, so leader and replica
feeds cannot drift by construction.  The wire rows (``encode_link``) and
``rows_checksum`` are the JAX package's, byte for byte.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, Tuple

from ..core.records import (
    DATASET_ID_PROPERTY_NAME,
    ORIGINAL_ENTITY_ID_PROPERTY_NAME,
)
from .base import Link, LinkDatabase, LinkKind, LinkStatus
from .memory import InMemoryLinkDatabase

# one link on the wire: plain tuple, no pickle-by-reference surprises
LinkRow = Tuple[str, str, str, str, float, int]


def encode_link(link: Link) -> LinkRow:
    return (link.id1, link.id2, link.status.value, link.kind.value,
            link.confidence, link.timestamp)


def decode_link(row: Sequence) -> Link:
    id1, id2, status, kind, confidence, timestamp = row
    return Link(id1, id2, LinkStatus(status), LinkKind(kind), confidence,
                timestamp=timestamp)


def rows_checksum(rows: Sequence[Sequence]) -> int:
    """CRC32 chained over the canonical JSON of encoded link rows: the
    integrity stamp on shipped link state (the corpus snapshot's
    ``__checksum`` stance: the transport may be fine while the payload is
    not).  Order-sensitive by design: the rows travel in arrival order
    and must land that way."""
    import json
    import zlib

    crc = 0
    for row in rows:
        crc = zlib.crc32(
            json.dumps(list(row), separators=(",", ":"),
                       ensure_ascii=True).encode("utf-8"), crc)
    return crc


class ReplicaGap(RuntimeError):
    """The replica missed at least one published batch: its feed would
    silently serve a hole, so it must resync (re-bootstrap) instead."""


class PublishingLinkDatabase(LinkDatabase):
    """Leader-side pass-through wrapper that publishes committed batches.

    Installed by ``Dispatcher._tag_workloads`` around the workload's link
    database (write-behind wrapper or bare backend alike), so EVERY link
    write — scoring matches, one-to-one retractions/rewrites, delete
    retractions — is captured in arrival order.  ``commit()`` seals the
    captured rows as one batch with the next sequence number and invokes
    ``publish(seq, rows)``; an empty buffer publishes nothing.

    The publish happens after the inner commit returns, i.e. after the
    write-behind wrapper *enqueued* (not necessarily flushed) the batch:
    a leader crash between flush and publish can leave replicas with
    rows the leader's disk never saw — the failover direction that
    loses nothing (the promoted replica is ahead, never behind).
    """

    def __init__(self, inner: LinkDatabase,
                 publish: Callable[[int, List[LinkRow]], None],
                 seq: int = 0):
        self.inner = inner
        self._publish = publish
        self._pending: List[LinkRow] = []  # single-writer: ingest path under the workload lock
        self.seq = seq

    # -- writes (captured in arrival order) ----------------------------------

    def assert_link(self, link: Link) -> None:
        self.inner.assert_link(link)
        self._pending.append(encode_link(link))

    def assert_links(self, links: List[Link]) -> None:
        self.inner.assert_links(links)
        self._pending.extend(encode_link(l) for l in links)

    def commit(self) -> None:
        self.inner.commit()
        if self._pending:
            # seq advances and the buffer clears only AFTER the publish
            # returns: a publish that raises (frontend-desync latch, an
            # injected leader crash the process survives) leaves the
            # batch pending under the SAME seq, so the next successful
            # commit re-publishes it (merged with newer writes, arrival
            # order intact) instead of leaving a silent hole every
            # replica would trip over as a ReplicaGap.
            self._publish(self.seq + 1, self._pending)
            self.seq += 1
            self._pending = []

    # -- reads / lifecycle (delegate) ----------------------------------------

    def get_all_links_for(self, record_id: str) -> List[Link]:
        return self.inner.get_all_links_for(record_id)

    def get_links_for_ids(self, record_ids) -> List[Link]:
        return self.inner.get_links_for_ids(record_ids)

    def get_all_links(self) -> List[Link]:
        return self.inner.get_all_links()

    def count(self) -> int:
        return self.inner.count()

    def get_changes_since(self, since: int) -> List[Link]:
        return self.inner.get_changes_since(since)

    def get_changes_page(self, since: int, limit: int) -> List[Link]:
        return self.inner.get_changes_page(since, limit)

    def drain(self) -> None:
        self.inner.drain()

    @property
    def flush_error(self) -> Optional[BaseException]:
        return getattr(self.inner, "flush_error", None)

    @property
    def recovering(self) -> bool:
        """See through to the wrapped write-behind database's overlapped
        startup replay, so the HTTP write fence answers its fast 503 on a
        dispatcher-tagged workload too."""
        return getattr(self.inner, "recovering", False)

    @property
    def journal(self):
        """The wrapped write-behind database's durable journal, or None
        — surfaced so the /metrics journal gauges see through this
        wrapper on dispatcher-tagged workloads."""
        return getattr(self.inner, "journal", None)

    def close(self) -> None:
        self.inner.close()


class ReplicaLinkDatabase(InMemoryLinkDatabase):
    """Follower-side replica with a monotonic applied-op watermark.

    ``apply_ops`` is idempotent under duplicate delivery (seq <=
    watermark drops) and loud under loss (gap raises ``ReplicaGap``).
    ``note_head`` tracks the highest sequence number *announced* (op
    received, not yet applied) so ``lag_ops`` measures real replication
    lag for the ``X-Replica-Lag`` header and ``duke_replica_lag_ops``.

    All entry points take ``self.lock`` — the replica is written by the
    follower's replay thread and read concurrently by the follower HTTP
    read plane (no leader lock is ever involved, which is the point).
    After promotion the same object serves as the workload's link
    database; the lock then simply guards listener writes against any
    still-draining replica reads.
    """

    def __init__(self, seq: int = 0):
        super().__init__()
        self.lock = threading.RLock()
        self.applied_seq = seq  # guarded by: self.lock [writes]
        self.head_seq = seq  # guarded by: self.lock [writes]

    def load_snapshot(self, rows: Sequence[LinkRow], seq: int) -> None:
        """Adopt the leader's bootstrap link state at watermark ``seq``."""
        with self.lock:
            for row in rows:
                super().assert_link(decode_link(row))
            self.applied_seq = seq
            self.head_seq = max(self.head_seq, seq)

    def note_head(self, seq: int) -> None:
        with self.lock:
            if seq > self.head_seq:
                self.head_seq = seq

    def apply_ops(self, seq: int, rows: Sequence[LinkRow]) -> bool:
        """Fold one published batch; returns False for a duplicate."""
        with self.lock:
            if seq > self.head_seq:
                self.head_seq = seq
            if seq <= self.applied_seq:
                return False  # duplicate delivery: already folded
            if seq != self.applied_seq + 1:
                raise ReplicaGap(
                    f"link-stream gap: batch {seq} arrived at watermark "
                    f"{self.applied_seq} (missed "
                    f"{seq - self.applied_seq - 1} batch(es)); this "
                    "replica must resync"
                )
            for row in rows:
                super().assert_link(decode_link(row))
            self.applied_seq = seq
            return True

    def lag_ops(self) -> int:
        with self.lock:
            return self.head_seq - self.applied_seq

    # -- locked LinkDatabase surface -----------------------------------------
    # (the in-memory base is written for single-writer workload-locked use;
    # here the replay thread and the read plane interleave freely)

    def assert_link(self, link: Link) -> None:
        with self.lock:
            super().assert_link(link)

    def assert_links(self, links: List[Link]) -> None:
        with self.lock:
            super().assert_links(links)

    def get_all_links_for(self, record_id: str) -> List[Link]:
        with self.lock:
            return super().get_all_links_for(record_id)

    def get_links_for_ids(self, record_ids) -> List[Link]:
        with self.lock:
            return super().get_links_for_ids(record_ids)

    def get_all_links(self) -> List[Link]:
        with self.lock:
            return super().get_all_links()

    def get_changes_since(self, since: int) -> List[Link]:
        with self.lock:
            return super().get_changes_since(since)

    def get_changes_page(self, since: int, limit: int) -> List[Link]:
        with self.lock:
            return super().get_changes_page(since, limit)


# -- shared feed materialization ---------------------------------------------


def feed_row(link: Link, find_record_by_id) -> dict:
    """One ``?since=`` feed row (wire format per App.java:744-770): the
    leader's ``Workload.links_page`` and the follower read plane both
    resolve through this."""
    r1 = find_record_by_id(link.id1)
    r2 = find_record_by_id(link.id2)
    return {
        "_id": f"{link.id1}_{link.id2}".replace(":", "_"),
        "_updated": link.timestamp,
        "_deleted": link.status == LinkStatus.RETRACTED,
        "entity1": r1.get_value(ORIGINAL_ENTITY_ID_PROPERTY_NAME) if r1 else None,
        "entity2": r2.get_value(ORIGINAL_ENTITY_ID_PROPERTY_NAME) if r2 else None,
        "dataset1": r1.get_value(DATASET_ID_PROPERTY_NAME) if r1 else None,
        "dataset2": r2.get_value(DATASET_ID_PROPERTY_NAME) if r2 else None,
        "confidence": link.confidence,
    }


def links_feed_page(link_db: LinkDatabase, index, since: int, limit: int):
    """One bounded feed page: (rows, next_cursor) — see
    ``Workload.links_page`` for the paging contract.  Lazy record
    mirrors resolve link endpoints through one batched prefetch."""
    links = link_db.get_changes_page(since, limit)
    if not links:
        return [], since
    prefetch = getattr(getattr(index, "records", None), "prefetch", None)
    if prefetch is not None:
        ids = {l.id1 for l in links} | {l.id2 for l in links}
        prefetch(ids)
    return ([feed_row(l, index.find_record_by_id) for l in links],
            links[-1].timestamp)
