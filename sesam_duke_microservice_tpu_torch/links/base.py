"""Link model and link-database interface.

Re-expresses the Duke 1.2 link API surface the reference drives
(``Link``/``LinkStatus``/``LinkDatabase`` — App.java:63-65,997-1000;
SinceAwareInMemoryLinkDatabase.java) in Python.  A link records that two
record ids were inferred to (maybe) refer to the same entity; clients poll
changes incrementally by millisecond timestamp (``get_changes_since``,
served by GET /deduplication/:name?since=N — App.java:843).
"""

from __future__ import annotations

import enum
import threading
import time
from typing import List, Optional


class LinkStatus(enum.Enum):
    ASSERTED = "asserted"
    INFERRED = "inferred"
    UNKNOWN = "unknown"
    RETRACTED = "retracted"


class LinkKind(enum.Enum):
    DUPLICATE = "duplicate"
    MAYBE = "maybe"
    DIFFERENT = "different"


_last_millis = 0
_millis_lock = threading.Lock()


def now_millis() -> int:
    """Millisecond wall-clock, strictly monotonic per process.

    The reference stamps links with System.currentTimeMillis, so two updates
    to the same link within one millisecond are indistinguishable to a
    ``?since=`` poller.  Bumping by 1ms on collision keeps every change
    observable without altering the wire format.
    """
    global _last_millis
    with _millis_lock:
        now = int(time.time() * 1000)
        if now <= _last_millis:
            now = _last_millis + 1
        _last_millis = now
        return now


class Link:
    """An (id1, id2) pair with status/kind/confidence/timestamp.

    Ids are stored in sorted order so (a, b) and (b, a) are the same link
    (Duke's Link constructor normalizes the same way; the feed's ``_id`` is
    ``id1 + "_" + id2`` — App.java:759).
    """

    __slots__ = ("id1", "id2", "status", "kind", "confidence", "timestamp")

    def __init__(self, id1: str, id2: str, status: LinkStatus, kind: LinkKind,
                 confidence: float, timestamp: Optional[int] = None):
        if id1 > id2:
            id1, id2 = id2, id1
        self.id1 = id1
        self.id2 = id2
        self.status = status
        self.kind = kind
        self.confidence = float(confidence)
        self.timestamp = now_millis() if timestamp is None else int(timestamp)

    def key(self):
        return (self.id1, self.id2)

    def retract(self) -> None:
        """Mark the link retracted and touch the timestamp (Duke Link.retract;
        driven at App.java:997-1000)."""
        self.status = LinkStatus.RETRACTED
        self.timestamp = now_millis()

    def copy(self) -> "Link":
        return Link(self.id1, self.id2, self.status, self.kind,
                    self.confidence, self.timestamp)

    def __repr__(self) -> str:
        return (f"Link({self.id1!r}, {self.id2!r}, {self.status.value}, "
                f"{self.kind.value}, {self.confidence:.4f}, ts={self.timestamp})")


class LinkDatabase:
    """Interface: assert/retrieve links, incremental change feed."""

    def assert_link(self, link: Link) -> None:
        raise NotImplementedError

    def assert_links(self, links: List[Link]) -> None:
        """Assert a whole batch of links in arrival order.

        The listener chain collects one batch's match events and persists
        them here in a single call — the durable backend turns this into
        ONE transaction (``executemany``) instead of a query+commit per
        link, which dominated the persist phase on match-heavy batches.
        This default keeps tiny custom backends working.
        """
        for link in links:
            self.assert_link(link)

    def get_all_links_for(self, record_id: str) -> List[Link]:
        raise NotImplementedError

    def get_links_for_ids(self, record_ids) -> List[Link]:
        """All links touching any of ``record_ids`` — one batched lookup.

        The one-to-one flush needs every existing link for a whole batch of
        records; per-pair ``get_all_links_for`` calls would dominate
        ``batch_done`` latency on large linkage batches.  Backends override
        with a single scan/query; this default keeps tiny custom backends
        working.
        """
        ids = set(record_ids)
        seen = {}
        for rid in ids:
            for link in self.get_all_links_for(rid):
                seen[link.key()] = link
        return list(seen.values())

    def get_all_links(self) -> List[Link]:
        raise NotImplementedError

    def count(self) -> int:
        """Total link rows (asserted + retracted) — the /stats and
        /metrics per-workload row count.  Backends override with an O(1)
        counter or a COUNT(*) query; this default keeps tiny custom
        backends working."""
        return len(self.get_all_links())

    def get_changes_since(self, since: int) -> List[Link]:
        raise NotImplementedError

    def get_changes_page(self, since: int, limit: int) -> List[Link]:
        """First ``limit`` changes after ``since`` in (timestamp, id1, id2)
        order — EXTENDED to include every further link sharing the page's
        final timestamp, so a caller paging with ``since = page[-1]
        .timestamp`` never skips a tied row.  Timestamps are unique for
        links written by this process (links.base.now_millis is strictly
        monotonic), so the extension only triggers on data imported from
        elsewhere.  Backends override with a bounded query; this default
        keeps tiny custom backends working (it materializes the full
        tail)."""
        changes = self.get_changes_since(since)
        if limit <= 0 or len(changes) <= limit:
            return changes
        cut = limit
        last_ts = changes[limit - 1].timestamp
        while cut < len(changes) and changes[cut].timestamp == last_ts:
            cut += 1
        return changes[:cut]

    def commit(self) -> None:
        pass

    def drain(self) -> None:
        """Block until every buffered/asynchronous write is durably
        applied.  Synchronous backends have nothing pending — only the
        write-behind wrapper overrides; callers needing the barrier
        (snapshot save, benchmarks) call it unconditionally."""

    @property
    def flush_error(self):
        """The latched background-flush failure, or None.  Synchronous
        backends can never latch; the write-behind wrapper overrides.
        Surfaced by ``/readyz`` (unready) and ``/healthz`` so a dead
        persistence thread is visible to orchestrators before a read
        drains into it."""
        return None

    def close(self) -> None:
        pass


# Idempotence tolerance for repeated asserts of an unchanged link
# (SinceAwareInMemoryLinkDatabase.java:22-24)
CONFIDENCE_EPSILON = 1e-6


def is_same_assertion(old: Link, new: Link) -> bool:
    return (
        old.status == new.status
        and old.kind == new.kind
        and abs(old.confidence - new.confidence) < CONFIDENCE_EPSILON
    )
