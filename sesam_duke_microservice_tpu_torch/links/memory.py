"""In-memory link database with since-feed and idempotent assert.

Parity target: SinceAwareInMemoryLinkDatabase.java:10-42 — re-asserting an
identical link (same status/kind, |confidence delta| < 1e-6) must NOT bump
the timestamp, so pollers don't see spurious changes.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from .base import Link, LinkDatabase, is_same_assertion


class InMemoryLinkDatabase(LinkDatabase):
    _SORT_KEY = staticmethod(lambda l: (l.timestamp, l.id1, l.id2))

    def __init__(self):
        self._links: Dict[Tuple[str, str], Link] = {}
        # timestamp-ordered view, built lazily and maintained INCREMENTALLY
        # on writes: new links carry a fresh (strictly monotonic) timestamp
        # so they append at the tail, replaced/mutated links are removed
        # first.  Keeping the view live matters for the streaming feed —
        # invalidating on every write would make each page of a paged
        # GET ?since= re-sort the whole set under the workload lock
        # whenever ingest interleaves with paging.
        self._sorted: Optional[List[Link]] = None

    def _append_sorted(self, link: Link) -> None:
        s = self._sorted
        key = self._SORT_KEY
        if s and key(s[-1]) > key(link):
            # out-of-order write (explicit historical timestamp, e.g.
            # imported data): insert at the right position
            bisect.insort(s, link, key=key)
        else:
            s.append(link)

    def _remove_sorted(self, old: Link) -> None:
        s = self._sorted
        # fast path: locate by sort key (valid while the object is
        # unmutated) and confirm identity
        i = bisect.bisect_left(s, self._SORT_KEY(old), key=self._SORT_KEY)
        if i < len(s) and s[i] is old:
            del s[i]
            return
        # mutated in place (retract() bumped the timestamp before this
        # call): C-speed identity scan — Link defines no __eq__
        try:
            s.remove(old)
        except ValueError:
            self._sorted = None  # unseen object; rebuild lazily

    def assert_link(self, link: Link) -> None:
        old = self._links.get(link.key())
        if old is link:
            # caller mutated the stored object in place (retract() then
            # re-assert, the workload's deletion flow): re-position it
            if self._sorted is not None:
                self._remove_sorted(link)
                if self._sorted is not None:
                    self._append_sorted(link)
            return
        if old is not None and is_same_assertion(old, link):
            return
        self._links[link.key()] = link
        if self._sorted is not None:
            if old is not None:
                self._remove_sorted(old)
            if self._sorted is not None:
                self._append_sorted(link)

    def get_all_links_for(self, record_id: str) -> List[Link]:
        # COPIES, not the stored objects (matching the sqlite backend's
        # fresh rows): callers retract-then-reassert these, and an
        # in-place mutation of a stored link would invalidate its sort key
        # before assert_link sees it — degrading every retraction to an
        # O(n) identity scan of the ordered view
        return [
            l.copy() for l in self._links.values()
            if l.id1 == record_id or l.id2 == record_id
        ]

    def get_links_for_ids(self, record_ids) -> List[Link]:
        ids = set(record_ids)
        return [
            l.copy() for l in self._links.values()
            if l.id1 in ids or l.id2 in ids
        ]

    def get_all_links(self) -> List[Link]:
        return list(self._links.values())

    def count(self) -> int:
        # lock-free O(1): len() of a dict is safe against concurrent
        # writers under the GIL, so /stats never waits on ingest
        return len(self._links)

    def _ordered(self) -> List[Link]:
        if self._sorted is None:
            self._sorted = sorted(
                self._links.values(),
                key=lambda l: (l.timestamp, l.id1, l.id2),
            )
        return self._sorted

    def get_changes_since(self, since: int) -> List[Link]:
        # timestamp order (SinceAwareInMemoryLinkDatabase.java:33-41),
        # strictly-greater-than semantics
        ordered = self._ordered()
        start = bisect.bisect_right(ordered, since, key=lambda l: l.timestamp)
        return ordered[start:]

    def get_changes_page(self, since: int, limit: int) -> List[Link]:
        ordered = self._ordered()
        start = bisect.bisect_right(ordered, since, key=lambda l: l.timestamp)
        if limit <= 0 or start + limit >= len(ordered):
            return ordered[start:]
        cut = start + limit
        last_ts = ordered[cut - 1].timestamp
        while cut < len(ordered) and ordered[cut].timestamp == last_ts:
            cut += 1
        return ordered[start:cut]
