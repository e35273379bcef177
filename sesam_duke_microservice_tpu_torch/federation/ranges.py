"""The partition map: digest ranges over the record-id keyspace.

Corpus rows shard across serving groups by **digest range**: the routing
key is the first 8 bytes of SHA-256 over the *store record id*
(``[groupNo__]datasetId__entityId`` -- the id ``service.datasource``
synthesizes and every link row carries as its endpoints).  The id -- not
the content digest ``store.records.record_digest`` folds -- because the
routing key must be stable under record updates: re-homing a record on
every content change would turn routine upserts into migrations.

A link row is owned by the range owning ``route_key(link.id1)`` (ids
are stored sorted, so id1 is deterministic for a pair).  Ownership
governs which group's feed EMITS the row in the federated merge -- the
one-place dedup rule that makes post-migration stale copies at the old
owner harmless (router.py filters by it).

The map itself is a fixed set of contiguous ranges (created equal-width
at federation init; migration moves whole ranges between groups, it
never splits them), each carrying its owner group and a frozen flag.
Two monotonic stamps protect it:

  * ``version`` -- bumped on every persisted change; the feed cursor
    embeds it so a client token can be recognized across map changes.
  * ``epoch`` -- the write fence (the serving group's leadership epoch,
    generalized to ranges): freeze and cutover bump it, and every group
    checks the router's epoch against its own fence before accepting
    writes -- a router holding a stale map can never write into a
    range's OLD owner (``StaleRouterEpoch`` tells it to refresh and
    re-route).

Persistence is a single JSON document written tmp + ``os.replace`` (the
corpus-snapshot discipline): a crash mid-persist leaves the previous
complete map, never a torn one -- which is what makes the migration
cutover atomic.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Dict, List, Optional

KEY_BITS = 64
KEY_SPACE = 1 << KEY_BITS


def route_key(record_id: str) -> int:
    """64-bit routing key for a store record id (first 8 bytes of its
    SHA-256, big-endian) -- uniform over the keyspace, stable forever."""
    digest = hashlib.sha256(
        record_id.encode("utf-8", "surrogatepass")).digest()
    return int.from_bytes(digest[:8], "big")


class StaleRouterEpoch(RuntimeError):
    """A router presented an epoch below a group's fence: its map
    predates a freeze/cutover, so its routing for some range is no
    longer trustworthy.  The router refreshes its map and re-routes --
    it must never be allowed to write into a range's old owner."""

    def __init__(self, fence_epoch: int, presented: int):
        super().__init__(
            f"router epoch {presented} is stale (group fence at "
            f"{fence_epoch}); refresh the partition map and re-route")
        self.fence_epoch = fence_epoch
        self.presented = presented


class Range:
    """One contiguous slice [lo, hi) of the routing keyspace."""

    __slots__ = ("lo", "hi", "group", "frozen")

    def __init__(self, lo: int, hi: int, group: int, frozen: bool = False):
        self.lo = lo
        self.hi = hi
        self.group = group
        self.frozen = frozen

    @property
    def range_id(self) -> str:
        """Stable identity: the start key, zero-padded hex (ranges never
        split, so the start key names the range for its lifetime --
        cursors and migration state refer to it across owner changes)."""
        return f"{self.lo:016x}"

    def contains(self, key: int) -> bool:
        return self.lo <= key < self.hi

    def to_json(self) -> dict:
        return {"lo": f"{self.lo:016x}", "hi": f"{self.hi:016x}",
                "group": self.group, "frozen": self.frozen}

    @classmethod
    def from_json(cls, obj: dict) -> "Range":
        return cls(int(obj["lo"], 16), int(obj["hi"], 16),
                   int(obj["group"]), bool(obj.get("frozen", False)))


class PartitionMap:
    """Versioned, epoch-stamped digest-range → group assignment.

    Mutations (freeze / assign) persist atomically BEFORE they take
    effect in memory -- a crash can lose an un-persisted intent (redone
    by migration resume) but can never leave memory ahead of disk, so a
    restart always reloads exactly what the last completed mutation
    published.  Reads snapshot under the lock and hand out copies; the
    lock is a leaf (nothing is ever acquired under it except the file
    write)."""

    def __init__(self, ranges: List[Range], version: int, epoch: int,
                 n_groups: int, path: Optional[str] = None):
        self._lock = threading.Lock()
        self._ranges = ranges  # guarded by: self._lock [writes]
        self.version = version  # guarded by: self._lock [writes]
        self.epoch = epoch  # guarded by: self._lock [writes]
        self.n_groups = n_groups
        self.path = path

    # -- construction / persistence ------------------------------------------

    @classmethod
    def create(cls, n_groups: int, n_ranges: int,
               path: Optional[str] = None) -> "PartitionMap":
        """Equal-width ranges, round-robin over groups (adjacent ranges
        land on different groups, so a hot contiguous key region spreads
        instead of camping on one group)."""
        n_ranges = max(n_groups, n_ranges)
        bounds = [KEY_SPACE * i // n_ranges for i in range(n_ranges)]
        bounds.append(KEY_SPACE)
        ranges = [
            Range(bounds[i], bounds[i + 1], i % n_groups)
            for i in range(n_ranges)
        ]
        pmap = cls(ranges, version=1, epoch=1, n_groups=n_groups, path=path)
        if path is not None:
            pmap._persist_locked()
        return pmap

    @classmethod
    def load(cls, path: str) -> "PartitionMap":
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        ranges = [Range.from_json(r) for r in doc["ranges"]]
        pmap = cls(ranges, version=int(doc["version"]),
                   epoch=int(doc["epoch"]), n_groups=int(doc["n_groups"]),
                   path=path)
        pmap._validate(ranges)
        return pmap

    @classmethod
    def load_or_create(cls, path: str, *, n_groups: int,
                       n_ranges: int) -> "PartitionMap":
        if os.path.exists(path):
            return cls.load(path)
        return cls.create(n_groups, n_ranges, path=path)

    def _persist_locked(self) -> None:
        # dukecheck: holds self._lock
        if self.path is None:
            return
        from ..utils.atomicio import atomic_write_json

        atomic_write_json(self.path, {
            "version": self.version,
            "epoch": self.epoch,
            "n_groups": self.n_groups,
            "ranges": [r.to_json() for r in self._ranges],
        })

    @staticmethod
    def _validate(ranges: List[Range]) -> None:
        """Full coverage, no overlap -- a map that drops or doubles a key
        would silently lose or duplicate rows, the exact failure class
        this subsystem exists to exclude."""
        ordered = sorted(ranges, key=lambda r: r.lo)
        if not ordered or ordered[0].lo != 0 or ordered[-1].hi != KEY_SPACE:
            raise ValueError("partition map does not cover the keyspace")
        for prev, cur in zip(ordered, ordered[1:]):
            if prev.hi != cur.lo:
                raise ValueError(
                    f"partition map gap/overlap at {prev.hi:016x} vs "
                    f"{cur.lo:016x}")

    # -- reads ----------------------------------------------------------------

    def ranges(self) -> List[Range]:
        """Snapshot copy (callers iterate lock-free over it)."""
        with self._lock:
            return [Range(r.lo, r.hi, r.group, r.frozen)
                    for r in self._ranges]

    def owner(self, key: int) -> Range:
        with self._lock:
            for r in self._ranges:
                if r.contains(key):
                    return Range(r.lo, r.hi, r.group, r.frozen)
        raise AssertionError(f"key {key:#x} outside the keyspace")

    def find(self, range_id: str) -> Range:
        with self._lock:
            for r in self._ranges:
                if r.range_id == range_id:
                    return Range(r.lo, r.hi, r.group, r.frozen)
        raise KeyError(f"unknown range {range_id!r}")

    def group_ranges(self, group: int) -> List[Range]:
        with self._lock:
            return [Range(r.lo, r.hi, r.group, r.frozen)
                    for r in self._ranges if r.group == group]

    def range_ids(self) -> List[str]:
        with self._lock:
            return [r.range_id for r in self._ranges]

    def to_json(self) -> dict:
        with self._lock:
            return {
                "version": self.version,
                "epoch": self.epoch,
                "n_groups": self.n_groups,
                "ranges": [dict(r.to_json(), id=r.range_id)
                           for r in self._ranges],
            }

    # -- mutations (migration only) -------------------------------------------

    def freeze(self, range_id: str) -> int:
        """Mark the range frozen (writes 429 at the router) and bump
        version+epoch; persisted before returning.  Idempotent -- a
        resumed migration re-freezing an already-frozen range changes
        nothing.  Returns the (possibly new) epoch."""
        with self._lock:
            r = self._find_locked(range_id)
            if not r.frozen:
                self._mutate_persist_locked(r, group=r.group, frozen=True)
            return self.epoch

    def assign(self, range_id: str, group: int) -> int:
        """Cut the range over to ``group`` and thaw it -- THE atomic
        cutover point (single ``os.replace``): before this persists the
        source owns the range, after it the target does, and no state
        in between can be observed by a restart.  Returns the new
        epoch."""
        if not (0 <= group < self.n_groups):
            raise ValueError(f"unknown group {group}")
        with self._lock:
            r = self._find_locked(range_id)
            if r.group != group or r.frozen:
                self._mutate_persist_locked(r, group=group, frozen=False)
            return self.epoch

    def _mutate_persist_locked(self, r: Range, *, group: int,
                               frozen: bool) -> None:
        # dukecheck: holds self._lock
        """Apply one range mutation + version/epoch bump and persist --
        rolling the MEMORY back if the persist fails, so the live
        process never routes on state a restart would not reload (the
        class contract: memory is never ahead of disk).  A failed
        freeze leaves the range live instead of 429ing forever on an
        intent only this process ever knew about."""
        saved = (r.group, r.frozen, self.version, self.epoch)
        r.group = group
        r.frozen = frozen
        self.version += 1
        self.epoch += 1
        try:
            self._persist_locked()
        except BaseException:
            r.group, r.frozen, self.version, self.epoch = saved
            raise

    def _find_locked(self, range_id: str) -> Range:
        # dukecheck: holds self._lock
        for r in self._ranges:
            if r.range_id == range_id:
                return r
        raise KeyError(f"unknown range {range_id!r}")


def owned_spans(ranges: List[Range], group: int) -> List[tuple]:
    """The (lo, hi) spans of ``ranges`` owned by ``group`` -- the
    filter the router hands a group's feed walk."""
    return [(r.lo, r.hi) for r in ranges if r.group == group]


def span_covers(spans: List[tuple], key: int) -> bool:
    return any(lo <= key < hi for lo, hi in spans)


def link_owner_key(id1: str) -> int:
    """Routing key that OWNS a link row: the key of its lexicographically
    lower endpoint (``Link`` stores ids sorted, so this is stable however
    the pair was asserted)."""
    return route_key(id1)


# map version embedded in cursors; bump if Dict / encoding changes shape
CURSOR_FORMAT = 1


def encode_cursor(version: int, positions: Dict[str, int]) -> str:
    """Opaque federated ``?since=`` token: base64url JSON of the map
    version + per-RANGE timestamp cursors.  Per range -- not per group --
    so the cursor survives a range changing owners: after a cutover the
    new owner simply continues the range's stream past the same
    position (migration ships rows with timestamps verbatim)."""
    import base64

    doc = {"f": CURSOR_FORMAT, "v": version,
           "r": {k: int(v) for k, v in positions.items() if v}}
    raw = json.dumps(doc, separators=(",", ":"), sort_keys=True)
    return base64.urlsafe_b64encode(raw.encode("ascii")).decode("ascii")


class BadCursor(ValueError):
    pass


def decode_cursor(token: str) -> Dict[str, int]:
    """Per-range positions out of a federated token.  A bare integer is
    accepted as a legacy single-group cursor: it becomes every range's
    position (the pre-federation ``?since=<millis>`` client keeps
    working).  Unknown ranges in the token are ignored and missing
    ranges start at 0 -- both directions of map drift are safe because
    feed semantics are strictly-greater-than per range."""
    import base64
    import binascii

    token = (token or "").strip()
    if not token:
        return {}
    try:
        return {"*": int(token)}  # legacy integer cursor: applies to all
    except ValueError:
        pass
    try:
        raw = base64.urlsafe_b64decode(token.encode("ascii"))
        doc = json.loads(raw.decode("ascii"))
        if doc.get("f") != CURSOR_FORMAT:
            raise BadCursor(f"unknown cursor format {doc.get('f')!r}")
        return {str(k): int(v) for k, v in dict(doc.get("r", {})).items()}
    except BadCursor:
        raise
    except (ValueError, binascii.Error, AttributeError, TypeError) as e:
        raise BadCursor(f"undecodable since token: {e}") from e
