"""Bounded keyed rings with tail-latch-aware eviction (a copy of the JAX
package's ``telemetry/rings.py``).

The flight recorder (tracing.FlightRecorder) and the decision
recorder (telemetry.decisions.DecisionRecorder) share one
retention problem: a bounded ring of records where *remarkable* entries —
slow/errored traces, device-vs-host disagreements, near-threshold band
skips — must survive pressure from a flood of unremarkable sampled ones.
Both used to need their own ring + eviction loop; this module is the ONE
copy of that core so the two recorders can never drift onto different
latch semantics.

``LatchedRing`` is a keyed insertion-order ring bounded by record count
and (optionally) bytes.  Eviction prefers the OLDEST UNREMARKABLE entry;
only when every other entry is remarkable does plain FIFO apply — so an
upstream that floods the ring with sampled records cannot flush the
latched ones the ring exists to keep, yet a ring saturated with latched
records stays LIVE (oldest latched falls off rather than every new
record dying on arrival).  The byte budget is a hard bound (memory
safety beats retention), except that the newest record is never evicted
— a single over-budget record survives alone.

All methods take the ring's re-entrant lock; callers composing compound
read-modify-write operations (the flight recorder's same-trace-id merge)
hold ``ring.lock`` around the sequence.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, List, Optional

__all__ = ["LatchedRing"]


class _Entry:
    __slots__ = ("record", "remarkable", "nbytes")

    def __init__(self, record: Any, remarkable: bool, nbytes: int):
        self.record = record
        self.remarkable = remarkable
        self.nbytes = nbytes


class LatchedRing:
    """Keyed bounded ring; eviction prefers unremarkable entries."""

    def __init__(self, capacity: int, byte_budget: int = 0):
        self.lock = threading.RLock()
        self._capacity = max(1, int(capacity))
        self._byte_budget = max(0, int(byte_budget))
        self._order: deque = deque()          # keys, oldest first
        self._entries: dict = {}              # key -> _Entry
        self._bytes = 0
        self.evicted = 0                      # lifetime evictions (stats)

    def __len__(self) -> int:
        with self.lock:
            return len(self._order)

    @property
    def bytes(self) -> int:
        return self._bytes

    @property
    def capacity(self) -> int:
        return self._capacity

    def put(self, key: str, record: Any, *, remarkable: bool = False,
            nbytes: int = 0) -> None:
        """Insert or replace.  Replacing keeps the key's ring position
        (the flight recorder merges follower spans into an existing trace
        without promoting it to newest)."""
        with self.lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._bytes += nbytes - entry.nbytes
                entry.record = record
                entry.remarkable = remarkable
                entry.nbytes = nbytes
            else:
                self._entries[key] = _Entry(record, remarkable, nbytes)
                self._order.append(key)
                self._bytes += nbytes
            self._evict(key)

    def _evict(self, newest: str) -> None:
        # called with the lock held; ``newest`` is the key just written
        # and is never the victim — a budget saturated by latched
        # records must rotate (oldest latched out) rather than drop
        # every fresh record on arrival
        while len(self._order) > self._capacity or (
            self._byte_budget
            and self._bytes > self._byte_budget
            and len(self._order) > 1
        ):
            victim = None
            for key in self._order:
                if key != newest and not self._entries[key].remarkable:
                    victim = key
                    break
            if victim is None:
                for key in self._order:  # all remarkable: plain FIFO
                    if key != newest:
                        victim = key
                        break
            if victim is None:
                return  # only the newest record remains
            self._order.remove(victim)
            entry = self._entries.pop(victim)
            self._bytes -= entry.nbytes
            self.evicted += 1

    def get(self, key: str) -> Optional[Any]:
        with self.lock:
            entry = self._entries.get(key)
            return entry.record if entry is not None else None

    def records(self) -> List[Any]:
        """Most-recent-first snapshot of the retained records."""
        with self.lock:
            return [self._entries[k].record for k in reversed(self._order)]

    def clear(self) -> None:
        with self.lock:
            self._order.clear()
            self._entries.clear()
            self._bytes = 0
