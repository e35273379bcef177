"""Durable host-side record store (a copy of the JAX package's ``store``).

Records persist in a host SQLite store, the source of truth; the device
corpus is a rebuildable cache restored from its snapshot or replayed from
the store at startup.
"""

from .records import InMemoryRecordStore, RecordStore, SqliteRecordStore

__all__ = ["InMemoryRecordStore", "RecordStore", "SqliteRecordStore"]
