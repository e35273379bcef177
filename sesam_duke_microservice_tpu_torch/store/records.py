"""Durable host-side record store -- the source of truth (a copy of the
JAX package's ``store/records.py``; the digest is ``core.records``'s).

The reference's durable record state is its on-disk Lucene index, opened in
APPEND mode so a restarted container resumes where it left off
(IncrementalLuceneDatabase.java:233-244; paths wired at App.java:331-341,
452-462).  Here records persist in a host SQLite table keyed by the
synthesized ``ID`` property; the device-resident corpus is a *rebuildable
cache* restored from the corpus snapshot or replayed from this store at
startup.  Re-putting an existing id replaces the previous row, matching
Lucene's delete-then-readd (IncrementalLuceneDatabase.java:507-517).
"""

from __future__ import annotations

import json
import sqlite3
import threading
from typing import Dict, Iterator, List, Optional, Sequence

from ..core.records import Record, record_digest, row_digest, serialize_record
from ..utils.sqlite import SqliteConnectionPool

_HASH_BYTES = 32


def xor_fold(a: bytes, b: bytes) -> bytes:
    """The content-hash combiner: order-independent XOR of two 32-byte
    digests (int-wide, ~10x the per-byte generator)."""
    return (int.from_bytes(a, "big") ^ int.from_bytes(b, "big")).to_bytes(
        _HASH_BYTES, "big"
    )


EMPTY_CONTENT_HASH = bytes(_HASH_BYTES)


class RecordStore:
    """Interface: durable map ``record_id -> Record`` with replay."""

    def put(self, record: Record) -> None:
        raise NotImplementedError

    def put_many(self, records: Sequence[Record]) -> None:
        for record in records:
            self.put(record)

    def get(self, record_id: str) -> Optional[Record]:
        raise NotImplementedError

    def all_records(self) -> Iterator[Record]:
        """Iterate every stored record in insertion (rowid) order."""
        raise NotImplementedError

    def count(self) -> int:
        raise NotImplementedError

    def content_hash(self) -> Optional[str]:
        """Order-independent digest of the store's full content, or None
        when the backend doesn't maintain one.  Durable backends keep it
        INCREMENTALLY (XOR of per-row digests, updated inside each write
        transaction) so the snapshot staleness guard costs O(1) at save
        and load instead of re-hashing the whole corpus."""
        return None

    def all_ids(self) -> Iterator[str]:
        """Every stored record id (no payload decode)."""
        for record in self.all_records():
            yield record.record_id

    def row_digests(self) -> Iterator[tuple]:
        """(record_id, canonical per-record digest) for every stored row —
        the same bytes ``record_digest`` yields for the live record, so a
        consumer can key caches by content without decoding records.
        Durable backends override to fold the raw stored serialization
        directly (the feature-cache snapshot pre-warm walks this at
        restart; a JSON decode per row would defeat the lazy restore)."""
        for record in self.all_records():
            yield record.record_id, record_digest(record)

    def close(self) -> None:
        pass


class LazyRecordMap:
    """Dict-like ``record_id -> Record`` view over a store, decoded on
    demand.

    The device index's host record mirror exists for host-exact
    finalization, feed resolution, and transforms — all of which touch a
    tiny, hot subset of records per request.  Materializing it eagerly
    decodes every stored JSON row into a Python Record on one core at
    restart, with memory linear in the corpus.  This map keeps only the id set in
    memory (~100 B/row) as the membership authority, decodes rows from
    SQLite on first touch, and holds every decoded/written record in a
    BOUNDED LRU — writes also land in the LRU (the store already has the
    row: the workload persists before indexing), so memory stays bounded
    for the process lifetime, not just across the restart.
    """

    _LRU_CAP = 200_000

    def __init__(self, store: RecordStore):
        import collections

        self._store = store
        self._ids = set(store.all_ids())
        self._lru: "collections.OrderedDict[str, Record]" = (
            collections.OrderedDict()
        )

    def _cache(self, rid: str, record: Record) -> None:
        self._lru[rid] = record
        self._lru.move_to_end(rid)
        if len(self._lru) > self._LRU_CAP:
            self._lru.popitem(last=False)

    def get(self, rid: str, default=None) -> Optional[Record]:
        if rid not in self._ids:
            # membership authority: a popped id must NOT resurrect from
            # the store row that may still exist there
            return default
        record = self._lru.get(rid)
        if record is not None:
            self._lru.move_to_end(rid)
            return record
        record = self._store.get(rid)
        if record is None:  # store raced ahead of _ids; treat as missing
            return default
        self._cache(rid, record)
        return record

    def __getitem__(self, rid: str) -> Record:
        record = self.get(rid)
        if record is None:
            raise KeyError(rid)
        return record

    def __setitem__(self, rid: str, record: Record) -> None:
        self._ids.add(rid)
        self._cache(rid, record)

    def pop(self, rid: str, default=None):
        record = self.get(rid, default)
        self._ids.discard(rid)
        self._lru.pop(rid, None)
        return record

    def discard(self, rid: str) -> None:
        """Remove without decoding (pop pays a store read just to return
        a value the lazy-mode delete path never uses)."""
        self._ids.discard(rid)
        self._lru.pop(rid, None)

    def __contains__(self, rid) -> bool:
        return rid in self._ids

    def __len__(self) -> int:
        return len(self._ids)

    def __iter__(self):
        return iter(self._ids)

    def keys(self):
        return iter(self._ids)

    def values(self):
        """Streaming decode in id order (memory-bounded by the LRU) —
        only rare bulk paths (value-slot rebuild) walk this."""
        for rid in list(self._ids):
            record = self.get(rid)
            if record is not None:
                yield record

    def bulk_values(self):
        """Corpus-scale streaming walk via the store's bulk cursor —
        ``values()`` pays one point SELECT per id, which turns a 10M-row
        walk (multi-host bootstrap streaming) into hours.  Rows whose id
        has been popped from the membership authority are skipped; the
        store is never BEHIND the map for live ids (the workload persists
        before indexing), so the cursor view is current."""
        for record in self._store.all_records():
            if record.record_id in self._ids:
                yield record

    def prefetch(self, rids) -> None:
        """Warm the LRU with a batch of ids in few store round trips —
        page-sized feed resolution would otherwise pay one SELECT per
        link endpoint under the workload lock.  Bounded: at most
        ``_LRU_CAP`` ids (beyond that, earlier entries would evict before
        use), fetched in chunks so no single call materializes an
        unbounded record dict."""
        want = [
            rid for rid in rids
            if rid in self._ids and rid not in self._lru
        ]
        if not want:
            return
        want = want[: self._LRU_CAP]
        get_many = getattr(self._store, "get_many", None)
        if get_many is None:
            return  # per-id gets will serve (in-memory stores are cheap)
        for start in range(0, len(want), 10_000):
            for rid, record in get_many(want[start:start + 10_000]).items():
                self._cache(rid, record)


class InMemoryRecordStore(RecordStore):
    """Non-durable store; the counterpart of Lucene's RAMDirectory fallback
    (IncrementalLuceneDatabase.java:218-231, used when no path is set)."""

    def __init__(self):
        self._records: Dict[str, Record] = {}
        self._lock = threading.Lock()

    def put(self, record: Record) -> None:
        rid = record.record_id
        if rid is None:
            raise ValueError("record has no ID property")
        with self._lock:
            # preserve replay order on replace, like a rowid reinsert
            self._records.pop(rid, None)
            self._records[rid] = record

    def get(self, record_id: str) -> Optional[Record]:
        with self._lock:
            return self._records.get(record_id)

    def all_records(self) -> Iterator[Record]:
        with self._lock:
            snapshot = list(self._records.values())
        return iter(snapshot)

    def count(self) -> int:
        with self._lock:
            return len(self._records)


class SqliteRecordStore(RecordStore):
    """SQLite-backed durable store (one row per record, JSON payload).

    WAL mode so the single-writer/concurrent-reader discipline of the
    service layer (one lock per workload, readers with 1 s timeout —
    App.java:96,145,718-725) maps cleanly onto SQLite's locking.
    """

    def __init__(self, path: str):
        self.path = path
        self._pool = SqliteConnectionPool(path)
        self._hash_lock = threading.Lock()
        with self._conn() as conn:
            conn.execute(
                "CREATE TABLE IF NOT EXISTS records ("
                " id TEXT PRIMARY KEY,"
                " data TEXT NOT NULL)"
            )
            conn.execute(
                "CREATE TABLE IF NOT EXISTS meta ("
                " key TEXT PRIMARY KEY,"
                " value TEXT NOT NULL)"
            )
        self._hash = self._load_or_build_hash()

    def _load_or_build_hash(self) -> bytes:
        conn = self._conn()
        row = conn.execute(
            "SELECT value FROM meta WHERE key = 'content_hash'"
        ).fetchone()
        if row is not None:
            return bytes.fromhex(row[0])
        # one-time migration for stores created before the incremental
        # hash existed: fold every existing row, then persist
        acc = bytes(_HASH_BYTES)
        for rid, data in conn.execute("SELECT id, data FROM records"):
            acc = xor_fold(acc, row_digest(rid, data))
        with conn:
            conn.execute(
                "INSERT OR REPLACE INTO meta (key, value) VALUES "
                "('content_hash', ?)", (acc.hex(),),
            )
        return acc

    def _conn(self) -> sqlite3.Connection:
        return self._pool.conn()

    @staticmethod
    def _encode(record: Record) -> tuple:
        rid = record.record_id
        if rid is None:
            raise ValueError("record has no ID property")
        return rid, serialize_record(record)

    def put(self, record: Record) -> None:
        self.put_many([record])

    def put_many(self, records: Sequence[Record]) -> None:
        # duplicate ids within a batch resolve to the last occurrence
        # (REPLACE semantics); dedupe up front so the hash folds each id
        # exactly once
        by_id = {}
        rec_by_id = {}
        for r in records:
            rid, data = self._encode(r)
            by_id[rid] = data
            rec_by_id[rid] = r
        rows = list(by_id.items())
        if not rows:
            return
        conn = self._conn()
        with self._hash_lock, conn:
            # fold out the rows being replaced, fold in the new ones —
            # the running hash and the rows commit in ONE transaction so
            # a crash can never leave them out of sync
            acc = self._hash
            ids = [rid for rid, _ in rows]
            for start in range(0, len(ids), 450):  # host-parameter cap
                chunk = ids[start:start + 450]
                marks = ",".join("?" * len(chunk))
                for rid, data in conn.execute(
                    f"SELECT id, data FROM records WHERE id IN ({marks})",
                    chunk,
                ):
                    acc = xor_fold(acc, row_digest(rid, data))
            for rid, data in rows:
                digest = row_digest(rid, data)
                acc = xor_fold(acc, digest)
                # seed the record's memo: the index folds the same digest
                # right after this put (engine.device_matcher); safe
                # because the row data IS serialize_record(record)
                record = rec_by_id[rid]
                if type(record) is Record:
                    record._digest_cache = digest
            # REPLACE deletes-then-inserts under the hood, assigning a fresh
            # rowid so replay order tracks last write — mirroring Lucene's
            # delete-then-readd on reindex; one transaction per batch
            conn.executemany(
                "INSERT OR REPLACE INTO records (id, data) VALUES (?, ?)",
                rows,
            )
            conn.execute(
                "INSERT OR REPLACE INTO meta (key, value) VALUES "
                "('content_hash', ?)", (acc.hex(),),
            )
            self._hash = acc

    def content_hash(self) -> str:
        with self._hash_lock:
            return self._hash.hex()

    def all_ids(self) -> Iterator[str]:
        for (rid,) in self._conn().execute("SELECT id FROM records"):
            yield rid

    def row_digests(self) -> Iterator[tuple]:
        # raw rows, no JSON decode: the stored payload IS
        # serialize_record(record), so _row_digest over it is
        # byte-identical to record_digest of the live record
        for rid, data in self._conn().execute(
            "SELECT id, data FROM records"
        ):
            yield rid, row_digest(rid, data)

    def get(self, record_id: str) -> Optional[Record]:
        row = self._conn().execute(
            "SELECT data FROM records WHERE id = ?", (record_id,)
        ).fetchone()
        return self._decode(row[0]) if row else None

    def get_many(self, record_ids) -> Dict[str, Record]:
        """Batched lookup (one query per 450-id chunk) — the feed's page
        resolution touches up to 2 x page_size records at once."""
        ids = [rid for rid in record_ids]
        out: Dict[str, Record] = {}
        conn = self._conn()
        for start in range(0, len(ids), 450):  # host-parameter cap
            chunk = ids[start:start + 450]
            marks = ",".join("?" * len(chunk))
            for rid, data in conn.execute(
                f"SELECT id, data FROM records WHERE id IN ({marks})", chunk
            ):
                out[rid] = self._decode(data)
        return out

    def all_records(self) -> Iterator[Record]:
        for (data,) in self._conn().execute(
            "SELECT data FROM records ORDER BY rowid"
        ):
            yield self._decode(data)

    def count(self) -> int:
        return self._conn().execute("SELECT COUNT(*) FROM records").fetchone()[0]

    def close(self) -> None:
        self._pool.close()

    @staticmethod
    def _decode(data: str) -> Record:
        values: Dict[str, List[str]] = json.loads(data)
        return Record(values)
