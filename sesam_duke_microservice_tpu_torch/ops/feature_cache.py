"""Digest-keyed feature-row cache: re-extraction of unchanged records is
free (a copy of the JAX package's ``ops/feature_cache.py``).

A Sesam full resync re-POSTs whole datasets of mostly unchanged entities.
The corpus is append-only with re-upserts tombstoned (engine.device_matcher),
so the index side of a re-upsert is cheap, but every appended row re-runs
the per-record host extraction (``ops.features.extract_batch``) even when
its bytes did not change.

This module caches extracted feature ROWS keyed by

    (record content digest, feature-plan fingerprint)

where the digest is ``core.records.record_digest`` (SHA-256 over the id
and the canonical JSON of the values, the JAX package's store digest byte
for byte) and the fingerprint covers everything that shapes or
parameterizes extraction: per-property kind, value-slot width, char
width, comparator class (and its ``q``), the global gram / token widths,
the char-tensor dtype, and the ``ann`` encoder (dim, props, storage
layout, C++ or numpy route) when one rides along.  Value-slot widening,
char-width growth, long-text demotion and schema changes all change the
fingerprint, so stale rows never scatter into a corpus built under
another plan.

Budget: ``DUKE_FEATURE_CACHE_MB`` bounds the cached tensor bytes with LRU
eviction.  Default 0, off: with the C++ extraction, the record digest
every fresh record pays on the miss path costs more than the hit path
saves, and a resync of unchanged records ran no faster with the cache on
than off (PERF.md, "the pool's and the cache's defaults").  The JAX
package's default budget is 256.

Consumers: ``ops.features.extract_batch`` consults the cache for every
batch -- corpus appends, plan-growth rebuilds and query-side extraction --
so each hits when its plan matches the plan the rows were cached under.
``prewarm`` seeds the cache from restored corpus tensors; it waits for
the port's snapshot load (none yet).

Storage: each row is ONE bytes object, its tensors' bytes in a layout
kept once per fingerprint, so a batch packs and unpacks with a handful of
numpy operations instead of one small array per row and tensor (the JAX
package's per-row dicts cost more than the C++ extraction they save).

Thread safety: one lock around the LRU map (workloads extract on their
own threads).
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..env import env_int

DEFAULT_MB = 0

# per-entry bookkeeping overhead (key bytes, dict-of-dict structure) added
# to the tensor bytes so the budget tracks real memory, not just payload
_ENTRY_OVERHEAD = 256

RowDict = Dict[str, Dict[str, np.ndarray]]
# ((property, tensor, per-row shape, dtype, byte start, byte stop), ...)
Layout = Tuple[tuple, ...]


class FeatureCache:
    """Byte-budgeted LRU of extracted feature rows."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        self._rows: "collections.OrderedDict[tuple, Tuple[bytes, int]]" = (
            collections.OrderedDict()  # guarded by: self._lock
        )
        self._layouts: Dict[tuple, Layout] = {}  # guarded by: self._lock
        self.bytes = 0  # guarded by: self._lock [writes]
        # monotonic, written under self._lock; ``stats()`` reads them
        # lock-free (a torn read of a plain int is fine for a counter)
        self.hits = 0  # guarded by: self._lock [writes]
        self.misses = 0  # guarded by: self._lock [writes]
        self.evicted = 0  # guarded by: self._lock [writes]

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def layout(self, fp) -> Optional[Layout]:
        with self._lock:
            return self._layouts.get(fp)

    def get_many(self, fp, digests: Sequence[Optional[bytes]]
                 ) -> Dict[int, bytes]:
        """Look up a batch; returns ``{batch_index: packed row}`` for the
        hits (``layout(fp)`` unpacks them).

        ``None`` digests (records without an ID, foreign record-likes)
        always miss and are counted as misses — they are rows the cache
        cannot help with, which is exactly what the hit ratio should say.
        """
        out: Dict[int, bytes] = {}
        with self._lock:
            for i, digest in enumerate(digests):
                if digest is None:
                    continue
                entry = self._rows.get((fp, digest))
                if entry is not None:
                    self._rows.move_to_end((fp, digest))
                    out[i] = entry[0]
            self.hits += len(out)
            self.misses += len(digests) - len(out)
        return out

    def put_packed(self, fp, layout: Layout,
                   items: Iterable[Tuple[bytes, bytes]]) -> None:
        """Insert packed rows of ``layout``; evicts LRU past the byte
        budget."""
        with self._lock:
            self._layouts.setdefault(fp, layout)
            for digest, row in items:
                nbytes = _ENTRY_OVERHEAD + len(row)
                if nbytes > self.budget_bytes:
                    continue  # a single over-budget row would only thrash
                key = (fp, digest)
                old = self._rows.pop(key, None)
                if old is not None:
                    self.bytes -= old[1]
                self._rows[key] = (row, nbytes)
                self.bytes += nbytes
            while self.bytes > self.budget_bytes and self._rows:
                _, (_, nbytes) = self._rows.popitem(last=False)
                self.bytes -= nbytes
                self.evicted += 1

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()
            self._layouts.clear()
            self.bytes = 0


_CACHE: Optional[FeatureCache] = None
_CACHE_MB: Optional[int] = None
_CACHE_LOCK = threading.Lock()


def budget_mb() -> int:
    return env_int("DUKE_FEATURE_CACHE_MB", DEFAULT_MB)


def active() -> Optional[FeatureCache]:
    """The process-wide cache, or None when disabled.  Re-reads the env
    budget on every call (cheap) so tests can flip it live; a budget
    change replaces the cache (operators never change env mid-process)."""
    global _CACHE, _CACHE_MB
    mb = budget_mb()
    if mb <= 0:
        return None
    with _CACHE_LOCK:
        if _CACHE is None or _CACHE_MB != mb:
            _CACHE = FeatureCache(mb << 20)
            _CACHE_MB = mb
        return _CACHE


def reset() -> None:
    """Drop the process-wide cache (tests)."""
    global _CACHE, _CACHE_MB
    with _CACHE_LOCK:
        _CACHE = None
        _CACHE_MB = None


def stats() -> Tuple[int, int, int, int]:
    """(hits, misses, evicted_rows, bytes) of the active cache — zeros when
    disabled.  Lock-free snapshot reads."""
    cache = _CACHE if budget_mb() > 0 else None
    if cache is None:
        return (0, 0, 0, 0)
    return (cache.hits, cache.misses, cache.evicted, cache.bytes)


# -- keys ---------------------------------------------------------------------


def plan_fingerprint(plan, encoder=None) -> tuple:
    """Everything that parameterizes extraction for ``plan``.

    Covers each field of ``ops.features.PropertyFeatureSpec`` that shapes
    a tensor (name, kind, value slots, char width, comparator class and
    QGram's ``q``; PHONETIC's class picks Soundex / Metaphone / Norphone
    codes), the global gram / token widths and char dtype, and the
    encoder's dim, properties, storage layout and route (C++ or numpy:
    their embeddings differ in the last f32 bit).  Deliberately EXCLUDES
    the low / high probabilities: they shape scoring, not the extracted
    tensors, so a reload that only retunes them reuses every cached row.
    """
    from . import features as F

    specs = tuple(
        (s.name, s.kind, int(s.values_per_record), int(s.chars),
         type(s.comparator).__name__, getattr(s.comparator, "q", None))
        for s in plan.device_props
    )
    enc = None
    if encoder is not None:
        from . import embedding as E

        enc = (int(encoder.dim), tuple(encoder.props),
               getattr(encoder, "storage", None) or E.storage_name(),
               "numpy" if E._native_embed() is None else "c++")
    return (specs, F.MAX_GRAMS, F.MAX_TOKENS,
            str(np.dtype(F.CHAR_DTYPE)), enc)


def record_key(record) -> Optional[bytes]:
    """Canonical content digest for ``record``, or None when the record
    cannot be keyed (no ID / foreign record-like) — such rows extract
    directly and are never cached."""
    from ..core.records import record_digest

    try:
        if record.record_id is None:
            return None
        return record_digest(record)
    except (AttributeError, ValueError, TypeError):
        return None


# -- batch assembly -----------------------------------------------------------


def _layout(feats: RowDict) -> Layout:
    """The packed-row layout of batch tensors."""
    out, at = [], 0
    for prop, tensors in feats.items():
        for name, arr in tensors.items():
            shape = tuple(arr.shape[1:])
            size = int(np.prod(shape, dtype=np.int64)) * arr.dtype.itemsize
            out.append((prop, name, shape, arr.dtype.str, at, at + size))
            at += size
    return tuple(out)


def _pack(feats: RowDict, idx: np.ndarray) -> List[bytes]:
    """Rows ``idx`` of batch tensors, each one bytes object in
    ``_layout(feats)`` order."""
    k = len(idx)
    mat = np.concatenate(
        [np.ascontiguousarray(arr[idx]).reshape(k, -1).view(np.uint8)
         for tensors in feats.values() for arr in tensors.values()], axis=1)
    return [row.tobytes() for row in mat]


def _unpack(layout: Layout, rows: Sequence[bytes]) -> RowDict:
    """Packed rows -> batch tensors (fresh, writable arrays)."""
    k = len(rows)
    buf = np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(k, -1)
    out: RowDict = {}
    for prop, name, shape, dtype, start, stop in layout:
        col = np.ascontiguousarray(buf[:, start:stop])
        out.setdefault(prop, {})[name] = col.view(np.dtype(dtype)).reshape(
            (k,) + shape)
    return out


def cached_extract(cache: FeatureCache, plan, records, *,
                   encoder=None) -> RowDict:
    """``features.extract_batch`` semantics through the cache: hits scatter
    from cached rows, misses extract through the normal path (including
    the shared-memory parallel fan-out when the miss slab qualifies) and
    are inserted for the next sync."""
    from . import features as F

    if not records:
        return F._extract_direct(plan, records, encoder=encoder)
    n = len(records)
    fp = plan_fingerprint(plan, encoder)
    keys = [record_key(r) for r in records]
    hits = cache.get_many(fp, keys)
    miss_idx = [i for i in range(n) if i not in hits]

    miss_out = layout = None
    if miss_idx:
        miss_out = F._extract_direct(
            plan, [records[i] for i in miss_idx], encoder=encoder
        )
        # authoritative for this plan; a cached row of the same
        # fingerprint has the same layout by construction
        layout = _layout(miss_out)

    if not hits:
        out = miss_out  # no hits and records non-empty => all missed
    else:
        hit_idx = np.fromiter(sorted(hits), dtype=np.int64, count=len(hits))
        hit_out = _unpack(layout or cache.layout(fp),
                          [hits[int(i)] for i in hit_idx])
        if miss_out is None:
            out = hit_out  # every row hit, in batch order
        else:
            miss_arr = np.asarray(miss_idx, dtype=np.int64)
            out = {}
            for prop, tensors in miss_out.items():
                for name, arr in tensors.items():
                    dst = np.zeros((n,) + arr.shape[1:], dtype=arr.dtype)
                    dst[miss_arr] = arr
                    dst[hit_idx] = hit_out[prop][name]
                    out.setdefault(prop, {})[name] = dst

    if miss_out is not None:
        keyed = [j for j, i in enumerate(miss_idx) if keys[i] is not None]
        if keyed:
            rows = _pack(miss_out, np.asarray(keyed, dtype=np.int64))
            cache.put_packed(fp, layout, (
                (keys[miss_idx[j]], row) for j, row in zip(keyed, rows)))
    return out


# -- restart pre-warm ---------------------------------------------------------


def prewarm(plan, encoder, feats: RowDict, id_to_row: Dict[str, int],
            digest_iter: Iterable[Tuple[str, bytes]],
            cache: FeatureCache) -> int:
    """Seed the cache from restored corpus tensors (snapshot load).

    ``digest_iter`` yields (record_id, canonical digest), so no record
    decode happens here.  Stops at the byte budget: a 10M-row corpus
    warms only as many rows as the cache could ever hold anyway.
    Returns the number of rows warmed.
    """
    fp = plan_fingerprint(plan, encoder)
    layout = _layout(feats)
    warmed = 0
    batch: List[Tuple[bytes, int]] = []

    def flush() -> None:
        rows = _pack(feats, np.asarray([row for _, row in batch],
                                       dtype=np.int64))
        cache.put_packed(fp, layout, zip((d for d, _ in batch), rows))
        batch.clear()

    for rid, digest in digest_iter:
        if cache.bytes >= cache.budget_bytes:
            break
        row = id_to_row.get(rid)
        if row is None:
            continue
        batch.append((digest, row))
        warmed += 1
        if len(batch) >= 1024:
            flush()
    if batch:
        flush()
    return warmed
