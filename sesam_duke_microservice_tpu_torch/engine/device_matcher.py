"""The brute-force device backend: device-resident corpus + batched scoring.

Counterpart of the JAX package's ``engine/device_matcher.py``: the whole
corpus lives on the device as padded feature tensors (``ops.features``),
the blockwise scorer (``ops.scoring.build_corpus_scorer``) scores every
query against every corpus row in chunks keeping a running top-K, the dd
rescorer (``ops.scoring.dd_rescorer``) re-scores a block's survivors in
double-double when one of them could be a certified reject, and the host
finalizes the surviving K pairs per query (``engine.finalize``).

Semantics contract (held to the JAX backend by tests/test_torch_slice.py):

  * exact brute-force blocking, candidates above the survivor bound;
  * multi-valued properties score all value pairs: the value axis sizes to
    the data (capped by ``DEVICE_VALUE_SLOTS_MAX``);
  * char widths grow per property in powers of two; past
    ``DEVICE_DEMOTE_CHARS`` a property demotes to the host-scored side;
  * K-escalation keeps the top-K exact: if any query had more candidates
    above the bound than K, the block re-runs with doubled K.

The ``ann`` backend (``engine.ann_matcher``) reuses the corpus, the block
pipeline and the processor with its own scoring program and escalation
predicate.

Mutation model: the corpus is append-only with tombstone masks.  Re-indexing
an id tombstones the old row and appends a new one; deleted records stay
resolvable by id (the feed needs them) but carry a deleted bit that keeps
them out of scoring.  Capacity doubles in ``DEVICE_CHUNK`` granules, from
``DEVICE_INITIAL_CAPACITY`` rows when that is set.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..core.config import DukeSchema
from ..core.records import GROUP_NO_PROPERTY_NAME, Record, SchemaError
from ..env import env_flag, env_int, env_int_tuple, env_str
from ..index.base import CandidateIndex
from ..ops import bounds as B
from ..ops import encoder as E
from ..ops import features as F
from ..ops import scoring as S
from ..store.records import (
    EMPTY_CONTENT_HASH,
    LazyRecordMap,
    record_digest,
    xor_fold,
)
from ..telemetry import PhaseRecorder, costs, tracing
from ..utils import faults
from ..utils.atomicio import replace_and_sync_dir
from ..utils.profiling import trace_armed, trace_batch
from .finalize import FinalizeExecutor
from .listeners import MatchListener
from .processor import (
    PHASE_ENCODE,
    PHASE_PERSIST,
    PHASE_RETRIEVE,
    PHASE_SCORE,
    Processor,
    ProfileStats,
)

logger = logging.getLogger("device-matcher")

# Query blocks are padded to these sizes; blocks larger than the last one
# are split.  Same knobs and defaults as the JAX package.
_QUERY_BUCKETS = env_int_tuple("DEVICE_QUERY_BUCKETS", "16,128,1024,2048,4096")
_CHUNK = env_int("DEVICE_CHUNK", 8192)
# incremental device-update slices of the streamed append, independent of
# the scan chunk: a steady-state commit of a few hundred rows must not pay
# a chunk-sized transfer
_UPDATE_SLICE = env_int("DEVICE_UPDATE_SLICE", 512)
_INITIAL_TOP_K = env_int("DEVICE_TOP_K", 64)
# value-slot auto-growth cap (pair scoring is O(V^2) combos per property)
_VALUE_SLOTS_MAX = env_int("DEVICE_VALUE_SLOTS_MAX", 8)
# per-property char widths double to fit the data up to the cap; past the
# demotion width a property moves to host scoring (0 disables demotion)
_CHARS_CAP = env_int("DEVICE_MAX_CHARS_CAP", 1024)
_DEMOTE_CHARS = env_int("DEVICE_DEMOTE_CHARS", 256)
# a restored corpus this small is copied to the device at its first use,
# not on a background thread (the JAX package's threshold)
_WARM_UPLOAD_MIN_ROWS = 65536


def query_buckets() -> tuple:
    return _QUERY_BUCKETS


def bucket_for(n: int) -> int:
    """Padded query-block size for an ``n``-record batch."""
    for b in _QUERY_BUCKETS:
        if n <= b:
            return b
    return _QUERY_BUCKETS[-1]


# Pre-resolved registry children: the padding ladder is a closed set, so
# per-bucket children resolve once at import and the scoring path writes
# plain single-writer child counters with no family-lock lookup per block.
_BUCKET_CHILDREN = {
    b: (telemetry.QUERY_BLOCKS.labels(bucket=str(b)),
        telemetry.QUERY_PAD_ROWS.labels(bucket=str(b)))
    for b in _QUERY_BUCKETS
}
_STREAM_SLICES_CHILD = telemetry.STREAM_APPEND_SLICES.single()


def _stream_append_slice(n: int) -> Optional[int]:
    """Slice size for the streamed extract -> upload append, or None for
    the whole-batch path (small batches have nothing to overlap).

    ``DUKE_STREAM_APPEND=0`` pins the whole-batch behavior.  When the full
    batch qualifies for the shared-memory parallel extractor, slices grow
    to its minimum slab so every slice still rides the process pool.
    """
    if not env_flag("DUKE_STREAM_APPEND", True):
        return None
    slice_n = _UPDATE_SLICE
    from ..ops import parallel_extract as PX

    if PX.enabled(n):
        slice_n = max(slice_n, PX.min_records())
    return slice_n if n > slice_n else None


# bytes handed host -> device through ``_to_device``, per thread: a
# workload's pass runs on one thread, which reads its own running count
# around each phase (``h2d_bytes``), so the count needs no lock
_H2D = threading.local()


def h2d_bytes() -> int:
    """The running count of bytes this thread has queued host to device
    through ``_to_device`` (callers take differences).  On the CPU the
    same tensors are handed over without a copy and still count."""
    return getattr(_H2D, "n", 0)


def _to_device(arr: np.ndarray, device: torch.device,
               prop: str = None) -> torch.Tensor:
    """Host mirror -> device tensor; uint16 chars widen to int32 here,
    while the uint16 bf16 bit patterns of the embeddings (``prop`` is
    ``ANN_PROP``) are reinterpreted as ``torch.bfloat16``.  Non-blocking: a
    pageable source is staged by the copy call itself, and a blocking copy
    would synchronize the stream behind queued scoring."""
    if arr.dtype == np.uint16 and prop == E.ANN_PROP:
        src = np.ascontiguousarray(arr).view(np.int16)
        _H2D.n = h2d_bytes() + src.nbytes
        return torch.from_numpy(src).to(
            device, non_blocking=True).view(torch.bfloat16)
    if arr.dtype == np.uint16:
        arr = arr.astype(np.int32)
    src = np.ascontiguousarray(arr)
    _H2D.n = h2d_bytes() + src.nbytes
    return torch.from_numpy(src).to(device, non_blocking=True)


def _device_clock(device: torch.device):
    """A timing event recorded now on the current stream when ``device``
    is a card, else None: it reads the card's clock as the stream reaches
    it, so the interval to a later event is the device time of the work
    queued between them, including any gap in which the card waited for
    the host's next launch.  Recording adds no synchronization."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _elapsed_seconds(start, end) -> float:
    """Seconds between two timing events that have completed (after a
    synchronization the caller already made), 0 without them."""
    if start is None or end is None:
        return 0.0
    return start.elapsed_time(end) / 1e3


def _grow_1d(arr: np.ndarray, cap: int, fill) -> np.ndarray:
    out = np.full((cap,), fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _grow_nd(arr: np.ndarray, cap: int) -> np.ndarray:
    # grown rows are zero-filled; they stay row_valid=False until append()
    # overwrites them, so they are never read unmasked
    out = np.zeros((cap,) + arr.shape[1:], dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


class DeviceCorpus:
    """Host numpy mirror + torch tensors on ``device`` for one workload's
    indexed records.  Rows are append-only; ``row_valid`` clears on
    tombstone.  The device copy is refreshed lazily: appended ranges and
    tombstones are copied incrementally, a capacity change re-uploads."""

    def __init__(self, plan, device):
        self.plan = plan  # the feature plan whose tensors the rows hold
        self.device = torch.device(device)
        self.granule = _CHUNK
        # pre-sized capacity: read per corpus, so one process can pre-size
        # one workload and not another
        self.initial_capacity = env_int("DEVICE_INITIAL_CAPACITY", 0)
        self.capacity = 0
        self.size = 0
        self.live_rows = 0
        self.feats: Dict[str, Dict[str, np.ndarray]] = {}
        self.row_valid = np.zeros((0,), dtype=bool)
        self.row_deleted = np.zeros((0,), dtype=bool)
        self.row_group = np.full((0,), -1, dtype=np.int32)
        self.row_ids: List[Optional[str]] = []
        self._device_feats = None
        self._device_masks = None
        self._dirty_full = True
        self._pending_rows: Optional[Tuple[int, int]] = None  # appended
        self._mask_rows: List[int] = []                        # tombstones
        # serializes the host-mirror mutators (append, tombstone) with
        # device_arrays: a restart's warm upload runs on its own thread
        # (DeviceIndex.warm_upload_async), outside the workload lock, so a
        # writer or the first query that meets a half-uploaded mirror
        # waits here for it instead of dropping rows or reading stale ones
        self._upload_lock = threading.Lock()
        # the warm upload's failure, raised by the next device_arrays: a
        # device error during a restore is never a quiet fallback
        self.warm_error: Optional[BaseException] = None
        # arena identity: the owning workload stamps its label and heat;
        # device_arrays admits through ops.arena under these before every
        # upload (no-ops under DUKE_ARENA=0)
        self.arena_label = ""
        self.arena_heat: Optional[object] = None

    @classmethod
    def from_numpy(cls, plan, feats: Dict[str, Dict[str, np.ndarray]],
                   valid: np.ndarray, deleted: np.ndarray,
                   group: np.ndarray, device) -> "DeviceCorpus":
        """Build a corpus from host mirror arrays (e.g. the JAX package's
        ``DeviceCorpus.feats``/``row_valid``/``row_deleted``/``row_group``),
        so both scorers can run on one identical corpus."""
        n = int(valid.shape[0])
        corpus = cls(plan, device)
        corpus.feats = {
            prop: {name: np.asarray(arr)[:n] for name, arr in t.items()}
            for prop, t in feats.items()
        }
        corpus.row_valid = np.asarray(valid, dtype=bool)[:n].copy()
        corpus.row_deleted = np.asarray(deleted, dtype=bool)[:n].copy()
        corpus.row_group = np.asarray(group, dtype=np.int32)[:n].copy()
        corpus.row_ids = [None] * n
        corpus.size = n
        corpus._grow(n)
        corpus.live_rows = int((corpus.row_valid & ~corpus.row_deleted).sum())
        return corpus

    # -- growth --------------------------------------------------------------

    def _grow(self, needed: int) -> None:
        g = self.granule
        cap = max(self.capacity, g)
        if self.initial_capacity > 0:  # rounded up to the granule
            cap = max(cap, -(-self.initial_capacity // g) * g)
        while cap < needed:
            cap *= 2
        if cap == self.capacity:
            return
        if self.capacity > 0:
            # a doubling of an existing corpus: the next device_arrays
            # call re-uploads everything
            telemetry.CORPUS_GROWTHS.inc()
        self.row_valid = _grow_1d(self.row_valid, cap, False)
        self.row_deleted = _grow_1d(self.row_deleted, cap, False)
        self.row_group = _grow_1d(self.row_group, cap, -1)
        for prop, tensors in self.feats.items():
            self.feats[prop] = {
                name: _grow_nd(arr, cap) for name, arr in tensors.items()
            }
        self.capacity = cap
        self._dirty_full = True

    def append(self, feats: Dict[str, Dict[str, np.ndarray]],
               deleted: np.ndarray, group: np.ndarray,
               ids: Sequence[str]) -> np.ndarray:
        """Append N rows; returns their row indices."""
        n = len(ids)
        if n == 0:
            return np.zeros((0,), dtype=np.int64)
        with self._upload_lock:
            return self._append_locked(feats, deleted, group, ids)

    def _append_locked(self, feats, deleted, group, ids) -> np.ndarray:
        n = len(ids)
        if not self.feats:
            # the first append defines per-property tensor shapes
            self.feats = {
                prop: {
                    name: np.zeros((0,) + arr.shape[1:], dtype=arr.dtype)
                    for name, arr in tensors.items()
                }
                for prop, tensors in feats.items()
            }
        self._grow(self.size + n)
        lo, hi = self.size, self.size + n
        for prop, tensors in feats.items():
            for name, arr in tensors.items():
                self.feats[prop][name][lo:hi] = arr
        self.row_valid[lo:hi] = True
        self.row_deleted[lo:hi] = deleted
        self.row_group[lo:hi] = group
        self.row_ids.extend(ids)
        self.live_rows += int(n - np.asarray(deleted, dtype=bool).sum())
        self.size = hi
        if not self._dirty_full:
            start = lo if self._pending_rows is None else self._pending_rows[0]
            self._pending_rows = (start, hi)
        return np.arange(lo, hi)

    def tombstone(self, row: int) -> None:
        with self._upload_lock:
            if self.row_valid[row] and not self.row_deleted[row]:
                self.live_rows -= 1
            self.row_valid[row] = False
            self._mask_rows.append(int(row))

    def reserve(self, total_rows: int) -> None:
        """Pre-grow capacity to fit ``total_rows`` ahead of a sliced
        append: a capacity doubling mid-stream would set ``_dirty_full``
        and turn every remaining slice flush into a no-op (the whole
        corpus re-uploads at scoring time instead).  No-op before the
        first append -- tensor shapes are defined by the first batch."""
        with self._upload_lock:
            if self.feats and total_rows > self.capacity:
                self._grow(total_rows)

    def stream_flush(self) -> bool:
        """Streamed append: copy the rows appended so far to the device
        (the incremental branch of ``device_arrays``), so slice N's copy
        is queued before the host extracts slice N+1.  The copies are
        ``non_blocking`` from pageable host memory, so the host still
        stages each one; what the slices save is the whole-batch copy at
        scoring time.

        No-op (returns False) while a full upload is pending (cold
        corpus, capacity growth, restored snapshot, released or spilled
        device copy): re-running the whole-corpus upload per slice would
        multiply the transfer, and the scoring-time ``device_arrays``
        pays it exactly once instead.  A corpus the arena spilled keeps
        the slice's rows on the host (the spill left it dirty), so the
        next query faults the whole corpus back in.
        """
        if self._device_feats is None or self._dirty_full:
            return False  # racy pre-check: spares a pointless admission
        self._admit()
        with self._upload_lock:
            if self._device_feats is None or self._dirty_full:
                return False  # spilled between the check and the lock
            self._device_arrays_locked()
            return True

    # -- arena residency -----------------------------------------------------

    def _device_nbytes(self) -> int:
        """Device footprint of the corpus tensors, from the host mirrors'
        shapes: uint16 char units widen to int32 on the device (the
        embeddings' uint16 bf16 bit patterns do not), every other tensor
        keeps its width -- so this equals ``device_bytes()``'s total once
        uploaded.  Lock-free torn reads tolerated: the arena re-admits at
        the settled size on the next call."""
        total = 0
        for prop, tensors in list(self.feats.items()):
            for arr in list(tensors.values()):
                widen = arr.dtype == np.uint16 and prop != E.ANN_PROP
                total += int(arr.nbytes) * (2 if widen else 1)
        for arr in (self.row_valid, self.row_deleted, self.row_group):
            total += int(arr.nbytes)
        return total

    def _admit(self) -> None:
        """Lease this corpus' device residency from the shared arena
        (``ops.arena``): may spill colder tenants, and raises
        ``ArenaAdmissionError`` when the budget cannot fit this corpus.
        Call OUTSIDE the upload lock (the arena's lock is outer)."""
        from ..ops.arena import ARENA

        ARENA.admit(self, self._device_nbytes(), spill=self.spill_device,
                    label=self.arena_label, heat=self.arena_heat)

    def spill_device(self) -> int:
        """Drop the device tensors to the host tier: an arena eviction,
        or a closed workload's corpus (``DeviceIndex.close``: a reload
        builds the replacement's tensors before the old one closes).

        Takes the upload lock -- the arena's lock is OUTER to it (lock
        order in ops.arena), so a spill waits out any in-flight upload or
        slice flush.  The numpy host mirrors stay authoritative; the
        owner's next query re-admits and faults the corpus back in
        through the full upload.  Every reference the corpus holds goes,
        so the caching allocator gets the blocks back once the in-flight
        scoring that still holds them (if any) finishes.  Returns the
        freed byte estimate."""
        with self._upload_lock:
            freed = (self._device_nbytes()
                     if self._device_feats is not None else 0)
            self._device_feats = None
            self._device_masks = None
            self._dirty_full = True
            self._pending_rows = None
            self._mask_rows = []
            return freed

    # -- device mirror -------------------------------------------------------

    def device_arrays(self):
        """(feats, valid, deleted, group) as tensors on ``self.device``;
        waits for an in-flight warm upload.  Residency is leased from the
        shared arena FIRST, outside the upload lock: admission may spill
        colder tenants and raises ``ops.arena.ArenaAdmissionError`` (a
        503, never an allocator OOM) when the budget cannot fit this
        corpus."""
        self._admit()
        with self._upload_lock:
            if self.warm_error is not None:
                raise RuntimeError(
                    "the warm corpus upload failed") from self.warm_error
            return self._device_arrays_locked()

    def _device_arrays_locked(self):
        if self._device_feats is None or self._dirty_full:
            telemetry.CORPUS_FULL_UPLOADS.inc()
            self._upload_full()
            self._dirty_full = False
            self._pending_rows = None
            self._mask_rows = []
        else:
            if self._pending_rows is not None:
                (lo, hi), self._pending_rows = self._pending_rows, None
                self._upload_rows(lo, hi)
            if self._mask_rows:
                rows, self._mask_rows = self._mask_rows, []
                self._upload_mask_rows(rows)
        return self._arrays()

    # The three copies below and ``_arrays`` are the device layout; the
    # record-axis-sharded corpus (engine.sharded_matcher) overrides them to
    # route each row to the shard that owns it.

    def _upload_full(self) -> None:
        self._device_feats = {
            prop: {name: _to_device(arr, self.device, prop)
                   for name, arr in tensors.items()}
            for prop, tensors in self.feats.items()
        }
        self._device_masks = tuple(
            _to_device(arr, self.device)
            for arr in (self.row_valid, self.row_deleted, self.row_group))

    def _upload_rows(self, lo: int, hi: int) -> None:
        """Copy the appended host rows ``[lo, hi)`` into the device
        tensors."""
        for prop, tensors in self.feats.items():
            for name, arr in tensors.items():
                self._device_feats[prop][name][lo:hi] = _to_device(
                    arr[lo:hi], self.device, prop)
        for dev, arr in zip(self._device_masks,
                            (self.row_valid, self.row_deleted,
                             self.row_group)):
            dev[lo:hi] = _to_device(arr[lo:hi], self.device)

    def _upload_mask_rows(self, rows: List[int]) -> None:
        """Copy the tombstoned rows' valid / deleted bits."""
        idx = _to_device(np.asarray(rows, dtype=np.int64), self.device)
        valid, deleted, _ = self._device_masks
        valid[idx] = _to_device(self.row_valid[rows], self.device)
        deleted[idx] = _to_device(self.row_deleted[rows], self.device)

    def _arrays(self):
        valid, deleted, group = self._device_masks
        return self._device_feats, valid, deleted, group

    def device_bytes(self) -> Dict[str, int]:
        """Bytes of the corpus tensors on the device, by the ledger's
        components: ``corpus_tensors`` (the property features and the
        valid / deleted / group row masks), and for ``ann`` the embedding
        tree (``corpus_embeddings``, and ``int8_scales`` under int8
        storage).  ``nbytes`` is a host read (no device sync); lock-free,
        so a scrape racing an upload may read the previous tensors."""
        out = {"corpus_tensors": 0, "corpus_embeddings": 0, "int8_scales": 0}
        _count_device_bytes(out, self._device_feats, self._device_masks)
        return out


def _count_device_bytes(out: Dict[str, int], feats, masks) -> None:
    """Add one device tree's and its masks' ``nbytes`` into the ledger
    components of ``out``."""
    for prop, tensors in list((feats or {}).items()):
        for name, t in list(tensors.items()):
            if prop == E.ANN_PROP:
                out["int8_scales" if name == E.ANN_SCALE
                    else "corpus_embeddings"] += t.nbytes
            else:
                out["corpus_tensors"] += t.nbytes
    for t in masks or ():
        out["corpus_tensors"] += t.nbytes


class DeviceIndex(CandidateIndex):
    """``CandidateIndex`` backed by the device-resident corpus.  Scoring
    goes through ``DeviceProcessor.deduplicate``, straight from the
    scorer's top-K to listener events."""

    def __init__(self, schema: DukeSchema, *, device):
        self.schema = schema
        self.device = torch.device(device)
        # char widths grow per property unless the operator pinned a
        # global width with DEVICE_MAX_CHARS
        self._auto_chars = env_str("DEVICE_MAX_CHARS") is None
        self.plan = F.SchemaFeatures.plan(schema, values_per_record=1)
        if not self.plan.device_props:
            raise SchemaError(
                "the device backend needs at least one comparison property "
                "with a device kernel (all configured comparators are "
                "host-only: "
                + ", ".join(sorted({type(p.comparator).__name__
                                    for p in self.plan.host_props}))
                + ")"
            )
        self.corpus = self._make_corpus(self.plan)
        # id -> latest record; a store-backed LazyRecordMap after a
        # snapshot restore (engine.workload)
        self.records: Dict[str, Record] = {}
        # running content digest of ``records`` (the record store's
        # formula): snapshot_save stamps it and snapshot_load compares the
        # store's, so an index/store divergence forces a replay.  With a
        # lazy mirror the fold is impossible (the store already holds the
        # new contents), so the workload stamps the store's hash after
        # each fully applied batch instead (mark_store_synced).
        self._content_hash = EMPTY_CONTENT_HASH
        self._store_synced_hash: Optional[str] = None
        # the serving group's mirror-consistency digest: a sha256 CHAIN
        # over every committed batch (record content + assigned row),
        # folded by commit() on the frontend and on every follower
        # replica alike, so the two agree when -- and only when -- they
        # applied the same mutations in the same order with the same row
        # layout.  Chained, not XOR-folded: a missed or doubled batch
        # must change it.  Compared after every commit of a group
        # (parallel.dispatch's digest handshake).
        self._mirror_digest = EMPTY_CONTENT_HASH
        self.id_to_row: Dict[str, int] = {}
        self.indexing_disabled = False
        self._pending: List[Record] = []
        self._lock = threading.Lock()
        self.scorer_cache = _ScorerCache(self)
        self._cap_warned: set = set()

    # -- CandidateIndex ------------------------------------------------------

    def index(self, record: Record) -> None:
        if self.indexing_disabled:
            return
        with self._lock:
            self._pending.append(record)

    def commit(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        # a serving group: the drained batch is exactly the corpus
        # mutation about to apply -- broadcast it so follower replicas
        # make the identical mutation (parallel.dispatch invariant 1).
        # The dispatcher tags the key on the frontend only; followers
        # and single-process runs skip.
        from ..parallel import dispatch

        key = getattr(self, "_dispatch_key", None)
        d = dispatch.current() if key is not None else None
        if d is not None:
            d.broadcast(dispatch.with_trace_ctx(("commit", key, pending)))
        # once broadcast, a local failure leaves followers one commit
        # AHEAD (a permanent mirror divergence): latch, then propagate
        with dispatch.latch_on_failure(
                d, "frontend commit failed after broadcast"):
            # last write per id wins within a batch (Duke re-index
            # semantics)
            by_id: Dict[str, Record] = {}
            for r in pending:
                by_id[r.record_id] = r
            records = list(by_id.values())
            self._maybe_grow_value_slots(records)
            for r in records:
                old = self.id_to_row.get(r.record_id)
                if old is not None:
                    self.corpus.tombstone(old)
            self._append_records(records)
            self._fold_mirror_digest(records)
        # every follower just replayed this batch through this code:
        # compare the chained digests, so an asymmetric failure evicts
        # that follower here instead of hanging a later collective
        if d is not None:
            d.verify_mirror_digest(key, self._mirror_digest)

    def _fold_mirror_digest(self, records: Sequence[Record]) -> None:
        """Chain one committed batch into the mirror-consistency digest:
        per record its canonical content digest and the corpus row it
        landed on (the row layout is what the collectives consume, so a
        layout divergence must change the digest too).  The JAX
        package's formula, byte for byte."""
        import hashlib
        import struct

        h = hashlib.sha256(self._mirror_digest)
        for r in records:
            h.update(record_digest(r))
            h.update(struct.pack("<q", self.id_to_row.get(r.record_id, -1)))
        self._mirror_digest = h.digest()

    def find_record_by_id(self, record_id: str) -> Optional[Record]:
        return self.records.get(record_id)

    def find_candidate_matches(self, record: Record,
                               group_filtering: bool = False) -> List[Record]:
        """Interface-parity path: scores one record against the corpus and
        returns every live record whose *device* probability clears
        ``min_relevance``-equivalent pruning.  The DeviceProcessor fast path
        bypasses this."""
        result = resolve_block(self.scorer_cache.dispatch_block(
            [record], group_filtering=group_filtering))
        out: List[Record] = []
        for _, row, _logit in result.survivor_triples(0):
            rid = self.corpus.row_ids[row]
            rec = self.records.get(rid)
            if rec is not None:
                out.append(rec)
        return out

    def delete(self, record: Record) -> None:
        """Drop a record from the index: its row is tombstoned (the
        incremental mask copy carries it to the device; the live count
        drops only for a row not already deleted) and its id leaves the
        mirror -- without a decode in lazy mode, whose content hash rides
        the store-synced stamp."""
        with self._lock:
            row = self.id_to_row.pop(record.record_id, None)
            if row is not None:
                self.corpus.tombstone(row)
            if isinstance(self.records, LazyRecordMap):
                self.records.discard(record.record_id)
            else:
                old = self.records.pop(record.record_id, None)
                if old is not None:
                    self._content_hash = xor_fold(
                        self._content_hash, record_digest(old)
                    )

    @property
    def live_records(self) -> int:
        """Live (non-dukeDeleted) indexed records, O(1) and lock-free for
        /stats and /metrics: every record id's latest row is valid, so
        the corpus' live-row count is the live-record count."""
        return self.corpus.live_rows

    def explain_retrieval(self, record: Record, candidate: Record,
                          group_filtering: bool = False) -> Dict:
        """Retrieval provenance: brute force scores every live
        corpus row, so the only ways a pair can fail to meet are corpus
        state (not indexed / tombstoned) and the candidate-mask policy
        (self-pair, same group) — the pair's actual f32 verdict and
        bounds ride the ``device`` section of the explanation
        (engine.explain.device_breakdown)."""
        out: Dict = {
            "mode": "device-brute",
            "exhaustive": True,
            "survivor_bound": self.scorer_cache._min_logit(),
        }
        row = self.id_to_row.get(candidate.record_id)
        out["candidate_indexed"] = row is not None
        if row is not None:
            corpus = self.corpus
            out["candidate_live"] = bool(
                corpus.row_valid[row] and not corpus.row_deleted[row]
            )
        if group_filtering:
            g1 = record.get_value(GROUP_NO_PROPERTY_NAME)
            g2 = candidate.get_value(GROUP_NO_PROPERTY_NAME)
            out["group_excluded"] = bool(g1 and g1 == g2)
        out["self_pair"] = record.record_id == candidate.record_id
        return out

    def set_indexing_disabled(self, disabled: bool) -> None:
        self.indexing_disabled = disabled

    def _make_corpus(self, plan) -> DeviceCorpus:
        """The corpus factory (construction and plan-growth rebuilds); the
        sharded index overrides it with its mesh-placed corpus."""
        return DeviceCorpus(plan, self.device)

    def close(self) -> None:
        """Free the corpus' device tensors and the built scorers, and drop
        the arena lease now rather than when the corpus is collected."""
        from ..ops.arena import ARENA

        self.scorer_cache.clear()
        self.corpus.spill_device()
        ARENA.forget(self.corpus)

    def _extract(self, records: Sequence[Record], plan=None):
        return F.extract_batch(plan or self.plan, records)

    def _append_chunk(self, records: Sequence[Record]) -> None:
        """Extract + corpus append + row mapping for one contiguous
        chunk."""
        feats = self._extract(records)
        deleted = np.array([r.is_deleted() for r in records], dtype=bool)
        group = np.array(
            [int(r.get_value(GROUP_NO_PROPERTY_NAME) or -1) for r in records],
            dtype=np.int32,
        )
        rows = self.corpus.append(feats, deleted, group,
                                  [r.record_id for r in records])
        for r, row in zip(records, rows):
            self.id_to_row[r.record_id] = int(row)

    def _append_rows_only(self, records: Sequence[Record]) -> None:
        """Extract + corpus append + row mapping, without the record
        mirror or the content fold (also the lazy rebuild, where the
        record set is unchanged).

        Batches past one update slice stream (``DUKE_STREAM_APPEND``, on
        by default): the batch is appended in ``DEVICE_UPDATE_SLICE``
        slices (grown to the parallel-extract minimum when the batch
        qualifies for the process pool) and each slice's rows are copied
        to the device before the next slice extracts.  Host mirrors, the
        dirty range and the row mapping advance per slice, so the host
        and device state end equal to the whole-batch path's
        (tests/test_torch_stream_append.py).
        """
        n = len(records)
        slice_n = _stream_append_slice(n)
        if slice_n is None:
            self._append_chunk(records)
            return
        corpus = self.corpus
        # pre-grow once so no slice crosses a capacity doubling (growth
        # forces a full re-upload, which must not run per slice)
        corpus.reserve(corpus.size + n)
        if corpus._device_feats is None or corpus._dirty_full:
            # nothing to overlap: a full upload is pending (cold corpus,
            # growth, restored snapshot), so every slice flush would be a
            # no-op -- keep the whole-batch chunk (and its full-size
            # parallel-extract fan-out); scoring pays the one full upload
            self._append_chunk(records)
            return
        with tracing.span("encode.stream_append",
                          {"records": n, "slice": slice_n}, annotate=True):
            for start in range(0, n, slice_n):
                self._append_chunk(records[start:start + slice_n])
                if corpus.stream_flush():
                    _STREAM_SLICES_CHILD.inc()

    def _append_records(self, records: Sequence[Record]) -> None:
        self._append_rows_only(records)
        lazy = isinstance(self.records, LazyRecordMap)
        acc = self._content_hash
        for r in records:
            if not lazy:
                old = self.records.get(r.record_id)
                if old is not None:
                    acc = xor_fold(acc, record_digest(old))
                acc = xor_fold(acc, record_digest(r))
            self.records[r.record_id] = r
        if not lazy:
            self._content_hash = acc

    # -- value-slot and char-width sizing ------------------------------------

    def _sized_slots(self, spec, records: Sequence[Record]) -> int:
        """Power-of-two value width fitting ``records`` for one property,
        clamped to DEVICE_VALUE_SLOTS_MAX."""
        need = max(
            (sum(1 for val in r.get_values(spec.name) if val)
             for r in records),
            default=0,
        )
        if need > _VALUE_SLOTS_MAX and spec.name not in self._cap_warned:
            self._cap_warned.add(spec.name)
            logger.warning(
                "property %r has records with %d values; device pruning "
                "sees the first %d (DEVICE_VALUE_SLOTS_MAX)",
                spec.name, need, _VALUE_SLOTS_MAX,
            )
        v = 1
        while v < need:
            v *= 2
        return max(1, min(v, _VALUE_SLOTS_MAX))

    def _query_plan(self, records: Sequence[Record]):
        """Plan for non-indexed query records (http-transform): the value
        axis sizes to the probe batch without widening the corpus."""
        specs = []
        for spec in self.plan.device_props:
            v = self._sized_slots(spec, records)
            specs.append(
                replace(spec, values_per_record=v) if v != spec.v else spec
            )
        return F.SchemaFeatures(device_props=specs,
                                host_props=self.plan.host_props)

    def _chars_needed(self, spec, records: Sequence[Record]) -> int:
        need = 0
        for r in records:
            for val in r.get_values(spec.name):
                # width in UTF-16 code units (len() undercounts non-BMP)
                if len(val) * 2 < need:
                    continue
                n = F.char_units(val)
                if n > need:
                    need = n
        return need

    def _sized_chars(self, spec, need: int) -> int:
        """Power-of-two char width fitting ``need`` units, at least the
        current width, clamped to DEVICE_MAX_CHARS_CAP."""
        if need > _CHARS_CAP:
            key = f"chars:{spec.name}"
            if key not in self._cap_warned:
                self._cap_warned.add(key)
                logger.warning(
                    "property %r has a %d-char value; device pruning sees "
                    "the first %d chars (DEVICE_MAX_CHARS_CAP; host "
                    "finalization stays exact)", spec.name, need, _CHARS_CAP,
                )
        width = spec.chars
        while width < need and width < _CHARS_CAP:
            width *= 2
        return min(width, _CHARS_CAP)

    def _maybe_grow_value_slots(self, records: Sequence[Record]) -> None:
        """Grow per-property value slots AND char widths to fit the batch
        (power-of-two, capped), demoting over-long text properties to the
        host side; the corpus tensors then rebuild from the records."""
        grew = False
        demote = []
        for spec in self.plan.device_props:
            v = self._sized_slots(spec, records)
            if v > spec.values_per_record:
                spec.values_per_record = v
                grew = True
            if self._auto_chars and spec.kind == F.CHARS:
                need = self._chars_needed(spec, records)
                if _DEMOTE_CHARS and need > _DEMOTE_CHARS:
                    demote.append(spec)
                    continue
                width = self._sized_chars(spec, need)
                if width > spec.chars:
                    spec.max_chars = width
                    grew = True
        if demote and self._demote_to_host(demote):
            grew = True
        if grew:
            self._rebuild_corpus()

    def _demote_to_host(self, specs) -> bool:
        """Move long-text CHARS properties to the host-scored side, never
        the LAST device property (that one stays at the cap width,
        truncating).  Returns True when the plan changed."""
        changed = False
        if len(self.plan.device_props) - len(specs) < 1:
            kept, specs = specs[0], specs[1:]  # first candidate stays
            width = self._sized_chars(kept, _CHARS_CAP)
            key = f"keep:{kept.name}"
            if key not in self._cap_warned:
                self._cap_warned.add(key)
                logger.warning(
                    "property %r is the only device-kernel property, so it "
                    "stays on device at width %d; longer values truncate "
                    "for pruning (host finalization stays exact)",
                    kept.name, width,
                )
            if width > kept.chars:
                kept.max_chars = width
                changed = True
        if not specs:
            return changed
        names = {s.name for s in specs}
        self.plan.device_props[:] = [
            s for s in self.plan.device_props if s.name not in names
        ]
        for prop in self.schema.comparison_properties():
            if prop.name in names:
                self.plan.host_props.append(prop)
        logger.warning(
            "long-text properties %s demoted to host scoring (values past "
            "DEVICE_DEMOTE_CHARS=%d)", sorted(names), _DEMOTE_CHARS,
        )
        # cached scorers snapshotted the old device_props list
        self.scorer_cache.clear()
        return True

    def _rebuild_corpus(self) -> None:
        """Re-extract every record under the current feature plan.  The
        record set is unchanged, so the content digest is too."""
        from ..ops.arena import ARENA

        with self._lock:
            old_records = self.records
            old = self.corpus
            self.corpus = self._make_corpus(self.plan)
            # the replacement leases under the same identity; the old
            # corpus' lease goes with it
            self.corpus.arena_label = old.arena_label
            self.corpus.arena_heat = old.arena_heat
            ARENA.forget(old)
            self.id_to_row = {}
            if old_records:
                logger.info(
                    "plan growth: rebuilding corpus tensors for %d records "
                    "(slots %s, chars %s)", len(old_records),
                    {s.name: s.v for s in self.plan.device_props},
                    {s.name: s.chars for s in self.plan.device_props},
                )
            if isinstance(old_records, LazyRecordMap):
                # stream the store in bounded batches through the capped
                # LRU instead of materializing every record
                batch: List[Record] = []
                for record in old_records.values():
                    batch.append(record)
                    if len(batch) >= 50_000:
                        self._append_rows_only(batch)
                        batch = []
                if batch:
                    self._append_rows_only(batch)
                return
            self.records = {}
            prev_hash = self._content_hash
            if old_records:
                self._append_records(list(old_records.values()))
            self._content_hash = prev_hash


    # -- corpus snapshot (restart acceleration) ------------------------------
    #
    # The record store is the source of truth; the corpus tensors are a
    # rebuildable cache.  Rebuilding re-runs feature extraction per record,
    # so the host mirror is snapshotted to one .npz (the JAX package's
    # format, key for key) and reloaded in one read; any mismatch (schema
    # change, env-sized shapes, store drift) falls back to full replay.

    @staticmethod
    def _snapshot_checksum(entries: Dict[str, np.ndarray]) -> str:
        """CRC32 chained over (key, dtype, shape, bytes) of the payload
        arrays in sorted key order: stamped as ``__checksum`` at save and
        re-derived from the as-stored arrays at load, so a flipped byte,
        a swapped member or a truncated archive replays instead of
        scoring corrupt features."""
        import zlib

        crc = 0
        for key in sorted(entries):
            arr = np.ascontiguousarray(entries[key])
            meta = f"{key}\x1f{arr.dtype.str}\x1f{arr.shape}".encode()
            crc = zlib.crc32(arr.tobytes(), zlib.crc32(meta, crc))
        return format(crc & 0xFFFFFFFF, "08x")

    def _snapshot_reject(self, reason: str, detail: str) -> bool:
        """A snapshot check failed: warn + count
        (``duke_snapshot_fallbacks_total``) and fall back to replay.  Never
        raises: a bad snapshot costs a rebuild, not availability."""
        telemetry.SNAPSHOT_FALLBACKS.labels(reason=reason).inc()
        logger.warning(
            "corpus snapshot rejected (%s: %s); replaying from the "
            "record store", reason, detail,
        )
        return False

    def _snapshot_fingerprint(self) -> str:
        """Plan semantics + every env knob that sizes the feature tensors
        (the JAX package's formula, so each package opens the other's
        snapshot); data-derived widths ride in the payload instead."""
        import hashlib

        spec = repr((
            [(s.name, s.kind, s.low, s.high)
             for s in self.plan.device_props],
            env_str("DEVICE_MAX_CHARS", ""),
            env_str("DEVICE_MAX_CHARS_CAP", ""),
            env_str("DEVICE_DEMOTE_CHARS", ""),
            env_str("DEVICE_MAX_GRAMS", ""),
            env_str("DEVICE_MAX_TOKENS", ""),
            getattr(self, "dim", None),          # ANN embedding width
            getattr(self, "emb_storage", None),  # ANN embedding layout
            str(np.dtype(F.CHAR_DTYPE)),
        ))
        return hashlib.sha256(spec.encode()).hexdigest()

    def snapshot_save(self, path: str) -> None:
        """Write the host mirror to ``path`` (write-then-rename; call with
        every dispatched block resolved and the link database drained)."""
        corpus = self.corpus
        if corpus.size == 0:
            return
        # the last store-synced digest when the workload stamps one, else
        # the index's own fold: a store write whose index pass failed
        # leaves the stamp behind the store, and the load then replays
        content_hash = (self._store_synced_hash
                        if self._store_synced_hash is not None
                        else self._content_hash.hex())
        # bf16 embeddings already are uint16 bit patterns on the host; the
        # JAX package lists its bf16 tensors (saved as uint16 views) in
        # __bf16_keys, so the port does too
        flat = {}
        bf16_keys = []
        for prop, tensors in corpus.feats.items():
            for name, arr in tensors.items():
                key = f"feat\x1f{prop}\x1f{name}"
                if prop == E.ANN_PROP and arr.dtype == np.uint16:
                    bf16_keys.append(key)
                flat[key] = arr[: corpus.size]
        payload = dict(flat)
        payload["__row_valid"] = corpus.row_valid[: corpus.size]
        payload["__row_deleted"] = corpus.row_deleted[: corpus.size]
        payload["__row_group"] = corpus.row_group[: corpus.size]
        # fixed-width unicode, never object dtype: an object array would
        # pickle, and loading it would need allow_pickle
        payload["__row_ids"] = np.array(
            [rid or "" for rid in corpus.row_ids], dtype=str)
        tmp = f"{path}.tmp.{os.getpid()}"
        savez = (np.savez_compressed if env_flag("SNAPSHOT_COMPRESS", True)
                 else np.savez)
        try:
            savez(
                tmp,
                __fingerprint=np.array(self._snapshot_fingerprint()),
                __content=np.array(content_hash),
                __checksum=np.array(self._snapshot_checksum(payload)),
                __bf16_keys=np.array(bf16_keys, dtype=str),
                __value_slots=np.array(
                    [s.v for s in self.plan.device_props], dtype=np.int64),
                __char_widths=np.array(
                    [s.chars for s in self.plan.device_props],
                    dtype=np.int64),
                # a demoted long-text property stays demoted on restart
                __device_props=np.array(
                    [s.name for s in self.plan.device_props], dtype=str),
                **payload,
            )
            # crash site: tmp written, rename pending -- the restart must
            # find the previous snapshot (or none), never the torn tmp
            faults.check_crash("mid_snapshot_save")
            # np.savez appends .npz to names without it
            replace_and_sync_dir(f"{tmp}.npz", path)
        except BaseException:
            for cand in (tmp, f"{tmp}.npz"):
                try:
                    os.unlink(cand)
                except OSError:
                    pass
            raise

    def snapshot_load(self, path: str, records_by_id,
                      content_hash: Optional[str] = None) -> bool:
        """Restore the corpus tensors from a snapshot; False -> replay.

        ``records_by_id`` is the record store's live view (a dict or a
        ``LazyRecordMap``); the snapshot is rejected unless its live rows
        are exactly that record set.  ``content_hash`` is the store's
        incremental digest (an O(1) staleness check; without it the
        records are rehashed).  Every rejection is counted in
        ``duke_snapshot_fallbacks_total`` and returns False; nothing here
        raises.
        """
        if self.corpus.size != 0 or not os.path.exists(path):
            return False
        try:
            with np.load(path) as data:  # no pickle: plain arrays only
                # re-apply a persisted long-text demotion BEFORE the
                # fingerprint, which the save computed over the demoted
                # plan (the JAX package checks the fingerprint first and so
                # replays every demoted snapshot; the replay would re-demote
                # on the same values anyway)
                if "__device_props" in data.files and self._auto_chars:
                    saved = [str(x) for x in data["__device_props"]]
                    current = [s.name for s in self.plan.device_props]
                    missing = [s for s in self.plan.device_props
                               if s.name not in saved]
                    if missing and set(saved) < set(current):
                        self._demote_to_host(missing)
                if str(data["__fingerprint"]) != self._snapshot_fingerprint():
                    return self._snapshot_reject(
                        "fingerprint", "plan/env fingerprint changed")
                if "__value_slots" not in data.files:
                    return self._snapshot_reject(
                        "schema", "missing __value_slots")
                if "__device_props" in data.files and self._auto_chars and [
                        s.name for s in self.plan.device_props] != saved:
                    return self._snapshot_reject(
                        "schema", "device property set changed")
                slots = [int(x) for x in data["__value_slots"]]
                if len(slots) != len(self.plan.device_props):
                    return self._snapshot_reject(
                        "schema", "value-slot count mismatch")
                if any(v > _VALUE_SLOTS_MAX for v in slots):
                    return self._snapshot_reject(
                        "schema", "value slots exceed the current cap")
                if "__char_widths" in data.files:
                    widths = [int(x) for x in data["__char_widths"]]
                    if len(widths) != len(self.plan.device_props):
                        return self._snapshot_reject(
                            "schema", "char-width count mismatch")
                    if self._auto_chars:
                        if any(w > _CHARS_CAP for w in widths):
                            return self._snapshot_reject(
                                "schema",
                                "char widths exceed the current cap")
                    elif widths != [s.chars for s in self.plan.device_props]:
                        return self._snapshot_reject(
                            "schema", "char widths changed")
                else:
                    widths = [s.chars for s in self.plan.device_props]
                # record CONTENT, not just the id set: an in-place update
                # only the store persisted must not score stale features
                expected = (content_hash if content_hash is not None
                            else _records_content_hash(records_by_id))
                if str(data["__content"]) != expected:
                    return self._snapshot_reject(
                        "content", "record store drifted past the snapshot")
                row_ids = [str(r) for r in data["__row_ids"]]
                row_valid = data["__row_valid"]
                row_deleted = data["__row_deleted"]
                row_group = data["__row_group"]
                live = {rid for rid, ok in zip(row_ids, row_valid) if ok}
                if live != set(records_by_id):
                    return self._snapshot_reject(
                        "content", "live row set differs from the store")
                # as-stored arrays: the checksum was stamped over these
                raw_payload: Dict[str, np.ndarray] = {
                    "__row_ids": data["__row_ids"],
                    "__row_valid": row_valid,
                    "__row_deleted": row_deleted,
                    "__row_group": row_group,
                }
                feats: Dict[str, Dict[str, np.ndarray]] = {}
                for key in data.files:
                    if not key.startswith("feat\x1f"):
                        continue
                    _, prop, name = key.split("\x1f", 2)
                    # __bf16_keys tensors stay uint16 bit patterns: the
                    # port's host layout of bf16 (ops.embedding)
                    raw_payload[key] = feats.setdefault(prop, {})[name] = \
                        data[key]
                if "__checksum" in data.files and (
                        str(data["__checksum"])
                        != self._snapshot_checksum(raw_payload)):
                    return self._snapshot_reject(
                        "checksum", "stamped content checksum mismatch")
        except Exception as e:
            logger.exception("snapshot load failed; replaying from store")
            return self._snapshot_reject("corrupt", repr(e))

        # every check passed: only now adopt the snapshot's widths (a
        # rejected snapshot leaves the plan untouched)
        for spec, v in zip(self.plan.device_props, slots):
            spec.values_per_record = v
        if self._auto_chars:
            for spec, w in zip(self.plan.device_props, widths):
                spec.max_chars = w
        corpus = self.corpus
        n = len(row_ids)
        rows = corpus.append(feats, np.asarray(row_deleted),
                             np.asarray(row_group), row_ids)
        corpus.row_valid[:n] = row_valid
        # the mask overwrite bypassed append/tombstone: recount
        corpus.live_rows = int(
            (np.asarray(row_valid) & ~np.asarray(row_deleted)).sum())
        # the tensors are assembled: stream them to the device while the
        # rest of the restore (row map, link DB, HTTP) runs on the host
        self.warm_upload_async()
        lazy = isinstance(records_by_id, LazyRecordMap)
        for rid, row, ok in zip(row_ids, rows, row_valid):
            if ok:
                self.id_to_row[rid] = int(row)
                if not lazy:
                    self.records[rid] = records_by_id[rid]
        if lazy:
            self.records = records_by_id
        self._prewarm_feature_cache(feats, records_by_id)
        # the verified digest is the index's running hash AND its
        # store-synced stamp (the restore bypassed the fold)
        self._content_hash = bytes.fromhex(expected)
        self._store_synced_hash = expected
        logger.info("corpus snapshot restored: %d rows from %s%s", n, path,
                    " (lazy record mirror)" if lazy else "")
        return True

    def _prewarm_feature_cache(self, feats, records_by_id) -> None:
        """Seed the feature cache (``DUKE_FEATURE_CACHE_MB``) from the
        restored tensors, so the first resync after a restart already
        hits.  Digests come from the store's raw rows, no record decode.
        Best-effort: a failure leaves the cache cold."""
        from ..ops import feature_cache as FC

        cache = FC.active()
        if cache is None:
            return
        try:
            store = getattr(records_by_id, "_store", None)
            if store is not None:
                digest_iter = store.row_digests()
            else:
                digest_iter = ((rid, record_digest(r))
                               for rid, r in records_by_id.items())
            warmed = FC.prewarm(self.plan, getattr(self, "encoder", None),
                                feats, self.id_to_row, digest_iter, cache)
            if warmed:
                logger.info("feature cache pre-warmed with %d rows from "
                            "the snapshot", warmed)
        except Exception:
            logger.exception("feature-cache pre-warm failed (cache stays "
                             "cold)")

    def warm_upload_async(self) -> None:
        """Copy the restored host mirror to the device on a background
        thread (``DEVICE_WARM_UPLOAD``, on by default; corpora under
        ``_WARM_UPLOAD_MIN_ROWS`` upload on first use instead).  Writers and the first
        query wait for the copy on the corpus' upload lock; a failure is
        raised by the next ``device_arrays``."""
        corpus = self.corpus
        if (corpus.size < _WARM_UPLOAD_MIN_ROWS
                or not env_flag("DEVICE_WARM_UPLOAD", True)):
            return

        def _upload():
            from ..ops.arena import ArenaAdmissionError

            try:
                corpus.device_arrays()
                if corpus.device.type == "cuda":
                    torch.cuda.current_stream(corpus.device).synchronize()
                logger.info("warm corpus upload complete (%d rows)",
                            corpus.size)
            except ArenaAdmissionError:
                # refused, not failed: nothing was uploaded, and the
                # first query re-admits (and answers 503 if it still
                # does not fit)
                logger.warning("warm corpus upload refused by the arena",
                               exc_info=True)
            except BaseException as e:
                corpus.warm_error = e
                logger.exception("warm corpus upload failed")

        threading.Thread(target=_upload, daemon=True,
                         name="corpus-upload").start()

    def mark_store_synced(self, store_hash: Optional[str]) -> None:
        """Record that the index applied every store write up to
        ``store_hash`` (the workload calls this after each fully applied
        batch); snapshot_save stamps it."""
        if store_hash is not None:
            self._store_synced_hash = store_hash


def _records_content_hash(records_by_id) -> str:
    """Order-independent digest of record ids AND values: the store's
    incremental formula, recomputed (for callers without a store)."""
    acc = EMPTY_CONTENT_HASH
    for record in records_by_id.values():
        acc = xor_fold(acc, record_digest(record))
    return acc.hex()


class _BlockResult:
    """Scored query block: per-query candidate rows above the survivor
    bound.  ``dd_ctx`` carries the query side the scorer used (for the dd
    rescore); ``dd`` the block's (hi, lo, unsafe) dd rescore, or None."""

    def __init__(self, top_logit: np.ndarray, top_index: np.ndarray,
                 min_logit: float, dd_ctx=None):
        self.top_logit = top_logit
        self.top_index = top_index
        self.min_logit = min_logit
        self.dd_ctx = dd_ctx
        self.dd = None
        # the block's width escalations and the CUDA-event time of its
        # programs (the scan, its re-runs and the dd rescore; 0 on the CPU)
        self.escalations = 0
        self.device_seconds = 0.0

    def survivor_triples(self, q: int) -> List[Tuple[int, int, float]]:
        """(k_position, corpus_row, device_logit) survivors of query q."""
        logits = self.top_logit[q]
        rows = self.top_index[q]
        keep = np.nonzero(logits > self.min_logit)[0]
        return [(int(k), int(rows[k]), float(logits[k])) for k in keep]


class _Fetch:
    """ONE device->host copy of a scorer's three outputs, started as soon
    as they are queued: (count, top_logit bits, top_index) pack into one
    int32 matrix whose copy into pinned memory is enqueued right behind
    the block's kernels, so the next block can be queued before this one
    is waited for."""

    def __init__(self, top_logit, top_index, count):
        k = top_logit.shape[1]
        packed = torch.cat(
            [count[:, None], top_logit.view(torch.int32), top_index], dim=1)
        self.k = k
        if packed.device.type == "cuda":
            self.host = torch.empty(packed.shape, dtype=torch.int32,
                                    pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            # timing-enabled: the end of the block's device time
            # (resolve_block)
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.host = packed
            self.event = None

    def result(self):
        """(count, top_logit, top_index) as numpy, waiting for the copy."""
        if self.event is not None:
            self.event.synchronize()
        arr = self.host.numpy()
        k = self.k
        return (arr[:, 0].copy(), arr[:, 1:1 + k].view(np.float32).copy(),
                arr[:, 1 + k:].copy())


class _PendingBlock:
    """In-flight scoring call; ``call(k)`` re-runs the scorer at width k.
    ``needs_escalation(count_max, k)`` is the backend's saturation
    predicate (brute force: some query overflowed K; ``ann``: retrieval
    saturated at C), ``stage`` the name ESCALATIONS counts it under;
    ``start`` the timing event recorded as the dispatch began (None on
    the CPU)."""

    def __init__(self, capacity, n, min_logit, k, call, dd_ctx, *,
                 needs_escalation=lambda cmax, k: cmax > k,
                 stage: str = "top_k", start=None):
        self.start = start
        self.capacity = capacity
        self.n = n
        self.min_logit = min_logit
        self.k = k
        self.call = call
        self.dd_ctx = dd_ctx
        self.needs_escalation = needs_escalation
        self.stage = stage
        self.fetch = call(k)


# Width escalations since the last reset, by stage ("top_k": brute force,
# "top_c": flat ann retrieval, "ivf": the IVF cell probe); workloads
# resolve blocks on their own threads.
ESCALATIONS = {"top_k": 0, "top_c": 0, "ivf": 0}
_ESCALATIONS_LOCK = threading.Lock()


def resolve_block(pending) -> _BlockResult:
    """Wait for a dispatched block; re-run with doubled width while the
    backend's saturation predicate fires (the exactness / recall
    contract)."""
    if isinstance(pending, _BlockResult):  # empty-corpus short-circuit
        return pending
    k = pending.k
    fetch = pending.fetch
    start = pending.start
    escalations, device_seconds = 0, 0.0
    while True:
        count, top_logit, top_index = fetch.result()
        # fetch.result() synchronized on this fetch's event, which the
        # stream reached after ``start``
        device_seconds += _elapsed_seconds(start, fetch.event)
        cmax = int(count[: pending.n].max(initial=0))
        if k >= pending.capacity or not pending.needs_escalation(cmax, k):
            result = _BlockResult(top_logit, top_index, pending.min_logit,
                                  pending.dd_ctx)
            result.escalations = escalations
            result.device_seconds = device_seconds
            return result
        escalations += 1
        k = min(k * 2, pending.capacity)
        with _ESCALATIONS_LOCK:
            ESCALATIONS[pending.stage] += 1
        # mirrored on /metrics; escalations are rare by construction (each
        # doubles the width), so the registry writes are off the steady
        # state
        telemetry.SCORER_ESCALATIONS.inc()
        telemetry.RETRIEVAL_ESCALATIONS.labels(stage=pending.stage).inc()
        logger.info("escalation: %d candidates at the bound, retrying with "
                    "width=%d", cmax, k)
        if start is not None:
            # the re-run queues behind what was dispatched meanwhile (the
            # next block's lookahead), so it is timed from its own start
            start = _device_clock(torch.device("cuda"))
        fetch = pending.call(k)


def _pad_rows(arr: np.ndarray, bucket: int) -> np.ndarray:
    n = arr.shape[0]
    if n == bucket:
        return arr
    out = np.zeros((bucket,) + arr.shape[1:], dtype=arr.dtype)
    out[:n] = arr
    return out


class _ScorerCache:
    """Scorers per (top_k, group_filtering, from_rows), the query-side
    upload, and block dispatch."""

    # an indexed batch's query features are gathered from its corpus rows
    # on the device; the mesh caches upload them instead (a row of a
    # split corpus lives on one shard, every shard needs every query)
    queries_from_rows = True
    # the certified dd rescore runs on the device; a mesh cache turns it
    # off when its mesh spans processes (engine.sharded_matcher)
    supports_dd = True

    def __init__(self, index: DeviceIndex):
        self.index = index
        self._scorers: Dict[Tuple[int, bool, bool], object] = {}

    def clear(self) -> None:
        self._scorers.clear()

    def _scorer(self, top_k: int, group_filtering: bool, from_rows: bool):
        key = (top_k, group_filtering, from_rows)
        if key not in self._scorers:
            self._scorers[key] = self._build(top_k, group_filtering,
                                             from_rows)
        return self._scorers[key]

    def _build(self, top_k: int, group_filtering: bool, from_rows: bool):
        return S.build_corpus_scorer(
            self.index.plan, chunk=_CHUNK, top_k=top_k,
            group_filtering=group_filtering, queries_from_rows=from_rows)

    def _min_logit(self) -> float:
        # the 1e-3 insurance margin covering f32 kernel error at the bound
        # (survivors are rescored host-exact, so it only costs extra
        # finalizations); the same formula as the JAX package
        index = self.index
        return B.emit_bound_logit(index.schema, index.plan, 1e-3)

    def _prepare_queries(self, records: Sequence[Record],
                         group_filtering: bool):
        """(qfeats or {} when gathered from corpus rows, from_rows,
        query_row, query_group), padded to the block's bucket."""
        index = self.index
        device = index.device
        bucket = bucket_for(len(records))
        # padding-bucket visibility: which shapes blocks land on and how
        # many padded rows they carry (unlocked single-writer children)
        blocks_child, pad_child = _BUCKET_CHILDREN[bucket]
        blocks_child.inc()
        if bucket > len(records):
            pad_child.inc(bucket - len(records))
        rows = [index.id_to_row.get(r.record_id, -1) for r in records]
        from_rows = self.queries_from_rows and all(row >= 0 for row in rows)
        if from_rows:
            # the batch was just indexed: its features already sit in the
            # corpus tensors, and only the row indices cross to the device
            qfeats = {}
        else:
            # http-transform: queries are not in the corpus
            qfeats_np = index._extract(records,
                                       plan=index._query_plan(records))
            qfeats = {
                prop: {name: _to_device(_pad_rows(arr, bucket), device, prop)
                       for name, arr in tensors.items()}
                for prop, tensors in qfeats_np.items()
            }
        query_row = np.full((bucket,), -1, dtype=np.int32)
        query_group = np.full((bucket,), -2, dtype=np.int32)
        for i, r in enumerate(records):
            query_row[i] = rows[i]
            group_no = r.get_value(GROUP_NO_PROPERTY_NAME)
            if group_filtering and not group_no:
                raise ValueError(
                    f"The '{GROUP_NO_PROPERTY_NAME}' property was missing "
                    "or empty!"
                )
            query_group[i] = int(group_no) if group_no else -2
        return (qfeats, from_rows, _to_device(query_row, device),
                _to_device(query_group, device))

    def dispatch_block(self, records: Sequence[Record], *,
                       group_filtering: bool):
        """Queue the scoring program for a query block and return a pending
        handle; ``resolve_block`` waits for it."""
        corpus = self.index.corpus
        n = len(records)
        min_logit = self._min_logit()
        if corpus.size == 0:
            return _BlockResult(
                np.full((n, 1), S.NEG_INF, np.float32),
                np.full((n, 1), -1, np.int32), min_logit,
            )
        start = _device_clock(self.index.device)
        qfeats, from_rows, query_row, query_group = self._prepare_queries(
            records, group_filtering)
        cfeats, cvalid, cdeleted, cgroup = corpus.device_arrays()

        def call(k):
            out = self._scorer(k, group_filtering, from_rows)(
                qfeats, cfeats, cvalid, cdeleted, cgroup, query_group,
                query_row, min_logit)
            return _Fetch(*out)

        k = min(_INITIAL_TOP_K, corpus.capacity)
        # the query side the scorer used, for the post-resolve dd rescore
        return _PendingBlock(corpus.capacity, n, min_logit, k, call,
                             (qfeats, from_rows, query_row), start=start)

    def dd_rescore(self, result: _BlockResult):
        """The dd survivor rescore of a resolved block: (hi, lo, unsafe)
        numpy arrays aligned with ``result.top_index``, or None when the
        block cannot ride it (empty corpus, nothing certifiable) or the
        gate skips it: only a survivor whose f32 logit sits at or below
        ``dd_gate_bound`` can be a certified reject, and certified events
        and residue take the host compare either way."""
        ctx = result.dd_ctx
        if ctx is None or not self.supports_dd:
            return None
        index = self.index
        plan = index.plan
        gate = B.dd_gate_bound(index.schema, plan)
        candidates = ((result.top_logit > result.min_logit)
                      & (result.top_logit <= gate))
        if not bool(candidates.any()):
            return None
        fn = S.dd_rescorer(plan, queries_from_rows=ctx[1],
                           value_slots_cap=_VALUE_SLOTS_MAX)
        if fn is None:
            return None
        qfeats, _, query_row = ctx
        names = [s.name for s in B.dd_plan_specs(plan)]
        start = _device_clock(index.device)
        hi, lo, unsafe = self._dd_call(fn, qfeats,
                                       index.corpus.device_arrays()[0],
                                       names, query_row, result.top_index)
        end = _device_clock(index.device)
        out = hi.cpu().numpy(), lo.cpu().numpy(), unsafe.cpu().numpy()
        # the blocking copies above waited for the program and its events
        result.device_seconds += _elapsed_seconds(start, end)
        return out

    def _dd_call(self, fn, qfeats, cfeats_all, names, query_row,
                 top_index: np.ndarray):
        """Run the dd program against the corpus tensors of the ``names``
        properties; on one device the survivor gather happens inside
        ``fn``.  The mesh caches override this to gather the survivors to
        the lead device first and feed ``fn`` an identity index: the same
        program and arithmetic, so the verdicts stay bit-identical."""
        cfeats = {name: cfeats_all[name] for name in names}
        return fn(qfeats, cfeats, query_row,
                  _to_device(top_index, self.index.device))


class DeviceProcessor:
    """The device counterpart of the host engine's ``deduplicate``: block
    the queries, run one device scoring program per block, finalize the
    surviving top-K pairs on the host, emit listener events in order.
    ``exhaustive``: the comparator kernels score every live row per query
    (brute force); otherwise ``pairs_compared`` counts the retrieved rows
    they rescored."""

    exhaustive = True
    # a serving group's follower replicas replay only the device-program
    # side of a batch (parallel.dispatch): host finalization of the
    # survivors -- and everything downstream of it (listeners, link
    # databases) -- runs on the frontend alone.  The device-program ORDER
    # stays identical either way, so the flag guards only the per-query
    # host loop
    finalize_survivors = True

    def __init__(self, schema: DukeSchema, database: DeviceIndex, *,
                 group_filtering: bool = False, threads: int = 1):
        self.schema = schema
        self.database = database
        self.group_filtering = group_filtering
        self.listeners: List[MatchListener] = []
        self.stats = ProfileStats()
        # single-writer per-batch phase durations (one thread scores a
        # workload at a time); /metrics and /stats read them lock-free
        self.phases = PhaseRecorder()
        self._host = Processor(schema)
        # decision flight recorder + drift monitors: written only by the
        # thread that emits listener events (single writer), scraped
        # lock-free by /metrics and served by /debug/decisions
        from ..telemetry.decisions import DecisionRecorder
        from .explain import host_breakdown

        self.decisions = DecisionRecorder(
            schema.threshold, schema.maybe_threshold,
            breakdown=lambda q, c: host_breakdown(schema, q, c),
            resolver=database.find_record_by_id,
        )
        self._scorers = database.scorer_cache
        self.finalizer = FinalizeExecutor(threads)

    def add_match_listener(self, listener: MatchListener) -> None:
        self.listeners.append(listener)

    def compare(self, r1: Record, r2: Record) -> float:
        """Host-exact pair probability: emitted confidences are the f64
        oracle's, never the device's f32 logits."""
        return self._host.compare(r1, r2)

    def deduplicate(self, records: Sequence[Record]) -> None:
        """One batch in true-interval phases, each a span under the active
        trace and a ``ProfileStats`` clock: ``encode`` (listener
        batch_ready, index, commit: extraction and the corpus append),
        then per query block (``_score_blocks``) ``scan.dispatch``,
        ``scan.wait``, ``finalize.dd`` and ``finalize``, and ``persist``
        (listener batch_done: the link commit, with the journal append
        and its sync as ``links.journal``).  The JAX package's four phases
        are observed as before from the same intervals: retrieve is
        dispatch plus wait, score is dd plus finalize; their sum goes to
        the cost ledger as host busy time (``costs.note_busy``), and the
        pass's CUDA-event device time (``device_seconds``) to its device
        ledger (``costs.note_device``).  ``h2d_bytes`` counts what the
        pass handed host to device; the encode and dispatch spans carry
        their own share."""
        t0 = time.monotonic()
        h2d0 = h2d_bytes()
        for listener in self.listeners:
            listener.batch_ready(len(records))
        # annotate=True also opens a torch.profiler range while an
        # on-demand capture is live (utils.profiling.start_capture), so
        # the capture's timeline carries the trace tree's phase names
        with tracing.span(PHASE_ENCODE, {"records": len(records)},
                          annotate=True) as sp:
            for record in records:
                self.database.index(record)
            self.database.commit()
            if sp is not None:
                sp.set_attribute("h2d_bytes", h2d_bytes() - h2d0)
        encode_dt = time.monotonic() - t0
        self.phases.observe(PHASE_ENCODE, encode_dt)
        retrieval0 = self.stats.retrieval_total()
        compare0 = self.stats.compare_total()
        device0 = self.stats.device_seconds
        # a serving group: followers replay the scoring pass on the same
        # query records (the corpus mutation went out from commit());
        # broadcast before _score_blocks, so every process enters the
        # block programs -- and their collectives -- in one global order
        from ..parallel import dispatch

        key = getattr(self.database, "_dispatch_key", None)
        d = dispatch.current() if key is not None else None
        if d is not None:
            d.broadcast(dispatch.with_trace_ctx(("score", key,
                                                 list(records))))
        # a frontend that aborts mid-pass (a listener error, an OOM) has
        # entered fewer collectives than the followers it just instructed
        with dispatch.latch_on_failure(
                d, "frontend scoring pass aborted after broadcast"):
            self._score_blocks(records)
        self.stats.batches += 1
        retrieve_dt = self.stats.retrieval_total() - retrieval0
        score_dt = self.stats.compare_total() - compare0
        self.phases.observe(PHASE_RETRIEVE, retrieve_dt)
        self.phases.observe(PHASE_SCORE, score_dt)
        t_persist = time.monotonic()
        with tracing.span(PHASE_PERSIST, annotate=True):
            for listener in self.listeners:
                listener.batch_done()
        persist_dt = time.monotonic() - t_persist
        self.phases.observe(PHASE_PERSIST, persist_dt)
        self.stats.h2d_bytes += h2d_bytes() - h2d0
        costs.note_busy(encode_dt + retrieve_dt + score_dt + persist_dt)
        costs.note_device(self.stats.device_seconds - device0)

    def _dispatch_scan(self, block: Sequence[Record],
                       lookahead: bool = False):
        """``dispatch_block`` as the ``scan.dispatch`` phase: the host's
        query preparation, corpus upload and scorer launches.  A lookahead
        dispatch runs inside the previous block's ``scan.wait`` (its span
        a child of that one); returns (pending, seconds)."""
        h2d0 = h2d_bytes()
        t0 = time.monotonic()
        attrs = {"records": len(block), "lookahead": lookahead}
        if not lookahead:
            # a lookahead dispatch lies inside a scan.wait, whose phase
            # already counts it
            attrs["phase"] = PHASE_RETRIEVE
        with tracing.span("scan.dispatch", attrs) as sp:
            pending = self._scorers.dispatch_block(
                block, group_filtering=self.group_filtering)
            if sp is not None:
                sp.set_attribute("h2d_bytes", h2d_bytes() - h2d0)
        dt = time.monotonic() - t0
        self.stats.dispatch_seconds += dt
        return pending, dt

    def _score_blocks(self, records: Sequence[Record]) -> None:
        """Double-buffered block dispatch: block N+1's program is queued
        before block N's results are fetched, so host finalization of N
        overlaps device scoring of N+1.  While a device trace is armed
        (``PROFILE_TRACE_DIR``) the lookahead is held back, so a traced
        block is dispatched inside its own trace window.

        Each block's host time falls into four intervals that never
        overlap, each a span and a ``ProfileStats`` clock:
        ``scan.dispatch`` (``_dispatch_scan``), ``scan.wait``
        (``resolve_block``: the wait for the results and any width
        escalation, less the lookahead dispatch inside it),
        ``finalize.dd`` (the dd rescore's gate, program and copy back)
        and ``finalize`` (the host f64 loop and the listener events).
        ``device_seconds`` adds the CUDA-event time of the block's
        programs, read after the waits that already synchronized on
        them.

        A serving group's follower replicas call this directly with
        ``finalize_survivors=False``: the block order, the lookahead and
        the escalation re-runs must match the frontend's program for
        program, or the collectives deadlock, so the loop is shared
        rather than reimplemented (parallel.dispatch invariant 2)."""
        live_rows = self.database.corpus.live_rows
        size = _QUERY_BUCKETS[-1]
        blocks = [records[s:s + size] for s in range(0, len(records), size)]
        pending = None
        for bi, block in enumerate(blocks):
            lookahead = bi + 1 < len(blocks) and not trace_armed()
            with trace_batch(f"score_block[{len(block)}]"):
                if pending is None:
                    pending, _ = self._dispatch_scan(block)
                t1 = time.monotonic()
                nxt, nested = None, 0.0
                attrs = {"records": len(block), "phase": PHASE_RETRIEVE}
                with tracing.span("scan.wait", attrs) as sp:
                    if lookahead:
                        nxt, nested = self._dispatch_scan(
                            blocks[bi + 1], lookahead=True)
                    result = resolve_block(pending)
                    if sp is not None:
                        sp.set_attribute("escalations", result.escalations)
            pending = nxt
            t2 = time.monotonic()
            self.stats.wait_seconds += t2 - t1 - nested
            if not self.finalize_survivors:
                self.stats.device_seconds += result.device_seconds
                continue
            if self.finalizer.device:
                # certified finalization: one more device program over the
                # resolved (Q, K) survivors
                with tracing.span("finalize.dd", {"phase": PHASE_SCORE}) as sp:
                    result.dd = self._scorers.dd_rescore(result)
                    if sp is not None:
                        sp.set_attribute("ran", result.dd is not None)
                if result.dd is not None:
                    self.stats.dd_blocks += 1
            self.stats.device_seconds += result.device_seconds
            t3 = time.monotonic()
            self.stats.dd_seconds += t3 - t2
            with tracing.span("finalize", {"records": len(block),
                                           "phase": PHASE_SCORE}):
                self._finalize_block(block, result, live_rows)
            self.stats.finalize_seconds += time.monotonic() - t3

    def _finalize_block(self, block: Sequence[Record], result: _BlockResult,
                        live_rows: int) -> None:
        """Host finalization of a resolved block and its listener events,
        in query order."""
        outcomes = self.finalizer.finalize_block(self, block, result)
        for qi, (record, out) in enumerate(zip(block, outcomes)):
            for event, candidate, prob in out.events:
                for listener in self.listeners:
                    getattr(listener, event)(record, candidate, prob)
            if not out.events:
                for listener in self.listeners:
                    listener.no_match_for(record)
            if out.decisions:
                # drift monitors + sampled / latched ring records, on
                # the serial event-coordinator thread (single writer)
                self.decisions.observe(
                    record, out.decisions, prune=out.prune,
                    margin=out.margin, host_bound=out.host_bound)
            self.stats.records_processed += 1
            self.stats.candidates_retrieved += out.survivors
            self.stats.pairs_rescored += out.rescored
            self.stats.pairs_skipped += out.skipped
            self.stats.pairs_device_certified += out.device_certified
            self.stats.dd_residue_margin += out.residue_margin
            self.stats.dd_residue_kind += out.residue_kind
            self.stats.dd_residue_truncation += out.residue_truncation
            if self.exhaustive:
                # the device scored this query against every live row
                self.stats.pairs_compared += live_rows
            else:
                self.stats.pairs_compared += int(
                    (result.top_index[qi] >= 0).sum())
