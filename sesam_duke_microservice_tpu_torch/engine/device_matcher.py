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
import threading
import time
from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import DukeSchema
from ..core.records import GROUP_NO_PROPERTY_NAME, Record, SchemaError
from ..env import env_int, env_int_tuple, env_str
from ..index.base import CandidateIndex
from ..ops import bounds as B
from ..ops import encoder as E
from ..ops import features as F
from ..ops import scoring as S
from ..utils.profiling import trace_armed, trace_batch
from .finalize import FinalizeExecutor
from .listeners import MatchListener
from .processor import Processor, ProfileStats

logger = logging.getLogger("device-matcher")

# Query blocks are padded to these sizes; blocks larger than the last one
# are split.  Same knobs and defaults as the JAX package.
_QUERY_BUCKETS = env_int_tuple("DEVICE_QUERY_BUCKETS", "16,128,1024,2048,4096")
_CHUNK = env_int("DEVICE_CHUNK", 8192)
_INITIAL_TOP_K = env_int("DEVICE_TOP_K", 64)
# value-slot auto-growth cap (pair scoring is O(V^2) combos per property)
_VALUE_SLOTS_MAX = env_int("DEVICE_VALUE_SLOTS_MAX", 8)
# per-property char widths double to fit the data up to the cap; past the
# demotion width a property moves to host scoring (0 disables demotion)
_CHARS_CAP = env_int("DEVICE_MAX_CHARS_CAP", 1024)
_DEMOTE_CHARS = env_int("DEVICE_DEMOTE_CHARS", 256)


def query_buckets() -> tuple:
    return _QUERY_BUCKETS


def bucket_for(n: int) -> int:
    """Padded query-block size for an ``n``-record batch."""
    for b in _QUERY_BUCKETS:
        if n <= b:
            return b
    return _QUERY_BUCKETS[-1]


def _to_device(arr: np.ndarray, device: torch.device,
               prop: str = None) -> torch.Tensor:
    """Host mirror -> device tensor; uint16 chars widen to int32 here,
    while the uint16 bf16 bit patterns of the embeddings (``prop`` is
    ``ANN_PROP``) are reinterpreted as ``torch.bfloat16``.  Non-blocking: a
    pageable source is staged by the copy call itself, and a blocking copy
    would synchronize the stream behind queued scoring."""
    if arr.dtype == np.uint16 and prop == E.ANN_PROP:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).to(
            device, non_blocking=True).view(torch.bfloat16)
    if arr.dtype == np.uint16:
        arr = arr.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device,
                                                          non_blocking=True)


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
        if self.row_valid[row] and not self.row_deleted[row]:
            self.live_rows -= 1
        self.row_valid[row] = False
        self._mask_rows.append(int(row))

    # -- device mirror -------------------------------------------------------

    def device_arrays(self):
        """(feats, valid, deleted, group) as tensors on ``self.device``."""
        if self._device_feats is None or self._dirty_full:
            self._device_feats = {
                prop: {name: _to_device(arr, self.device, prop)
                       for name, arr in tensors.items()}
                for prop, tensors in self.feats.items()
            }
            self._device_masks = tuple(
                _to_device(arr, self.device)
                for arr in (self.row_valid, self.row_deleted, self.row_group)
            )
            self._dirty_full = False
            self._pending_rows = None
            self._mask_rows = []
        else:
            if self._pending_rows is not None:
                (lo, hi), self._pending_rows = self._pending_rows, None
                for prop, tensors in self.feats.items():
                    for name, arr in tensors.items():
                        self._device_feats[prop][name][lo:hi] = _to_device(
                            arr[lo:hi], self.device, prop)
                for dev, arr in zip(self._device_masks,
                                    (self.row_valid, self.row_deleted,
                                     self.row_group)):
                    dev[lo:hi] = _to_device(arr[lo:hi], self.device)
            if self._mask_rows:
                rows, self._mask_rows = self._mask_rows, []
                idx = _to_device(np.asarray(rows, dtype=np.int64),
                                 self.device)
                valid, deleted, _ = self._device_masks
                valid[idx] = _to_device(self.row_valid[rows], self.device)
                deleted[idx] = _to_device(self.row_deleted[rows],
                                          self.device)
        valid, deleted, group = self._device_masks
        return self._device_feats, valid, deleted, group


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
        self.corpus = DeviceCorpus(self.plan, self.device)
        self.records: Dict[str, Record] = {}     # id -> latest record
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
        # last write per id wins within a batch (Duke re-index semantics)
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

    def find_record_by_id(self, record_id: str) -> Optional[Record]:
        return self.records.get(record_id)

    def set_indexing_disabled(self, disabled: bool) -> None:
        self.indexing_disabled = disabled

    def _extract(self, records: Sequence[Record], plan=None):
        return F.extract_batch(plan or self.plan, records)

    def _append_records(self, records: Sequence[Record]) -> None:
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
            self.records[r.record_id] = r

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
        """Re-extract every record under the current feature plan."""
        with self._lock:
            old_records = self.records
            self.corpus = DeviceCorpus(self.plan, self.device)
            self.id_to_row = {}
            self.records = {}
            if old_records:
                logger.info(
                    "plan growth: rebuilding corpus tensors for %d records "
                    "(slots %s, chars %s)", len(old_records),
                    {s.name: s.v for s in self.plan.device_props},
                    {s.name: s.chars for s in self.plan.device_props},
                )
                self._append_records(list(old_records.values()))


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
            self.event = torch.cuda.Event()
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
    saturated at C), ``stage`` the name ESCALATIONS counts it under."""

    def __init__(self, capacity, n, min_logit, k, call, dd_ctx, *,
                 needs_escalation=lambda cmax, k: cmax > k,
                 stage: str = "top_k"):
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
# "top_c": ann retrieval); workloads resolve blocks on their own threads.
ESCALATIONS = {"top_k": 0, "top_c": 0}
_ESCALATIONS_LOCK = threading.Lock()


def resolve_block(pending) -> _BlockResult:
    """Wait for a dispatched block; re-run with doubled width while the
    backend's saturation predicate fires (the exactness / recall
    contract)."""
    if isinstance(pending, _BlockResult):  # empty-corpus short-circuit
        return pending
    k = pending.k
    fetch = pending.fetch
    while True:
        count, top_logit, top_index = fetch.result()
        cmax = int(count[: pending.n].max(initial=0))
        if k >= pending.capacity or not pending.needs_escalation(cmax, k):
            return _BlockResult(top_logit, top_index, pending.min_logit,
                                pending.dd_ctx)
        k = min(k * 2, pending.capacity)
        with _ESCALATIONS_LOCK:
            ESCALATIONS[pending.stage] += 1
        logger.info("escalation: %d candidates at the bound, retrying with "
                    "width=%d", cmax, k)
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

    def __init__(self, index: DeviceIndex):
        self.index = index
        self._scorers: Dict[Tuple[int, bool, bool], object] = {}

    def clear(self) -> None:
        self._scorers.clear()

    def _scorer(self, top_k: int, group_filtering: bool, from_rows: bool):
        key = (top_k, group_filtering, from_rows)
        if key not in self._scorers:
            self._scorers[key] = S.build_corpus_scorer(
                self.index.plan, chunk=_CHUNK, top_k=top_k,
                group_filtering=group_filtering, queries_from_rows=from_rows,
            )
        return self._scorers[key]

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
        rows = [index.id_to_row.get(r.record_id, -1) for r in records]
        from_rows = all(row >= 0 for row in rows)
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
                             (qfeats, from_rows, query_row))

    def dd_rescore(self, result: _BlockResult):
        """The dd survivor rescore of a resolved block: (hi, lo, unsafe)
        numpy arrays aligned with ``result.top_index``, or None when the
        block cannot ride it (empty corpus, nothing certifiable) or the
        gate skips it: only a survivor whose f32 logit sits at or below
        ``dd_gate_bound`` can be a certified reject, and certified events
        and residue take the host compare either way."""
        ctx = result.dd_ctx
        if ctx is None:
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
        cfeats_all = index.corpus.device_arrays()[0]
        cfeats = {s.name: cfeats_all[s.name] for s in B.dd_plan_specs(plan)}
        top_index = _to_device(result.top_index, index.device)
        hi, lo, unsafe = fn(qfeats, cfeats, query_row, top_index)
        return hi.cpu().numpy(), lo.cpu().numpy(), unsafe.cpu().numpy()


class DeviceProcessor:
    """The device counterpart of the host engine's ``deduplicate``: block
    the queries, run one device scoring program per block, finalize the
    surviving top-K pairs on the host, emit listener events in order.
    ``exhaustive``: the comparator kernels score every live row per query
    (brute force); otherwise ``pairs_compared`` counts the retrieved rows
    they rescored."""

    exhaustive = True

    def __init__(self, schema: DukeSchema, database: DeviceIndex, *,
                 group_filtering: bool = False, threads: int = 1):
        self.schema = schema
        self.database = database
        self.group_filtering = group_filtering
        self.listeners: List[MatchListener] = []
        self.stats = ProfileStats()
        self._host = Processor(schema)
        self._scorers = database.scorer_cache
        self.finalizer = FinalizeExecutor(threads)

    def add_match_listener(self, listener: MatchListener) -> None:
        self.listeners.append(listener)

    def compare(self, r1: Record, r2: Record) -> float:
        """Host-exact pair probability: emitted confidences are the f64
        oracle's, never the device's f32 logits."""
        return self._host.compare(r1, r2)

    def deduplicate(self, records: Sequence[Record]) -> None:
        for listener in self.listeners:
            listener.batch_ready(len(records))
        for record in records:
            self.database.index(record)
        self.database.commit()
        self._score_blocks(records)
        self.stats.batches += 1
        for listener in self.listeners:
            listener.batch_done()

    def _score_blocks(self, records: Sequence[Record]) -> None:
        """Double-buffered block dispatch: block N+1's program is queued
        before block N's results are fetched, so host finalization of N
        overlaps device scoring of N+1.  While a device trace is armed
        (``PROFILE_TRACE_DIR``) the lookahead is held back, so a traced
        block is dispatched inside its own trace window."""
        live_rows = self.database.corpus.live_rows
        size = _QUERY_BUCKETS[-1]
        blocks = [records[s:s + size] for s in range(0, len(records), size)]
        pending = None
        for bi, block in enumerate(blocks):
            lookahead = bi + 1 < len(blocks) and not trace_armed()
            with trace_batch(f"score_block[{len(block)}]"):
                if pending is None:
                    pending = self._scorers.dispatch_block(
                        block, group_filtering=self.group_filtering)
                # the device wait is clocked from here: a block's own
                # dispatch is host work (the next block's lookahead
                # dispatch falls inside the wait)
                t1 = time.monotonic()
                nxt = None
                if lookahead:
                    nxt = self._scorers.dispatch_block(
                        blocks[bi + 1], group_filtering=self.group_filtering)
                result = resolve_block(pending)
            pending = nxt
            t2 = time.monotonic()
            self.stats.retrieval_seconds += t2 - t1
            if self.finalizer.device:
                # certified finalization: one more device program over the
                # resolved (Q, K) survivors
                result.dd = self._scorers.dd_rescore(result)
                if result.dd is not None:
                    self.stats.dd_blocks += 1
                self.stats.dd_seconds += time.monotonic() - t2
            outcomes = self.finalizer.finalize_block(self, block, result)
            for qi, (record, out) in enumerate(zip(block, outcomes)):
                for event, candidate, prob in out.events:
                    for listener in self.listeners:
                        getattr(listener, event)(record, candidate, prob)
                if not out.events:
                    for listener in self.listeners:
                        listener.no_match_for(record)
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
            self.stats.compare_seconds += time.monotonic() - t2
