"""Per-workload runtime bundle and the ingest/feed flows.

Counterpart of the JAX package's ``engine/workload.py`` for the ``device``,
``ann`` and ``host`` backends: each workload owns its datasources, the
candidate index and processor, the match listener, its link database and
(when persistent) its record store, plus a lock serializing access
(writers block; the HTTP layer gives readers 1 s).

Ingest requests arrive through ``submit_batch`` (the lock-winner merge:
whichever request wins the lock runs every request queued behind it as one
batch) or through ``engine.scheduler.IngestScheduler``; both end in
``_run_merged``, whose conflict split keeps events and link rows equal to
serial execution.

Durable state (``persistent=True``, the default) lives in the workload's
data folder, in the JAX package's formats: ``records.sqlite`` (the record
store, the source of truth), ``linkdatabase.sqlite`` (or
``recordlinkdatabase.sqlite``) behind write-behind with its
``.journal``, and ``corpus_snapshot.npz``.  A restart restores a device
corpus from the snapshot, else replays the store, then copies the corpus
to the device in the background; the ``host`` backend's inverted index has
no snapshot and always replays.

Flow (App.java:924-1028 / 1065-1179): parse -> records -> partition
deleted/live -> tombstone + retract links for deleted -> deduplicate live.
Deleted records are detected through the hidden ``dukeDeleted`` property
for both workload kinds, and http-transform disables indexing and link
updates for both, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence

import torch

from ..core.config import ServiceConfig, WorkloadConfig
from ..core.records import Record
from ..index.base import CandidateIndex
from ..index.inverted import InvertedIndex
from ..links import create_link_database
from ..links.base import LinkDatabase
from ..links.replica import links_feed_page
from ..ops.arena import arena_enabled
from ..service.datasource import IncrementalDataSource
from ..store.records import LazyRecordMap, RecordStore, SqliteRecordStore
from ..telemetry import memory
from ..utils import faults
from .device_matcher import DeviceIndex, DeviceProcessor
from .listeners import ServiceMatchListener
from .processor import Processor
from .scheduler import fold_ewma, retry_after_seconds


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.  ``cuda`` (the default)
    requires a visible GPU: without one this raises rather than silently
    running on the CPU, which only an explicit ``device="cpu"`` selects."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


logger = logging.getLogger("workload")


def _snapshot_path(data_folder: str) -> str:
    return os.path.join(data_folder, "corpus_snapshot.npz")


def _hbm_components(wl_ref) -> Dict[str, int]:
    """Device-buffer bytes for one workload, keyed by component -- the
    device-byte ledger's registered callable.  Reads the ``nbytes`` of
    the corpus' device tensors (``DeviceCorpus.device_bytes``, a host
    read: no device sync) lock-free; the host backend (no device corpus)
    and a corpus not yet copied to the device report nothing."""
    wl = wl_ref()
    if wl is None:
        return {}
    corpus = getattr(wl.index, "corpus", None)
    if corpus is None:
        return {}
    out = corpus.device_bytes()
    ivf = getattr(wl.index, "ivf", None)
    if ivf is not None:
        out["ivf_membership"] = ivf.device_nbytes()
    return {k: v for k, v in out.items() if v}


def _arena_heat(wl_ref) -> float:
    """Accumulated per-workload device-seconds from the cost ledger's
    phase recorder -- the arena's eviction heat: among cold candidates,
    the tenant that has burned the least device time spills first.
    Lock-free torn reads tolerated (ordering hint only)."""
    wl = wl_ref()
    if wl is None:
        return 0.0
    phases = getattr(wl.processor, "phases", None)
    if phases is None:
        return 0.0
    try:
        return float(sum(phases.phase_seconds().values()))
    except Exception:
        return 0.0


class _BatchRequest:
    """One queued ingest request awaiting the merged batch."""

    __slots__ = ("dataset_id", "entities", "event", "error")

    def __init__(self, dataset_id: str, entities: Sequence[dict]):
        self.dataset_id = dataset_id
        self.entities = entities
        self.event = threading.Event()
        self.error: Optional[Exception] = None


class Workload:
    def __init__(self, config: WorkloadConfig, index: CandidateIndex,
                 processor, listener: ServiceMatchListener,
                 link_database: LinkDatabase,
                 record_store: Optional[RecordStore] = None,
                 restore_route: Optional[str] = None):
        self.config = config
        self.name = config.name
        self.kind = config.kind
        self.index = index
        self.processor = processor
        self.listener = listener
        self.link_database = link_database
        self.record_store = record_store
        # how the build restored the corpus: "snapshot", "replay", or None
        # (ephemeral, or nothing stored yet)
        self.restore_route = restore_route
        self.lock = threading.Lock()
        # set under self.lock by close(); the scheduler and submit_batch
        # re-check it after locking
        self.closed = False
        # ingest microbatching: concurrent POSTs queue here and whichever
        # thread wins the workload lock processes the whole queue as ONE
        # batch (self._mb_mutex orders queue access; it is never held
        # while acquiring self.lock)
        self._mb_mutex = threading.Lock()
        self._mb_queue: List[_BatchRequest] = []
        # recent write-side lock-hold EWMA (seconds), the busy-503's
        # Retry-After; written under self.lock, read lock-free
        self._hold_ewma: Optional[float] = None
        # sticky store/index divergence latch: a store write committed
        # but its index application failed.  While set, _mark_synced never
        # stamps again in this process (the store hash would cover rows
        # the index never applied); cleared only by a restart replay.
        self._store_dirty = False
        self.datasources: Dict[str, IncrementalDataSource] = {
            ds.dataset_id: IncrementalDataSource(ds)
            for ds in config.duke.data_sources
        }
        # device-byte ledger enrollment (telemetry/memory.py): the
        # components callable holds this workload weakly, so a replaced
        # workload drops out of the books with its last reference and the
        # closed flag hides it meanwhile.  Arena-enabled device corpora
        # register as LOGICAL views: the arena owns the physical corpus
        # bytes and attributes them once
        wl_ref = weakref.ref(self)
        corpus = getattr(index, "corpus", None)
        memory.register(self, self.kind, self.name,
                        lambda: _hbm_components(wl_ref),
                        logical=corpus is not None and arena_enabled())
        memory.note_device(getattr(index, "device", None))
        if corpus is not None:
            # arena identity + eviction heat: device_arrays admits under
            # these (engine.device_matcher.DeviceCorpus)
            corpus.arena_label = f"{self.kind}/{self.name}"
            corpus.arena_heat = lambda: _arena_heat(wl_ref)

    # -- lock-hold observations ---------------------------------------------

    def note_lock_hold(self, seconds: float) -> None:
        """Fold one write-side lock-hold duration into the EWMA (call with
        ``self.lock`` held -- batch paths and the scheduler dispatcher)."""
        self._hold_ewma = fold_ewma(self._hold_ewma, seconds)

    def busy_retry_after(self) -> int:
        """Whole-second Retry-After hint for lock-timeout busy replies:
        the recent write hold, ceil'd and clamped (the scheduler's
        ``retry_after_seconds`` policy)."""
        ewma = self._hold_ewma
        if ewma is None:
            return 1
        return retry_after_seconds(ewma)

    # -- ingest + match -----------------------------------------------------

    def submit_batch(self, dataset_id: str, entities: Sequence[dict],
                     http_transform: bool = False) -> Optional[List[dict]]:
        """Handler entry with the scheduler off: lock discipline + ingest
        microbatching.

        Non-transform POSTs that arrive while another request holds the
        workload lock are queued; whichever thread next wins the lock runs
        the whole queue as ONE merged batch (per-request conversion errors
        stay per-request).  Transforms keep their own lock-held call:
        their response rows are per-request state on the shared listener.
        Returns None when the workload closed mid-flight (the caller
        re-resolves and resubmits); raises this request's error otherwise.
        """
        if http_transform:
            with self.lock:
                if self.closed:
                    return None
                return self.process_batch(dataset_id, entities,
                                          http_transform=True)

        req = _BatchRequest(dataset_id, entities)
        with self._mb_mutex:
            self._mb_queue.append(req)
        with self.lock:
            if not req.event.is_set():
                with self._mb_mutex:
                    if self.closed:
                        # withdraw (if a pre-close leader already took the
                        # request its event is set and we fall through)
                        if req in self._mb_queue:
                            self._mb_queue.remove(req)
                            return None
                    work, self._mb_queue = self._mb_queue, []
                if work:
                    t0 = time.monotonic()
                    try:
                        self._run_merged(work)
                    finally:
                        self.note_lock_hold(time.monotonic() - t0)
        if not req.event.is_set():  # withdrawn post-close without a leader
            return None
        if req.error is not None:
            raise req.error
        return []

    def _retract_links_for(self, deleted: Sequence[Record]) -> None:
        """Retract every link touching the deleted records (one batched
        lookup; a link touching two deleted records retracts once)."""
        if not deleted:
            return
        ids = [r.record_id for r in deleted]
        for link in self.link_database.get_links_for_ids(ids):
            link.retract()
            self.link_database.assert_link(link)

    def _mark_synced(self) -> None:
        """Stamp the index as caught up with the store (the snapshot's
        staleness guard, ``DeviceIndex.mark_store_synced``; the host
        index has none), unless a batch ever left the store ahead of the
        index."""
        if self.record_store is None or self._store_dirty:
            return
        mark = getattr(self.index, "mark_store_synced", None)
        if mark is not None:
            mark(self.record_store.content_hash())

    def _run_merged(self, work: List[_BatchRequest]) -> None:
        """Process queued requests as one batch (call with self.lock held).

        Serializability: merging applies every request's deletes before one
        shared scoring pass, so a merged group whose requests delete and
        upsert the SAME record id with opposite polarity (req A deletes X /
        adds Y merged with req B deletes Y / adds X) would end in a state
        matching no serial order.  Such conflicts split the queue: the
        merged group flushes (deletes + one scoring pass) before the
        conflicting request starts a new group, making the outcome equal to
        executing the groups -- and therefore the requests -- in queue
        order.  Same-polarity overlap needs no split: repeated deletes
        retract idempotently and repeated upserts index in queue order
        inside one scoring pass (later content wins), as serial execution.
        """
        group: List[_BatchRequest] = []
        group_records: List[List[Record]] = []
        deleted_ids: set = set()
        live_ids: set = set()

        def flush():
            nonlocal group, group_records, deleted_ids, live_ids
            all_live: List[Record] = []
            any_deleted = False
            ok: List[_BatchRequest] = []
            for req, records in zip(group, group_records):
                put_done = False
                try:
                    if self.record_store is not None:
                        self.record_store.put_many(records)
                        # store rows durable, index/scoring/links not yet
                        # applied
                        faults.check_crash("post_store_put")
                        put_done = True
                    deleted = [r for r in records if r.is_deleted()]
                    for record in deleted:
                        self.index.index(record)
                    self._retract_links_for(deleted)
                except Exception as e:  # store errors stay per-request
                    if put_done:
                        # the store committed rows the index will never
                        # apply: latch the divergence so no later stamp
                        # can mask it (_mark_synced honors the latch)
                        self._store_dirty = True
                    req.error = e
                    req.event.set()
                    continue
                any_deleted = any_deleted or bool(deleted)
                all_live.extend(r for r in records if not r.is_deleted())
                ok.append(req)
            try:
                if any_deleted:
                    self.index.commit()
                    # seal the retraction writes even when no scoring pass
                    # (and thus no listener batch_done/commit) follows
                    self.link_database.commit()
                if all_live:
                    self.processor.deduplicate(all_live)
                if ok:
                    self._mark_synced()
            except Exception as e:
                if self.record_store is not None and ok:
                    # the group's store writes committed but the shared
                    # scoring/commit pass did not complete
                    self._store_dirty = True
                for req in ok:
                    req.error = e
            finally:
                for req in ok:
                    req.event.set()
            group, group_records = [], []
            deleted_ids, live_ids = set(), set()

        for req in work:
            try:  # conversion errors stay per-request
                datasource = self.datasources[req.dataset_id]
                records = datasource.records_for_batch(req.entities)
            except Exception as e:
                req.error = e
                req.event.set()
                continue
            req_deleted = {r.record_id for r in records if r.is_deleted()}
            req_live = {r.record_id for r in records if not r.is_deleted()}
            if (req_deleted & live_ids) or (req_live & deleted_ids):
                flush()
            group.append(req)
            group_records.append(records)
            deleted_ids |= req_deleted
            live_ids |= req_live
        if group:
            flush()

    def process_batch(self, dataset_id: str, entities: Sequence[dict],
                      http_transform: bool = False) -> List[dict]:
        """Ingest a batch and run matching (call with ``self.lock`` held);
        returns the transform response rows when ``http_transform``."""
        t_hold = time.monotonic()
        records = self.datasources[dataset_id].records_for_batch(entities)
        live = [r for r in records if not r.is_deleted()]
        deleted = [r for r in records if r.is_deleted()]
        put_done = False
        try:
            if http_transform:
                self.index.set_indexing_disabled(True)
                self.listener.set_link_database_updates_disabled(True)
            else:
                if self.record_store is not None:
                    # the durable source of truth first; the corpus is a
                    # replayable cache of this store
                    self.record_store.put_many(records)
                    faults.check_crash("post_store_put")
                    put_done = True
                for record in deleted:
                    # tombstone in the index (still resolvable by the
                    # feed's point lookups); links retract batched below
                    self.index.index(record)
                self._retract_links_for(deleted)
            if deleted and not http_transform:
                self.index.commit()
                # seal the retraction writes of a delete-only batch
                self.link_database.commit()
            if live or http_transform:
                self.processor.deduplicate(live)
            if http_transform:
                return self._transform_response(entities)
            self._mark_synced()
            return []
        except BaseException:
            if put_done:
                self._store_dirty = True
            raise
        finally:
            self.note_lock_hold(time.monotonic() - t_hold)
            self.index.set_indexing_disabled(False)
            self.listener.set_link_database_updates_disabled(False)

    def _transform_response(self, entities: Sequence[dict]) -> List[dict]:
        rows = []
        for entity in entities:
            row = dict(entity)
            entity_id = entity.get("_id")
            entity_id = str(entity_id) if entity_id is not None else None
            row["duke_links"] = self.listener.get_links_for_entity(entity_id)
            rows.append(row)
        return rows

    # -- incremental feed (call with self.lock held) ------------------------

    def links_since(self, since: int = 0) -> List[dict]:
        """The full materialized feed, every link changed after ``since``
        in (timestamp, id1, id2) order (the HTTP layer streams via
        ``links_page``; this serves the HTTP/1.0 path and tests).
        Internally paged, so a lazy record mirror resolves endpoints in
        bounded batched prefetches instead of one SELECT per link end."""
        rows: List[dict] = []
        cursor = since
        while True:
            page, cursor = self.links_page(cursor, 5000)
            if not page:
                return rows
            rows.extend(page)

    def links_page(self, since: int, limit: int):
        """One bounded feed page: (rows, next_cursor).

        The HTTP layer streams a large ``?since=`` poll as a sequence of
        these pages, re-taking the workload lock per page, so a long
        backlog never holds the lock for the whole response (the
        reference holds it across the entire row loop, App.java:827-874).
        ``next_cursor`` is the last row's timestamp (strictly-greater-than
        feed semantics; the link databases extend a page over timestamp
        ties); an empty ``rows`` means the feed is drained."""
        return links_feed_page(self.link_database, self.index, since, limit)

    def save_corpus_snapshot(self) -> None:
        """Persist the corpus snapshot (call with ``self.lock`` held; a
        no-op for the host backend).  Best-effort: a failed save only logs
        -- the record store stays the source of truth and the next start
        replays."""
        if (self.record_store is None
                or not hasattr(self.index, "snapshot_save")):
            return
        try:
            # a snapshot must never be newer than the link rows its
            # batches produced
            self.link_database.drain()
            self.index.snapshot_save(_snapshot_path(self.config.data_folder))
        except Exception:
            logger.exception("corpus snapshot save failed (replay will "
                             "rebuild)")

    def close(self, save_snapshot: bool = True) -> None:
        """Save the corpus snapshot (persistent device workloads), then
        release the finalizer, the index, the link database (draining
        write-behind: the journal is left empty) and the record store
        (call with ``self.lock`` held)."""
        self.closed = True
        if save_snapshot:
            self.save_corpus_snapshot()
        finalizer = getattr(self.processor, "finalizer", None)
        if finalizer is not None:
            finalizer.shutdown()
        self.index.close()
        self.link_database.close()
        if self.record_store is not None:
            self.record_store.close()


BACKENDS = ("device", "ann", "sharded", "sharded-brute", "host")


def _restore(index: CandidateIndex, store: RecordStore,
             data_folder: str) -> Optional[str]:
    """Bring the index back from the store: a device corpus from its
    snapshot first (with a lazy store-backed record mirror), else a full
    replay, after which a device corpus is copied to the device in the
    background.  The host index has no snapshot and always replays.
    Returns the route taken, or None when the store is empty."""
    device = isinstance(index, DeviceIndex)
    snap = _snapshot_path(data_folder)
    if device and os.path.exists(snap) and index.snapshot_load(
            snap, LazyRecordMap(store), content_hash=store.content_hash()):
        return "snapshot"  # snapshot_load kicked the warm upload
    route = None
    records = {r.record_id: r for r in store.all_records()}
    if records:
        route = "replay"
        for record in records.values():
            index.index(record)
        index.commit()
        if device:
            index.warm_upload_async()
    if device:
        index.mark_store_synced(store.content_hash())
    return route


def build_workload(wc: WorkloadConfig, sc: ServiceConfig, *,
                   backend: str = "device", device="cuda",
                   persistent: bool = True) -> Workload:
    """Assemble a workload: candidate index + processor + listener + link
    DB (+ record store when ``persistent``).

    ``backend``: ``"device"`` (exact brute-force scoring,
    engine.device_matcher) or ``"ann"`` (embedding cosine blocking + exact
    rescoring, engine.ann_matcher), on the torch ``device``; their mesh
    twins ``"sharded-brute"`` and ``"sharded"`` (engine.sharded_matcher),
    whose corpus splits over the process-wide serving mesh of
    ``device``'s type; or ``"host"``
    (the Lucene-parity inverted index + the host ``Processor``, the JAX
    package's default and conformance backend), which runs no device code:
    it neither resolves nor touches ``device``.
    ``persistent`` (the default): the link database is the config's
    ``link-database-type`` in the workload's data folder (``h2``: SQLite
    behind write-behind and its journal), records persist in
    ``records.sqlite`` and the corpus restores from the snapshot or the
    store; ``persistent=False`` keeps everything in memory.
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}: the PyTorch port serves only the "
            "'sharded', 'sharded-brute', 'device', 'ann' and 'host' "
            "backends")
    if backend == "host":
        index, processor_cls = InvertedIndex(wc.duke, sc.tunables), Processor
    elif backend == "ann":
        from .ann_matcher import AnnIndex, AnnProcessor

        index = AnnIndex(wc.duke, device=resolve_device(device))
        processor_cls = AnnProcessor
    elif backend == "sharded":
        from .sharded_matcher import ShardedAnnIndex, ShardedAnnProcessor

        index = ShardedAnnIndex(wc.duke, device=resolve_device(device))
        processor_cls = ShardedAnnProcessor
    elif backend == "sharded-brute":
        from .sharded_matcher import ShardedDeviceIndex, ShardedDeviceProcessor

        index = ShardedDeviceIndex(wc.duke, device=resolve_device(device))
        processor_cls = ShardedDeviceProcessor
    else:
        index = DeviceIndex(wc.duke, device=resolve_device(device))
        processor_cls = DeviceProcessor
    processor = processor_cls(
        wc.duke, index, group_filtering=wc.is_record_linkage,
        threads=sc.threads,
    )
    link_database = None
    record_store: Optional[RecordStore] = None
    route = None
    try:
        link_database = create_link_database(
            wc.link_database_type, wc.data_folder if persistent else None,
            is_record_linkage=wc.is_record_linkage)
        # per-workload link-mode from the XML; ONE_TO_ONE env overrides
        one_to_one = (wc.enforce_one_to_one if sc.one_to_one is None
                      else sc.one_to_one and wc.is_record_linkage)
        listener = ServiceMatchListener(
            wc.name, link_database, kind=wc.kind, one_to_one=one_to_one,
            record_resolver=index.find_record_by_id,
        )
        processor.add_match_listener(listener)
        if persistent and wc.data_folder:
            record_store = SqliteRecordStore(
                os.path.join(wc.data_folder, "records.sqlite"))
            route = _restore(index, record_store, wc.data_folder)
    except BaseException:
        # a half-built workload never reaches the caller: release whatever
        # opened (the finalizer's threads too)
        finalizer = getattr(processor, "finalizer", None)
        if finalizer is not None:
            finalizer.shutdown()
        for resource in (link_database, record_store):
            if resource is not None:
                try:
                    resource.close()
                except Exception:
                    pass
        raise
    return Workload(wc, index, processor, listener, link_database,
                    record_store, route)
