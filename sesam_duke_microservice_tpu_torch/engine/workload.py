"""Per-workload runtime bundle and the ingest/feed flows.

Counterpart of the JAX package's ``engine/workload.py`` for the ``device``
and ``ann`` backends: each workload owns its datasources, the device index
and processor, the match listener, its link database and (when persistent)
its record store, plus a lock serializing access (writers block; the HTTP
layer gives readers 1 s).

Durable state (``persistent=True``, the default) lives in the workload's
data folder, in the JAX package's formats: ``records.sqlite`` (the record
store, the source of truth), ``linkdatabase.sqlite`` (or
``recordlinkdatabase.sqlite``) behind write-behind with its
``.journal``, and ``corpus_snapshot.npz``.  A restart restores the corpus
from the snapshot, else replays the store, then copies the corpus to the
device in the background.

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
from typing import Dict, List, Optional, Sequence

import torch

from ..core.config import ServiceConfig, WorkloadConfig
from ..core.records import (
    DATASET_ID_PROPERTY_NAME,
    ORIGINAL_ENTITY_ID_PROPERTY_NAME,
    Record,
)
from ..links import create_link_database
from ..links.base import LinkDatabase, LinkStatus
from ..service.datasource import IncrementalDataSource
from ..store.records import LazyRecordMap, RecordStore, SqliteRecordStore
from ..utils import faults
from .device_matcher import DeviceIndex, DeviceProcessor
from .listeners import ServiceMatchListener


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


class Workload:
    def __init__(self, config: WorkloadConfig, index: DeviceIndex,
                 processor: DeviceProcessor, listener: ServiceMatchListener,
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
        # sticky store/index divergence latch: a store write committed
        # but its index application failed.  While set, _mark_synced never
        # stamps again in this process (the store hash would cover rows
        # the index never applied); cleared only by a restart replay.
        self._store_dirty = False
        self.datasources: Dict[str, IncrementalDataSource] = {
            ds.dataset_id: IncrementalDataSource(ds)
            for ds in config.duke.data_sources
        }

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
        staleness guard, ``DeviceIndex.mark_store_synced``), unless a
        batch ever left the store ahead of the index."""
        if self.record_store is None or self._store_dirty:
            return
        self.index.mark_store_synced(self.record_store.content_hash())

    def process_batch(self, dataset_id: str, entities: Sequence[dict],
                      http_transform: bool = False) -> List[dict]:
        """Ingest a batch and run matching (call with ``self.lock`` held);
        returns the transform response rows when ``http_transform``."""
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

    def _link_row(self, link) -> dict:
        """One feed row (wire format per App.java:744-770)."""
        r1 = self.index.find_record_by_id(link.id1)
        r2 = self.index.find_record_by_id(link.id2)
        return {
            "_id": f"{link.id1}_{link.id2}".replace(":", "_"),
            "_updated": link.timestamp,
            "_deleted": link.status == LinkStatus.RETRACTED,
            "entity1": (r1.get_value(ORIGINAL_ENTITY_ID_PROPERTY_NAME)
                        if r1 else None),
            "entity2": (r2.get_value(ORIGINAL_ENTITY_ID_PROPERTY_NAME)
                        if r2 else None),
            "dataset1": r1.get_value(DATASET_ID_PROPERTY_NAME) if r1 else None,
            "dataset2": r2.get_value(DATASET_ID_PROPERTY_NAME) if r2 else None,
            "confidence": link.confidence,
        }

    def links_since(self, since: int = 0) -> List[dict]:
        """The materialized feed: every link changed after ``since``, in
        (timestamp, id1, id2) order."""
        links = self.link_database.get_changes_since(since)
        records = self.index.records
        if isinstance(records, LazyRecordMap):
            # resolve the endpoints in batched store reads, not one
            # SELECT per link end
            records.prefetch([rid for l in links for rid in (l.id1, l.id2)])
        return [self._link_row(l) for l in links]

    def save_corpus_snapshot(self) -> None:
        """Persist the corpus snapshot (call with ``self.lock`` held).
        Best-effort: a failed save only logs -- the record store stays the
        source of truth and the next start replays."""
        if self.record_store is None:
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
        """Save the corpus snapshot (persistent workloads), then release
        the finalizer, the link database (draining write-behind: the
        journal is left empty) and the record store."""
        if save_snapshot:
            self.save_corpus_snapshot()
        self.processor.finalizer.shutdown()
        self.link_database.close()
        if self.record_store is not None:
            self.record_store.close()


BACKENDS = ("device", "ann")


def _restore(index: DeviceIndex, store: RecordStore,
             data_folder: str) -> Optional[str]:
    """Bring the index back from the store: the corpus snapshot first
    (with a lazy store-backed record mirror), else a full replay; then the
    corpus is copied to the device in the background.  Returns the route
    taken, or None when the store is empty."""
    snap = _snapshot_path(data_folder)
    if os.path.exists(snap) and index.snapshot_load(
            snap, LazyRecordMap(store), content_hash=store.content_hash()):
        return "snapshot"  # snapshot_load kicked the warm upload
    route = None
    records = {r.record_id: r for r in store.all_records()}
    if records:
        route = "replay"
        for record in records.values():
            index.index(record)
        index.commit()
        index.warm_upload_async()
    index.mark_store_synced(store.content_hash())
    return route


def build_workload(wc: WorkloadConfig, sc: ServiceConfig, *,
                   backend: str = "device", device="cuda",
                   persistent: bool = True) -> Workload:
    """Assemble a workload: device index + processor + listener + link DB
    (+ record store when ``persistent``).

    ``backend``: ``"device"`` (exact brute-force scoring,
    engine.device_matcher) or ``"ann"`` (embedding cosine blocking + exact
    rescoring, engine.ann_matcher), on the torch ``device``.
    ``persistent`` (the default): the link database is the config's
    ``link-database-type`` in the workload's data folder (``h2``: SQLite
    behind write-behind and its journal), records persist in
    ``records.sqlite`` and the corpus restores from the snapshot or the
    store; ``persistent=False`` keeps everything in memory.
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}: the PyTorch port serves only the "
            "'device' and 'ann' backends")
    dev = resolve_device(device)
    if backend == "ann":
        from .ann_matcher import AnnIndex, AnnProcessor

        index, processor_cls = AnnIndex(wc.duke, device=dev), AnnProcessor
    else:
        index, processor_cls = DeviceIndex(wc.duke, device=dev), \
            DeviceProcessor
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
        processor.finalizer.shutdown()
        for resource in (link_database, record_store):
            if resource is not None:
                try:
                    resource.close()
                except Exception:
                    pass
        raise
    return Workload(wc, index, processor, listener, link_database,
                    record_store, route)
