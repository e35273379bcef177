"""Per-workload runtime bundle and the ingest/feed flows.

Counterpart of the JAX package's ``engine/workload.py`` for the ``device``
backend: each workload owns its datasources, the device index and
processor, the match listener and an in-memory link database, plus a lock
serializing access (writers block; the HTTP layer gives readers 1 s).

Flow (App.java:924-1028 / 1065-1179): parse -> records -> partition
deleted/live -> tombstone + retract links for deleted -> deduplicate live.
Deleted records are detected through the hidden ``dukeDeleted`` property
for both workload kinds, and http-transform disables indexing and link
updates for both, as in the JAX package.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence

import torch

from ..core.config import ServiceConfig, WorkloadConfig
from ..core.records import (
    DATASET_ID_PROPERTY_NAME,
    ORIGINAL_ENTITY_ID_PROPERTY_NAME,
    Record,
)
from ..links.base import LinkStatus
from ..links.memory import InMemoryLinkDatabase
from ..service.datasource import IncrementalDataSource
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


class Workload:
    def __init__(self, config: WorkloadConfig, index: DeviceIndex,
                 processor: DeviceProcessor, listener: ServiceMatchListener,
                 link_database: InMemoryLinkDatabase):
        self.config = config
        self.name = config.name
        self.kind = config.kind
        self.index = index
        self.processor = processor
        self.listener = listener
        self.link_database = link_database
        self.lock = threading.Lock()
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

    def process_batch(self, dataset_id: str, entities: Sequence[dict],
                      http_transform: bool = False) -> List[dict]:
        """Ingest a batch and run matching (call with ``self.lock`` held);
        returns the transform response rows when ``http_transform``."""
        records = self.datasources[dataset_id].records_for_batch(entities)
        live = [r for r in records if not r.is_deleted()]
        deleted = [r for r in records if r.is_deleted()]
        try:
            if http_transform:
                self.index.set_indexing_disabled(True)
                self.listener.set_link_database_updates_disabled(True)
            else:
                for record in deleted:
                    # tombstone in the index (still resolvable by the
                    # feed's point lookups); links retract batched below
                    self.index.index(record)
                self._retract_links_for(deleted)
            if deleted and not http_transform:
                self.index.commit()
                self.link_database.commit()
            if live or http_transform:
                self.processor.deduplicate(live)
            if http_transform:
                return self._transform_response(entities)
            return []
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
        return [self._link_row(l)
                for l in self.link_database.get_changes_since(since)]

    def close(self) -> None:
        self.processor.finalizer.shutdown()


def build_workload(wc: WorkloadConfig, sc: ServiceConfig, *,
                   backend: str = "device", device="cuda") -> Workload:
    """Assemble a workload: device index + processor + listener + link DB.

    ``backend`` must be ``"device"`` (exact brute-force scoring on the
    torch ``device``, engine.device_matcher); links live in memory.
    """
    if backend != "device":
        raise ValueError(
            f"unknown backend {backend!r}: the PyTorch port serves only the "
            "'device' backend")
    dev = resolve_device(device)
    index = DeviceIndex(wc.duke, device=dev)
    processor = DeviceProcessor(
        wc.duke, index, group_filtering=wc.is_record_linkage,
        threads=sc.threads,
    )
    link_database = InMemoryLinkDatabase()
    # per-workload link-mode from the XML; ONE_TO_ONE env overrides
    one_to_one = (wc.enforce_one_to_one if sc.one_to_one is None
                  else sc.one_to_one and wc.is_record_linkage)
    listener = ServiceMatchListener(
        wc.name, link_database, kind=wc.kind, one_to_one=one_to_one,
        record_resolver=index.find_record_by_id,
    )
    processor.add_match_listener(listener)
    return Workload(wc, index, processor, listener, link_database)
