"""Feed-row materialization (the feed half of the JAX package's
``links/replica.py``).

``feed_row``/``links_feed_page`` are THE ``?since=`` row materialization:
``engine.workload.Workload`` serves both the streamed feed (one page per
workload-lock hold) and the buffered one through them.  The publisher and
replica link databases of the JAX module wait for replicated serving.
"""

from __future__ import annotations

from ..core.records import (
    DATASET_ID_PROPERTY_NAME,
    ORIGINAL_ENTITY_ID_PROPERTY_NAME,
)
from .base import Link, LinkDatabase, LinkStatus


def feed_row(link: Link, find_record_by_id) -> dict:
    """One ``?since=`` feed row (wire format per App.java:744-770)."""
    r1 = find_record_by_id(link.id1)
    r2 = find_record_by_id(link.id2)
    return {
        "_id": f"{link.id1}_{link.id2}".replace(":", "_"),
        "_updated": link.timestamp,
        "_deleted": link.status == LinkStatus.RETRACTED,
        "entity1": r1.get_value(ORIGINAL_ENTITY_ID_PROPERTY_NAME) if r1 else None,
        "entity2": r2.get_value(ORIGINAL_ENTITY_ID_PROPERTY_NAME) if r2 else None,
        "dataset1": r1.get_value(DATASET_ID_PROPERTY_NAME) if r1 else None,
        "dataset2": r2.get_value(DATASET_ID_PROPERTY_NAME) if r2 else None,
        "confidence": link.confidence,
    }


def links_feed_page(link_db: LinkDatabase, index, since: int, limit: int):
    """One bounded feed page: (rows, next_cursor) — see
    ``Workload.links_page`` for the paging contract.  Lazy record
    mirrors resolve link endpoints through one batched prefetch."""
    links = link_db.get_changes_page(since, limit)
    if not links:
        return [], since
    prefetch = getattr(getattr(index, "records", None), "prefetch", None)
    if prefetch is not None:
        ids = {l.id1 for l in links} | {l.id2 for l in links}
        prefetch(ids)
    return ([feed_row(l, index.find_record_by_id) for l in links],
            links[-1].timestamp)
