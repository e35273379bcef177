"""Ingest datasource: JSON entity batches -> Records.

Reproduces IncrementalDataSource.java:36-102: each entity requires a
non-empty ``_id``; configured columns map JSON fields through optional
cleaners into properties; the record id is synthesized as
``[groupNo__]datasetId__entityId`` and the hidden properties
(dukeOriginalEntityId, dukeDatasetId, dukeGroupNo, dukeDeleted) are attached.

Divergence (SURVEY.md quirk Q1, deliberate fix): the reference crashes on
multi-element array values (it stringifies the *array* per element,
IncrementalDataSource.java:69-73); here each element is converted
individually, so array-valued columns behave as multi-valued properties.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from ..core.config import DataSourceConfig
from ..core.records import (
    DATASET_ID_PROPERTY_NAME,
    DELETED_PROPERTY_NAME,
    GROUP_NO_PROPERTY_NAME,
    ID_PROPERTY_NAME,
    ORIGINAL_ENTITY_ID_PROPERTY_NAME,
    Record,
)


class IngestError(Exception):
    pass


def _json_value_to_string(value) -> Optional[str]:
    """JSON scalar -> string, Gson getAsString conventions: booleans are
    'true'/'false', numbers use their plain representation."""
    if value is None:
        return None
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return str(value)


class IncrementalDataSource:
    def __init__(self, config: DataSourceConfig):
        self.config = config
        self.dataset_id = config.dataset_id
        self.group_no = config.group_no

    def record_id_for_entity(self, entity: dict) -> str:
        """The store record id this datasource will synthesize for
        ``entity`` (``[groupNo__]datasetId__entityId``) — THE one copy of
        the id rule, shared with ``record_for_entity`` so the federation
        router's digest-range routing key (federation.ranges.route_key
        over this id) can never drift from the id the ingest path
        actually stores."""
        entity_id = _json_value_to_string(entity.get("_id"))
        if not entity_id:
            raise IngestError("Got an entity with no '_id' attribute!")
        if self.group_no is not None:
            return f"{self.group_no}__{self.dataset_id}__{entity_id}"
        return f"{self.dataset_id}__{entity_id}"

    def record_for_entity(self, entity: dict) -> Record:
        entity_id = _json_value_to_string(entity.get("_id"))
        if not entity_id:
            raise IngestError("Got an entity with no '_id' attribute!")

        record = Record()
        for column in self.config.columns:
            raw = entity.get(column.name)
            if raw is None:
                continue
            values = raw if isinstance(raw, list) else [raw]
            for v in values:
                s = _json_value_to_string(v)
                if s is None or s == "":
                    continue
                if column.cleaner is not None:
                    s = column.cleaner(s)
                record.add_value(column.property, s)

        if self.group_no is not None:
            record.add_value(GROUP_NO_PROPERTY_NAME, str(self.group_no))
        record_id = self.record_id_for_entity(entity)

        record.add_value(ID_PROPERTY_NAME, record_id)
        record.add_value(ORIGINAL_ENTITY_ID_PROPERTY_NAME, entity_id)
        record.add_value(DATASET_ID_PROPERTY_NAME, self.dataset_id)

        if entity.get("_deleted"):
            record.add_value(DELETED_PROPERTY_NAME, "true")
        return record

    def records_for_batch(self, batch: Iterable[dict]) -> List[Record]:
        return [self.record_for_entity(e) for e in batch]
