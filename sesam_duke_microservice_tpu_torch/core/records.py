"""Core record / property model.

Re-expresses the slice of the Duke 1.2 API that the reference microservice
drives (``Record``/``ModifiableRecord``, ``Property``/``PropertyImpl``,
``Property.Lookup`` — imported at the reference service's
``src/main/java/io/sesam/dukemicroservice/App.java:58-71``) as plain Python types.  These are host-side
bookkeeping objects only; the hot matching path operates on padded token
tensors (see ``ops.tokenize`` / ``engine.device_matcher``), never on these.
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional, Sequence

# Hidden property names the service injects into every schema
# (reference: IncrementalLuceneDatabase.java:449-452).
GROUP_NO_PROPERTY_NAME = "dukeGroupNo"
DATASET_ID_PROPERTY_NAME = "dukeDatasetId"
ORIGINAL_ENTITY_ID_PROPERTY_NAME = "dukeOriginalEntityId"
DELETED_PROPERTY_NAME = "dukeDeleted"
ID_PROPERTY_NAME = "ID"


class SchemaError(Exception):
    """Raised for invalid schema/config combinations (Duke's DukeConfigException)."""


class Lookup(enum.Enum):
    """Per-property candidate-lookup behaviour (Duke's ``Property.Lookup``).

    The blocking database uses this to decide which properties participate in
    candidate retrieval and whether their match is required
    (reference: IncrementalLuceneDatabase.java:481-487).
    """

    DEFAULT = "default"
    REQUIRED = "required"
    TRUE = "true"
    FALSE = "false"
    IGNORE = "ignore"


class Property:
    """A schema property: comparator + [low, high] probability range.

    Mirrors Duke's ``PropertyImpl`` semantics as driven by the reference
    (App.java:309-325): id properties carry record identity and are never
    compared; ignored properties are stored but not compared; the remaining
    properties contribute evidence via ``compare_probability``.
    """

    def __init__(
        self,
        name: str,
        comparator=None,
        low: float = 0.0,
        high: float = 0.0,
        *,
        id_property: bool = False,
        ignore: bool = False,
        lookup: Lookup = Lookup.DEFAULT,
    ):
        self.name = name
        self.comparator = comparator
        self.low = float(low)
        self.high = float(high)
        self.id_property = id_property
        self.ignore = ignore
        self.lookup = lookup

    def compare_probability(self, v1: str, v2: str) -> float:
        """Map comparator similarity to a match probability.

        Duke's ``PropertyImpl.compare``: properties without a comparator are
        neutral (0.5); similarity >= 0.5 maps quadratically into
        ``(0.5, high]``, anything below maps to ``low``.
        """
        if self.comparator is None:
            return 0.5
        sim = self.comparator.compare(v1, v2)
        if sim >= 0.5:
            return ((self.high - 0.5) * (sim * sim)) + 0.5
        return self.low

    def __repr__(self) -> str:
        flags = []
        if self.id_property:
            flags.append("id")
        if self.ignore:
            flags.append("ignore")
        return (
            f"Property({self.name!r}, low={self.low}, high={self.high}"
            + (", " + "|".join(flags) if flags else "")
            + ")"
        )


class Record:
    """A record: property name -> list of string values.

    Equivalent of Duke's ``ModifiableRecord`` as built by the reference's
    ingest datasource (IncrementalDataSource.java:62-100).  Values are always
    strings; empty strings are never stored (Duke's RecordBuilder drops them).
    """

    __slots__ = ("_values", "_digest_cache", "_id_cache")

    def __init__(self, values: Optional[Dict[str, List[str]]] = None):
        self._values: Dict[str, List[str]] = {}
        # memoized content digest (store.records.record_digest): the
        # persistent ingest path digests every record twice (store row +
        # index fold); mutation invalidates
        self._digest_cache: Optional[bytes] = None
        # memoized record_id: the ingest bookkeeping path (corpus append,
        # id_to_row, digests, listeners) reads it several times per record
        self._id_cache: Optional[str] = None
        if values:
            for name, vals in values.items():
                for v in vals:
                    self.add_value(name, v)

    def add_value(self, prop: str, value: Optional[str]) -> None:
        if value is None or value == "":
            return
        self._values.setdefault(prop, []).append(str(value))
        self._digest_cache = None
        self._id_cache = None

    def set_values(self, prop: str, values: List[str]) -> None:
        """Replace one property's value list (invalidates the memos —
        callers must never poke ``_values`` directly).  Empty values are
        dropped like ``add_value`` does, and a fully-empty list removes
        the key: a stored empty list would serialize differently from its
        own store round-trip (add_value never creates one) and trip the
        store/index divergence latch."""
        filtered = [str(v) for v in values if v]
        if filtered:
            self._values[prop] = filtered
        else:
            self._values.pop(prop, None)
        self._digest_cache = None
        self._id_cache = None

    def properties(self) -> Sequence[str]:
        return list(self._values.keys())

    def get_values(self, prop: str) -> List[str]:
        # a COPY: handing out the live list would let callers mutate the
        # record behind add_value's back (the digest memo must see every
        # mutation, and Duke records are value objects)
        return list(self._values.get(prop, ()))

    def get_value(self, prop: str) -> Optional[str]:
        vals = self._values.get(prop)
        return vals[0] if vals else None

    @property
    def record_id(self) -> Optional[str]:
        rid = self._id_cache
        if rid is None:
            rid = self._id_cache = self.get_value(ID_PROPERTY_NAME)
        return rid

    def is_deleted(self) -> bool:
        return self.get_value(DELETED_PROPERTY_NAME) == "true"

    def to_dict(self) -> Dict[str, List[str]]:
        return {k: list(v) for k, v in self._values.items()}

    def __eq__(self, other) -> bool:
        return isinstance(other, Record) and self._values == other._values

    def __repr__(self) -> str:
        return f"Record({self._values!r})"
