"""The matching semantics of a Duke microservice config, read with the
standard library alone.

Only what the reference needs: the workload's kind, the threshold, each
comparison property with its comparator, low and high, and each data
source's dataset id, column map, cleaners and group number.  A comparator or a cleaner this reference has no longhand for is
refused, so a config it cannot judge never passes as judged.

Cleaners: Duke's ``LowerCaseNormalizeCleaner`` (lower case, runs of
white space made one space, trimmed) and the countries example's
``CountryNameCleaner`` and ``CapitalCleaner``, which on a value of one
word of the letters a-z do what the first does (they further strip
parenthesised notes, prefixes such as "republic of", a trailing " city"
and map alias spellings, none of which a single plain word has).  The
reference takes the two examples only on such values and refuses any
other (``clean``).
"""

import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Prop:
    name: str
    kind: str            # "levenshtein", "numeric" or "exact"
    low: float
    high: float
    min_ratio: float = 0.0


@dataclass
class Source:
    dataset: str
    columns: Dict[str, str]      # JSON field -> property name
    group: Optional[int] = None
    cleaners: Dict[str, str] = field(default_factory=dict)  # field -> kind


@dataclass
class Workload:
    kind: str                    # "deduplication" or "recordlinkage"
    name: str
    threshold: float
    props: List[Prop]
    sources: List[Source]
    maybe_threshold: Optional[float] = None
    link_database_type: str = "h2"
    extra: dict = field(default_factory=dict)

    def record_id(self, dataset: str, entity_id: str) -> str:
        """The record id a data source gives an entity (Duke's
        IncrementalDataSource: ``[group__]dataset__entity``)."""
        for s in self.sources:
            if s.dataset == dataset:
                if s.group is not None:
                    return f"{s.group}__{dataset}__{entity_id}"
                return f"{dataset}__{entity_id}"
        raise KeyError(dataset)

    def group_of(self, dataset: str) -> Optional[int]:
        for s in self.sources:
            if s.dataset == dataset:
                return s.group
        raise KeyError(dataset)


_CLEANERS = {"lowercasenormalizecleaner": "lowercase",
             "countrynamecleaner": "word", "capitalcleaner": "word"}
_WS = re.compile(r"\s+")
_WORD = re.compile(r"[a-z]+")


def clean(kind: Optional[str], value: str) -> str:
    """A value as the named cleaner leaves it (None: no cleaner)."""
    if kind is None:
        return value
    value = _WS.sub(" ", value.lower()).strip()
    if kind == "word" and not _WORD.fullmatch(value):
        raise ValueError(f"no longhand for an example cleaner on {value!r}")
    return value


_SHORT = {"levenshtein": "levenshtein", "exact": "exact",
          "exactcomparator": "exact", "numeric": "numeric",
          "numericcomparator": "numeric"}


def _kind_of(class_name: str) -> str:
    key = class_name.rsplit(".", 1)[-1].lower()
    if key not in _SHORT:
        raise ValueError(f"no longhand for comparator {class_name!r}")
    return _SHORT[key]


def _sources(el, group):
    out = []
    for ds in el.findall("data-source"):
        dataset = None
        for p in ds.findall("param"):
            if p.get("name") == "dataset-id":
                dataset = p.get("value")
        if not dataset:
            raise ValueError("a data-source without a dataset-id")
        columns, cleaners = {}, {}
        for c in ds.findall("column"):
            columns[c.get("name")] = c.get("property")
            if c.get("cleaner"):
                key = c.get("cleaner").rsplit(".", 1)[-1].lower()
                if key not in _CLEANERS:
                    raise ValueError(f"no longhand for cleaner "
                                     f"{c.get('cleaner')!r}")
                cleaners[c.get("name")] = _CLEANERS[key]
        out.append(Source(dataset, columns, group, cleaners))
    return out


def parse(xml_text: str) -> Workload:
    """The one workload of a ``<DukeMicroService>`` config."""
    root = ET.fromstring(xml_text)
    children = list(root)
    if len(children) != 1:
        raise ValueError("the reference judges a config of one workload")
    wl = children[0]
    kind = {"Deduplication": "deduplication",
            "RecordLinkage": "recordlinkage"}[wl.tag]
    duke = wl.find("duke")
    objects = {}
    for obj in duke.findall("object"):
        params = {p.get("name"): p.get("value") for p in obj.findall("param")}
        objects[obj.get("name")] = (_kind_of(obj.get("class")), params)
    schema = duke.find("schema")
    threshold = float(schema.findtext("threshold"))
    maybe = schema.findtext("maybe-threshold")
    props = []
    for p in schema.findall("property"):
        if p.get("type") == "id":
            continue
        comp = p.findtext("comparator").strip()
        if comp in objects:
            ckind, params = objects[comp]
        else:
            ckind, params = _kind_of(comp), {}
        props.append(Prop(p.findtext("name").strip(), ckind,
                          float(p.findtext("low")), float(p.findtext("high")),
                          float(params.get("min-ratio", 0.0))))
    if kind == "recordlinkage":
        sources = []
        for g, group_el in enumerate(duke.findall("group"), start=1):
            sources.extend(_sources(group_el, g))
    else:
        sources = _sources(duke, None)
    return Workload(kind=kind, name=wl.get("name"), threshold=threshold,
                    props=props, sources=sources,
                    maybe_threshold=float(maybe) if maybe else None,
                    link_database_type=wl.get("link-database-type", "h2"))
