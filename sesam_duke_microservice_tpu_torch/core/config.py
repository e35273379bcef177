"""Two-level XML config parser.

Reproduces the reference's config system (App.java:227-647): an outer
``<DukeMicroService dataFolder=...>`` element containing ``<Deduplication
name=...>`` and ``<RecordLinkage name=... link-mode=... link-database-type=...>``
workloads, each wrapping a ``<duke>`` element in Duke 1.2's own XML schema
(``<object>`` bean definitions, ``<schema>`` with threshold + properties,
``<data-source>`` with columns/cleaners, ``<group>`` blocks for linkage —
see testdukeconfig.xml).  The service injects hidden properties into every
schema (ID, dukeDatasetId, dukeOriginalEntityId, dukeDeleted, and dukeGroupNo
for linkage — App.java:309-325 / 426-446) and applies the same validation
rules (no user id property App.java:303-307; no '_id'/'id' columns
App.java:378-384; datasource class + dataset-id checks App.java:360-394).

Divergences from the reference (documented, deliberate):
  * a missing ``link-mode`` attribute raises ``ConfigError`` with a clear
    message (the reference NPEs, App.java:411);
  * ``link-database-type="sqlite"`` is accepted as an alias for ``"h2"``
    (our durable backend is SQLite rather than embedded H2).
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from . import cleaners as cleaners_mod
from . import comparators as comparators_mod
from .records import (
    DATASET_ID_PROPERTY_NAME,
    DELETED_PROPERTY_NAME,
    GROUP_NO_PROPERTY_NAME,
    ID_PROPERTY_NAME,
    ORIGINAL_ENTITY_ID_PROPERTY_NAME,
    Lookup,
    Property,
)

DEDUP_DATASOURCE_CLASS = "io.sesam.dukemicroservice.IncrementalDeduplicationDataSource"
LINKAGE_DATASOURCE_CLASS = "io.sesam.dukemicroservice.IncrementalRecordLinkageDataSource"


class ConfigError(Exception):
    pass


@dataclass
class Column:
    name: str
    property: str
    cleaner: Optional[Callable[[str], Optional[str]]] = None
    cleaner_name: Optional[str] = None


@dataclass
class DataSourceConfig:
    dataset_id: str
    columns: List[Column]
    group_no: Optional[int] = None


@dataclass
class DukeSchema:
    """Parsed inner <duke> element: schema + datasources."""

    threshold: float
    maybe_threshold: Optional[float]
    properties: List[Property]
    data_sources: List[DataSourceConfig]          # dedup: flat list
    groups: List[List[DataSourceConfig]] = field(default_factory=list)  # linkage

    def property_by_name(self, name: str) -> Optional[Property]:
        for p in self.properties:
            if p.name == name:
                return p
        return None

    def comparison_properties(self) -> List[Property]:
        return [p for p in self.properties if not p.id_property and not p.ignore]

    def lookup_properties(self) -> List[Property]:
        """Properties used for candidate retrieval.

        Default: every comparison property; explicit lookup="false"/"ignore"
        excludes a property (cf. IncrementalLuceneDatabase.java:481-487).
        """
        return [
            p
            for p in self.comparison_properties()
            if p.lookup not in (Lookup.FALSE, Lookup.IGNORE)
        ]


@dataclass
class MatchTunables:
    """Env-driven candidate-search tunables (App.java:550-564 defaults)."""

    min_relevance: float = 0.9
    fuzzy_search: bool = False
    max_search_hits: int = 10

    @classmethod
    def from_env(cls, env=os.environ) -> "MatchTunables":  # dukecheck: ignore[DK301] injectable env= seam (tests pass dicts); reference parity requires raw strings
        t = cls()
        if env.get("MIN_RELEVANCE"):
            t.min_relevance = float(env["MIN_RELEVANCE"])
        if env.get("FUZZY_SEARCH"):
            t.fuzzy_search = env["FUZZY_SEARCH"].strip().lower() == "true"
        if env.get("MAX_SEARCH_HITS"):
            t.max_search_hits = int(env["MAX_SEARCH_HITS"])
        return t


@dataclass
class WorkloadConfig:
    name: str
    kind: str                       # "deduplication" | "recordlinkage"
    duke: DukeSchema
    link_database_type: str         # "h2" | "in-memory"
    # linkage only: "one-to-one" (enforced per workload) or "many-to-many"
    # (accepted extension value — every above-threshold pair links, the
    # reference's de-facto behavior since its flag is vestigial, quirk Q5)
    link_mode: Optional[str] = None
    data_folder: Optional[str] = None

    @property
    def is_record_linkage(self) -> bool:
        return self.kind == "recordlinkage"

    @property
    def enforce_one_to_one(self) -> bool:
        """Whether THIS workload's XML asks for one-to-one enforcement.

        The reference parses link-mode="one-to-one" per <RecordLinkage>
        element (App.java:113-120) but never reads the flag (quirk Q5);
        here the attribute is the thing that controls behavior, so two
        linkage workloads in one config can run different modes.  The
        ONE_TO_ONE env flag overrides globally (see ServiceConfig)."""
        return self.is_record_linkage and self.link_mode == "one-to-one"


@dataclass
class ServiceConfig:
    config_string: str
    data_folder: str
    deduplications: Dict[str, WorkloadConfig]
    record_linkages: Dict[str, WorkloadConfig]
    threads: int = 1
    profile: bool = False
    tunables: MatchTunables = field(default_factory=MatchTunables)
    # Global one-to-one override: None (default) defers to each linkage
    # workload's link-mode attribute (WorkloadConfig.enforce_one_to_one);
    # ONE_TO_ONE=1 forces enforcement on for every linkage workload,
    # ONE_TO_ONE=0 forces it off (restoring the reference's vestigial-flag
    # behavior, quirk Q5).
    one_to_one: Optional[bool] = None


def _parse_number(text: str, what: str, label: str) -> float:
    try:
        return float(text)
    except (TypeError, ValueError):
        raise ConfigError(f"Invalid {what} value '{text}' in the {label}") from None


def _instantiate_object(class_name: str, params: Dict[str, str]):
    """Instantiate an <object> bean: comparator or cleaner."""
    if comparators_mod.has_comparator(class_name):
        obj = comparators_mod.make_comparator(class_name)
        for pname, pvalue in params.items():
            try:
                obj.set_param(pname, pvalue)
            except (KeyError, ValueError) as e:
                raise ConfigError(
                    f"Invalid param '{pname}'='{pvalue}' for <object> "
                    f"class '{class_name}': {e}"
                ) from None
        return obj
    if class_name.endswith("RegexpCleaner"):
        return cleaners_mod.RegexpCleaner(
            params.get("regexp", ".*"), int(params.get("group-no", 1) or 1)
        )
    if cleaners_mod.has_cleaner(class_name):
        return cleaners_mod.get_cleaner(class_name)
    raise ConfigError(f"Unknown <object> class '{class_name}'")


def _resolve_comparator(name: str, objects: Dict[str, object]):
    """Resolve a <comparator> reference to an instance.

    Duke's ConfigLoader semantics: a reference matching a named <object> uses
    that (parameterized) instance; anything else instantiates a fresh
    comparator with default params.  Note the bundled demo config defines an
    'AreaComparator' object but references the class name, so its min-ratio
    is never applied — faithfully reproduced here.
    """
    if name in objects:
        obj = objects[name]
        if not isinstance(obj, comparators_mod.Comparator):
            raise ConfigError(f"<object> '{name}' referenced as comparator is not one")
        return obj
    if comparators_mod.has_comparator(name):
        return comparators_mod.make_comparator(name)
    raise ConfigError(f"Unknown comparator '{name}'")


def _resolve_cleaner(name: str, objects: Dict[str, object]):
    if name in objects:
        obj = objects[name]
        if not callable(obj):
            raise ConfigError(f"<object> '{name}' referenced as cleaner is not callable")
        return obj
    if cleaners_mod.has_cleaner(name):
        return cleaners_mod.get_cleaner(name)
    raise ConfigError(f"Unknown cleaner '{name}'")


def _parse_params(element: ET.Element) -> Dict[str, str]:
    params = {}
    for p in element.findall("param"):
        params[p.get("name", "")] = p.get("value", "")
    return params


def _parse_data_source(ds_el: ET.Element, objects: Dict[str, object],
                       expected_class: str, workload_label: str) -> DataSourceConfig:
    cls = ds_el.get("class", "")
    if cls != expected_class:
        raise ConfigError(
            f"Got a DataSource of the unsupported type '{cls}' in the {workload_label}! "
            f"(expected '{expected_class}')"
        )
    params = _parse_params(ds_el)
    dataset_id = params.get("dataset-id", "")
    if not dataset_id:
        raise ConfigError(
            f"Got a DataSource with no datasetId property in the {workload_label}!"
        )
    columns = []
    for col_el in ds_el.findall("column"):
        col_name = col_el.get("name", "")
        if col_name.lower() in ("_id", "id"):
            raise ConfigError(
                f"The DataSource '{dataset_id}' in the {workload_label} contained "
                f"an '{col_name}' column!"
            )
        prop = col_el.get("property", "")
        if not prop:
            raise ConfigError(
                f"Column '{col_name}' in DataSource '{dataset_id}' has no property"
            )
        cleaner_name = col_el.get("cleaner")
        cleaner = _resolve_cleaner(cleaner_name, objects) if cleaner_name else None
        columns.append(Column(col_name, prop, cleaner, cleaner_name))
    return DataSourceConfig(dataset_id=dataset_id, columns=columns)


def parse_duke_element(duke_el: ET.Element, *, is_record_linkage: bool,
                       workload_label: str) -> DukeSchema:
    """Parse the inner <duke> element (Duke 1.2 config schema subset)."""
    objects: Dict[str, object] = {}
    for obj_el in duke_el.findall("object"):
        name = obj_el.get("name")
        cls = obj_el.get("class", "")
        if not name:
            raise ConfigError(f"<object> without a name in the {workload_label}")
        objects[name] = _instantiate_object(cls, _parse_params(obj_el))

    schema_el = duke_el.find("schema")
    if schema_el is None:
        raise ConfigError(f"The {workload_label} <duke> element has no <schema>!")

    thr_el = schema_el.find("threshold")
    if thr_el is None or thr_el.text is None:
        raise ConfigError(f"The {workload_label} schema has no <threshold>!")
    threshold = _parse_number(thr_el.text.strip(), "threshold", workload_label)
    maybe_el = schema_el.find("maybe-threshold")
    maybe_threshold = (
        _parse_number(maybe_el.text.strip(), "maybe-threshold", workload_label)
        if maybe_el is not None and maybe_el.text
        else None
    )

    properties: List[Property] = []
    for prop_el in schema_el.findall("property"):
        ptype = prop_el.get("type", "")
        name_el = prop_el.find("name")
        if name_el is None or not (name_el.text or "").strip():
            raise ConfigError(f"A <property> in the {workload_label} has no <name>")
        pname = name_el.text.strip()
        if ptype == "id":
            # mirrors App.java:303-307 — the service owns record identity
            raise ConfigError(
                f"The schema contained an 'id'-property: '{pname}'"
            )
        if ptype == "ignore":
            properties.append(Property(pname, ignore=True))
            continue
        comp_el = prop_el.find("comparator")
        comparator = None
        if comp_el is not None and (comp_el.text or "").strip():
            comparator = _resolve_comparator(comp_el.text.strip(), objects)
        low_el = prop_el.find("low")
        high_el = prop_el.find("high")
        low = (
            _parse_number(low_el.text.strip(), "low", workload_label)
            if low_el is not None and low_el.text else 0.3
        )
        high = (
            _parse_number(high_el.text.strip(), "high", workload_label)
            if high_el is not None and high_el.text else 0.95
        )
        lookup_raw = prop_el.get("lookup", "default")
        try:
            lookup = Lookup(lookup_raw)
        except ValueError:
            raise ConfigError(
                f"Invalid lookup value '{lookup_raw}' on property '{pname}' "
                f"in the {workload_label}"
            ) from None
        properties.append(Property(pname, comparator, low, high, lookup=lookup))

    # Hidden-property injection (App.java:309-325 / 426-446)
    properties.append(Property(ID_PROPERTY_NAME, id_property=True))
    properties.append(Property(DATASET_ID_PROPERTY_NAME, ignore=True))
    properties.append(Property(ORIGINAL_ENTITY_ID_PROPERTY_NAME, ignore=True))
    if is_record_linkage:
        properties.append(Property(GROUP_NO_PROPERTY_NAME, ignore=True))
    properties.append(Property(DELETED_PROPERTY_NAME, ignore=True))

    data_sources: List[DataSourceConfig] = []
    groups: List[List[DataSourceConfig]] = []
    if is_record_linkage:
        group_els = duke_el.findall("group")
        if len(group_els) != 2:
            raise ConfigError(
                f"The {workload_label} must have exactly two <group> elements "
                f"(got {len(group_els)})"
            )
        for group_no, group_el in enumerate(group_els, start=1):
            group_sources = []
            for ds_el in group_el.findall("data-source"):
                ds = _parse_data_source(
                    ds_el, objects, LINKAGE_DATASOURCE_CLASS, workload_label
                )
                ds.group_no = group_no
                group_sources.append(ds)
            if not group_sources:
                raise ConfigError(
                    f"Got zero datasources for group {group_no} in the {workload_label}!"
                )
            groups.append(group_sources)
            data_sources.extend(group_sources)
    else:
        for ds_el in duke_el.findall("data-source"):
            data_sources.append(
                _parse_data_source(ds_el, objects, DEDUP_DATASOURCE_CLASS, workload_label)
            )
        if not data_sources:
            raise ConfigError(f"Got zero datasources in the {workload_label}!")

    return DukeSchema(
        threshold=threshold,
        maybe_threshold=maybe_threshold,
        properties=properties,
        data_sources=data_sources,
        groups=groups,
    )


def _find_duke_child(workload_el: ET.Element, workload_label: str) -> ET.Element:
    duke_el = None
    for child in workload_el:
        if child.tag == "duke":
            duke_el = child
        else:
            raise ConfigError(
                f"Unknown element '{child.tag}' found in the {workload_label}!"
            )
    if duke_el is None:
        raise ConfigError(f"The {workload_label} didn't contain a <duke> element!")
    return duke_el


def _link_database_type(el: ET.Element, name: str) -> str:
    ldt = el.get("link-database-type", "") or "h2"
    if ldt == "sqlite":
        ldt = "h2"
    if ldt not in ("h2", "in-memory"):
        raise ConfigError(f"Got an unknown 'link-database-type' value: '{ldt}'")
    return ldt


def parse_config(config_string: str, env=os.environ) -> ServiceConfig:  # dukecheck: ignore[DK301] injectable env= seam
    """Parse a full service config string (the POST /config payload shape)."""
    try:
        root = ET.fromstring(config_string)
    except ET.ParseError as e:
        raise ConfigError(f"Invalid XML: {e}") from e

    if root.tag == "DukeMicroService":
        service_els = [root]
    else:
        service_els = list(root.iter("DukeMicroService"))
    if len(service_els) == 0:
        raise ConfigError("The configfile didn't contain a 'DukeMicroService' entity!")
    if len(service_els) > 1:
        raise ConfigError("The configfile contain more than one 'DukeMicroService' entity!")
    service_el = service_els[0]

    data_folder = service_el.get("dataFolder") or os.path.join(os.getcwd(), "data")

    threads = 1
    threads_env = env.get("THREADS")
    if threads_env and re.fullmatch(r"\d+", threads_env):
        threads = int(threads_env)
    profile = env.get("PROFILE") == "1"
    oto_env = (env.get("ONE_TO_ONE") or "").strip().lower()
    one_to_one = (True if oto_env in ("1", "true")
                  else False if oto_env in ("0", "false") else None)
    tunables = MatchTunables.from_env(env)

    deduplications: Dict[str, WorkloadConfig] = {}
    record_linkages: Dict[str, WorkloadConfig] = {}
    for child in service_el:
        if child.tag == "Deduplication":
            name = child.get("name")
            if not name:
                raise ConfigError("A <Deduplication> element has no name attribute")
            label = f"deduplication '{name}'"
            duke = parse_duke_element(
                _find_duke_child(child, label), is_record_linkage=False, workload_label=label
            )
            deduplications[name] = WorkloadConfig(
                name=name,
                kind="deduplication",
                duke=duke,
                link_database_type=_link_database_type(child, name),
                data_folder=os.path.join(data_folder, "deduplication", name),
            )
        elif child.tag == "RecordLinkage":
            name = child.get("name")
            if not name:
                raise ConfigError("A <RecordLinkage> element has no name attribute")
            label = f"recordLinkage '{name}'"
            link_mode = child.get("link-mode")
            if link_mode is None:
                raise ConfigError(
                    f"The {label} has no link-mode attribute (must be "
                    f"'one-to-one' or 'many-to-many')"
                )
            if link_mode not in ("one-to-one", "many-to-many"):
                # documented divergence: the reference accepts only
                # "one-to-one" (App.java:113-120); "many-to-many" is the
                # extension value naming its actual (unenforced) behavior
                raise ConfigError(
                    f"Invalid link-mode '{link_mode}' specified for the '{name}' recordlinkage."
                )
            duke = parse_duke_element(
                _find_duke_child(child, label), is_record_linkage=True, workload_label=label
            )
            record_linkages[name] = WorkloadConfig(
                name=name,
                kind="recordlinkage",
                duke=duke,
                link_database_type=_link_database_type(child, name),
                link_mode=link_mode,
                data_folder=os.path.join(data_folder, "recordLinkage", name),
            )
        else:
            raise ConfigError(
                f"Unknown element '{child.tag}' found in the configuration file!"
            )

    return ServiceConfig(
        config_string=config_string,
        data_folder=data_folder,
        deduplications=deduplications,
        record_linkages=record_linkages,
        threads=threads,
        profile=profile,
        tunables=tunables,
        one_to_one=one_to_one,
    )


DEFAULT_CONFIG_RESOURCE = os.path.join(
    os.path.dirname(__file__), "..", "resources", "testdukeconfig.xml"
)


def load_default_config(env=os.environ) -> ServiceConfig:  # dukecheck: ignore[DK301] injectable env= seam
    """Load CONFIG_STRING from the environment, else the bundled demo config
    (mirrors App.java:200-224)."""
    config_string = env.get("CONFIG_STRING")
    if not config_string:
        with open(os.path.abspath(DEFAULT_CONFIG_RESOURCE), "r", encoding="utf-8") as f:
            config_string = f.read()
    return parse_config(config_string, env=env)
