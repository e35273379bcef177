"""Cleaner registry — value normalization applied at ingest.

The reference config references Duke 1.2 cleaners by Java class name
(e.g. ``no.priv.garshol.duke.cleaners.LowerCaseNormalizeCleaner`` at
testdukeconfig.xml:66, ``no.priv.garshol.duke.examples.CountryNameCleaner`` at
testdukeconfig.xml:50).  This module provides behavior-compatible Python
implementations registered under both the full Java class names (so existing
reference configs load unchanged) and short snake-case aliases.

Cleaners are host-side: they run once per value at ingest, before
tokenization, so they are not on the device hot path.  A cleaner returns the
cleaned string, or ``None``/``""`` to drop the value entirely (Duke
convention).
"""

from __future__ import annotations

import re
import unicodedata
from typing import Callable, Dict, Optional

Cleaner = Callable[[str], Optional[str]]

_REGISTRY: Dict[str, Cleaner] = {}


def register_cleaner(*names: str):
    def deco(fn: Cleaner) -> Cleaner:
        for name in names:
            _REGISTRY[name] = fn
        return fn

    return deco


def get_cleaner(name: str) -> Cleaner:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown cleaner '{name}'. Known cleaners: {sorted(_REGISTRY)}"
        ) from None


def has_cleaner(name: str) -> bool:
    return name in _REGISTRY


def available_cleaners():
    return sorted(_REGISTRY)


_WS_RE = re.compile(r"\s+")
_PAREN_RE = re.compile(r"\s*\([^)]*\)")


def _strip_accents(value: str) -> str:
    decomposed = unicodedata.normalize("NFKD", value)
    return "".join(ch for ch in decomposed if not unicodedata.combining(ch))


@register_cleaner(
    "no.priv.garshol.duke.cleaners.LowerCaseNormalizeCleaner",
    "LowerCaseNormalizeCleaner",
    "lowercase",
)
def lower_case_normalize(value: str) -> str:
    """Lowercase, strip accents, collapse whitespace, trim."""
    value = _strip_accents(value).lower()
    value = _WS_RE.sub(" ", value).strip()
    return value


@register_cleaner("no.priv.garshol.duke.cleaners.TrimCleaner", "TrimCleaner", "trim")
def trim(value: str) -> str:
    return value.strip()


@register_cleaner(
    "no.priv.garshol.duke.cleaners.DigitsOnlyCleaner", "DigitsOnlyCleaner", "digits"
)
def digits_only(value: str) -> str:
    return "".join(ch for ch in value if ch.isdigit())


@register_cleaner(
    "no.priv.garshol.duke.cleaners.PhoneNumberCleaner",
    "PhoneNumberCleaner",
    "phone",
)
def phone_number(value: str) -> str:
    """Keep digits; normalize an international prefix ('+'/'00') away."""
    digits = "".join(ch for ch in value if ch.isdigit())
    if value.strip().startswith("+"):
        return digits
    if digits.startswith("00"):
        return digits[2:]
    return digits


@register_cleaner(
    "no.priv.garshol.duke.cleaners.FamilyCommaGivenCleaner",
    "FamilyCommaGivenCleaner",
    "family-comma-given",
)
def family_comma_given(value: str) -> str:
    """'Family, Given' -> 'given family', then lowercase-normalize."""
    if "," in value:
        family, _, given = value.partition(",")
        value = f"{given.strip()} {family.strip()}"
    return lower_case_normalize(value)


@register_cleaner(
    "no.priv.garshol.duke.cleaners.NorwegianCompanyNameCleaner",
    "NorwegianCompanyNameCleaner",
    "norwegian-company",
)
def norwegian_company_name(value: str) -> str:
    """Lowercase-normalize and drop Norwegian company-form suffixes (AS, ASA...)."""
    value = lower_case_normalize(value)
    tokens = [t for t in value.split(" ") if t not in {"as", "asa", "ans", "ba", "da", "sa"}]
    return " ".join(tokens)


@register_cleaner(
    "no.priv.garshol.duke.cleaners.NorwegianAddressCleaner",
    "NorwegianAddressCleaner",
    "norwegian-address",
)
def norwegian_address(value: str) -> str:
    """Lowercase-normalize and normalize common street-type abbreviations."""
    value = lower_case_normalize(value)
    replacements = {
        "gt.": "gate",
        "gt": "gate",
        "vn.": "veien",
        "vn": "veien",
        "v.": "veien",
        "pb.": "postboks",
        "pb": "postboks",
    }
    tokens = [replacements.get(t, t) for t in value.split(" ")]
    return " ".join(tokens)


# Alias tables for the two demo-config example cleaners.  The reference relies
# on Duke's example classes (testdukeconfig.xml:50,55); these reproduce their
# intent (normalize country/capital names so the DBpedia and Mondial datasets
# agree) without claiming byte-level parity with the Java examples.
_COUNTRY_ALIASES = {
    "usa": "united states",
    "united states of america": "united states",
    "us": "united states",
    "uk": "united kingdom",
    "great britain": "united kingdom",
    "holland": "netherlands",
    "the netherlands": "netherlands",
    "russian federation": "russia",
    "republic of korea": "south korea",
    "korea, south": "south korea",
    "korea, north": "north korea",
    "democratic people's republic of korea": "north korea",
    "cote d'ivoire": "ivory coast",
    "burma": "myanmar",
}


@register_cleaner(
    "no.priv.garshol.duke.examples.CountryNameCleaner",
    "CountryNameCleaner",
    "country",
)
def country_name(value: str) -> str:
    value = lower_case_normalize(value)
    value = _PAREN_RE.sub("", value).strip()
    for prefix in ("republic of ", "kingdom of ", "state of "):
        if value.startswith(prefix) and value[len(prefix):] not in ("korea",):
            value = value[len(prefix):]
            break
    return _COUNTRY_ALIASES.get(value, value)


@register_cleaner(
    "no.priv.garshol.duke.examples.CapitalCleaner",
    "CapitalCleaner",
    "capital",
)
def capital(value: str) -> str:
    """City names: drop parenthesized qualifiers and 'City' suffixes."""
    value = lower_case_normalize(value)
    value = _PAREN_RE.sub("", value).strip()
    if value.endswith(" city"):
        value = value[: -len(" city")]
    return value


class RegexpCleaner:
    """Duke's RegexpCleaner: extract a regexp group from the value.

    Instantiated from config ``<object>`` definitions with params ``regexp``
    and optional ``group-no`` (default 1).
    """

    def __init__(self, regexp: str, group_no: int = 1):
        self.pattern = re.compile(regexp)
        self.group_no = int(group_no)

    def __call__(self, value: str) -> Optional[str]:
        m = self.pattern.search(value)
        if not m:
            return None
        try:
            return m.group(self.group_no)
        except IndexError:
            return None


class MappingCleaner:
    """Dictionary-based replacement cleaner (Duke's MappingFileCleaner shape)."""

    def __init__(self, mapping: Dict[str, str], sub_cleaner: Optional[Cleaner] = None):
        self.mapping = mapping
        self.sub_cleaner = sub_cleaner

    def __call__(self, value: str) -> Optional[str]:
        if self.sub_cleaner is not None:
            value = self.sub_cleaner(value) or ""
        return self.mapping.get(value, value)


class ChainedCleaner:
    """Apply cleaners in sequence, dropping the value if any returns None."""

    def __init__(self, *cleaners: Cleaner):
        self.cleaners = cleaners

    def __call__(self, value: str) -> Optional[str]:
        for cleaner in self.cleaners:
            if value is None:
                return None
            value = cleaner(value)
        return value
