"""Host-side comparator implementations (oracles + conformance path).

The reference delegates per-pair similarity to Duke 1.2 comparator classes
selected by Java class name in the XML schema (testdukeconfig.xml:27,33;
SURVEY.md section 1 L1).  This module provides behavior-compatible Python
implementations, registered under the Duke class names so reference configs
load unchanged, plus short aliases.

These scalar implementations serve three roles:
  1. the conformance/"oracle" reference for the batched device kernels in
     ``ops/`` (each kernel has differential tests against these),
  2. the scoring path of the pure-host engine backend (useful for CPU-only
     runs and golden tests),
  3. documentation of the exact similarity semantics the framework promises.

Every comparator exposes ``compare(v1, v2) -> float`` in [0, 1] and an
``is_tokenized`` flag (Duke's ``Comparator.isTokenized``; the blocking layer
uses it for its fuzzy-search decision, IncrementalLuceneDatabase.java:323-326).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Type


def _native_module():
    """The C++ host library (``native/``) when ``DUKE_TPU_NATIVE`` is on,
    else None.

    Resolved on the first compare, so importing this module never pays
    the build; a failed build raises.  The pure-Python bodies below stay
    the oracles (tests/test_torch_native.py).
    """
    global _NATIVE
    if _NATIVE is _UNRESOLVED:
        from .. import native

        _NATIVE = native if native.available() else None
    return _NATIVE


_UNRESOLVED = object()
_NATIVE = _UNRESOLVED


class Comparator:
    is_tokenized = True

    def compare(self, v1: str, v2: str) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    def set_param(self, name: str, value: str) -> None:
        """Bean-style param injection from config ``<object>``/``<param>``.

        Kebab-case param names map to python attributes
        (``min-ratio`` -> ``min_ratio``), with numeric coercion.
        """
        attr = name.replace("-", "_")
        if not hasattr(self, attr):
            raise KeyError(f"{type(self).__name__} has no parameter '{name}'")
        current = getattr(self, attr)
        if isinstance(current, bool):
            value = value.lower() == "true"
        elif isinstance(current, int):
            value = int(value)
        elif isinstance(current, float):
            value = float(value)
        setattr(self, attr, value)


def levenshtein_distance(s1: str, s2: str, limit: Optional[int] = None) -> int:
    """Plain dynamic-programming edit distance (optionally bounded by limit)."""
    if s1 == s2:
        return 0
    n1, n2 = len(s1), len(s2)
    if n1 == 0:
        return n2
    if n2 == 0:
        return n1
    prev = list(range(n2 + 1))
    for i in range(1, n1 + 1):
        cur = [i] + [0] * n2
        c1 = s1[i - 1]
        best = cur[0]
        for j in range(1, n2 + 1):
            cost = 0 if c1 == s2[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            if cur[j] < best:
                best = cur[j]
        if limit is not None and best > limit:
            return limit + 1
        prev = cur
    return prev[n2]


def _utf16_expand(s: str) -> str:
    """Java parity for char-based comparators: Duke measures edit
    distance over java.lang.String CHAR UNITS, so a non-BMP character
    (surrogate pair in Java) counts as TWO positions.  The device path
    stores UTF-16 code units outright (ops.features.CHAR_DTYPE); this
    expansion keeps the host comparators bit-identical to it.  BMP-only
    strings (the overwhelmingly common case) return unchanged."""
    if s.isascii():  # O(1) flag check covers the hot loop's usual case
        return s
    for ch in s:
        if ord(ch) > 0xFFFF:
            return "".join(
                chr(u) for u in
                memoryview(s.encode("utf-16-le", "surrogatepass")).cast("H")
            )
    return s


class Levenshtein(Comparator):
    """Edit-distance similarity, Duke semantics.

    ``sim = 1 - d / min_len`` with two Duke-specific twists: strings whose
    length ratio makes a >=0.5 similarity impossible score 0 outright, and
    the distance is capped at ``min_len`` so the result stays in [0, 1].
    (Values below 0.5 are mapped to the property's ``low`` by
    ``Property.compare_probability`` regardless, so the early-exit is
    behaviorally exact.)
    """

    is_tokenized = True

    def compare(self, v1: str, v2: str) -> float:
        if v1 == v2:
            return 1.0
        v1, v2 = _utf16_expand(v1), _utf16_expand(v2)
        shorter = min(len(v1), len(v2))
        longer = max(len(v1), len(v2))
        if shorter == 0:
            return 0.0
        # distance >= longer - shorter; if that alone drops sim below 0.5 the
        # property maps to `low` anyway.
        if (longer - shorter) * 2 > shorter:
            return 0.0
        native = _native_module()
        if native is not None:
            return native.lev_sim(v1, v2)
        dist = min(levenshtein_distance(v1, v2, limit=shorter), shorter)
        return 1.0 - (dist / shorter)


class WeightedLevenshtein(Comparator):
    """Levenshtein with per-class character weights (digits weigh more).

    Duke's WeightedLevenshtein makes edits to digits more expensive than
    edits to letters (useful for id-ish fields).  Weights are configurable
    via params ``digit-weight``, ``letter-weight``, ``other-weight``.
    """

    is_tokenized = True

    def __init__(self):
        self.digit_weight = 2.0
        self.letter_weight = 1.0
        self.other_weight = 1.0

    def _weight(self, ch: str) -> float:
        if ch.isdigit():
            return self.digit_weight
        if ch.isalpha():
            return self.letter_weight
        return self.other_weight

    def _distance(self, s1: str, s2: str) -> float:
        n1, n2 = len(s1), len(s2)
        prev = [0.0] * (n2 + 1)
        for j in range(1, n2 + 1):
            prev[j] = prev[j - 1] + self._weight(s2[j - 1])
        for i in range(1, n1 + 1):
            w1 = self._weight(s1[i - 1])
            cur = [prev[0] + w1] + [0.0] * n2
            for j in range(1, n2 + 1):
                w2 = self._weight(s2[j - 1])
                sub = 0.0 if s1[i - 1] == s2[j - 1] else max(w1, w2)
                cur[j] = min(prev[j] + w1, cur[j - 1] + w2, prev[j - 1] + sub)
            prev = cur
        return prev[n2]

    def compare(self, v1: str, v2: str) -> float:
        if v1 == v2:
            return 1.0
        v1, v2 = _utf16_expand(v1), _utf16_expand(v2)
        shorter = min(len(v1), len(v2))
        if shorter == 0:
            return 0.0
        native = _native_module()
        # native classifies characters by ASCII class only, so non-ASCII
        # values (where isdigit/isalpha diverge) stay on the Python path
        if native is not None and v1.isascii() and v2.isascii():
            return native.weighted_lev(v1, v2, self.digit_weight,
                                       self.letter_weight, self.other_weight)
        # weighted distance over *unweighted* min length: edits to heavy
        # characters (digits) genuinely cost more similarity
        dist = min(self._distance(v1, v2), float(shorter))
        return 1.0 - (dist / shorter)


def _jaro(s1: str, s2: str) -> float:
    n1, n2 = len(s1), len(s2)
    if n1 == 0 or n2 == 0:
        return 0.0
    window = max(max(n1, n2) // 2 - 1, 0)
    matched2 = [False] * n2
    matches = 0
    m1: List[str] = []
    for i, c in enumerate(s1):
        lo = max(0, i - window)
        hi = min(n2, i + window + 1)
        for j in range(lo, hi):
            if not matched2[j] and s2[j] == c:
                matched2[j] = True
                matches += 1
                m1.append(c)
                break
    if matches == 0:
        return 0.0
    m2 = [s2[j] for j in range(n2) if matched2[j]]
    transpositions = sum(1 for a, b in zip(m1, m2) if a != b) // 2
    m = float(matches)
    return (m / n1 + m / n2 + (m - transpositions) / m) / 3.0


class JaroWinkler(Comparator):
    """Jaro-Winkler similarity (prefix scale 0.1, max prefix 4, boost 0.7)."""

    is_tokenized = False

    def __init__(self):
        self.prefix_scale = 0.1
        self.boost_threshold = 0.7
        self.max_prefix = 4

    def compare(self, v1: str, v2: str) -> float:
        if v1 == v2:
            return 1.0
        v1, v2 = _utf16_expand(v1), _utf16_expand(v2)
        native = _native_module()
        if native is not None:
            return native.jaro_winkler(v1, v2, self.prefix_scale,
                                       self.boost_threshold, self.max_prefix)
        j = _jaro(v1, v2)
        if j < self.boost_threshold:
            return j
        prefix = 0
        for a, b in zip(v1, v2):
            if a != b or prefix == self.max_prefix:
                break
            prefix += 1
        return j + prefix * self.prefix_scale * (1.0 - j)


class JaroWinklerTokenized(Comparator):
    """Monge-Elkan-style tokenized Jaro-Winkler.

    Splits on whitespace and scores each token of the shorter token list
    against its best match in the other, averaging the result (the shape of
    Duke's JaroWinklerTokenized).
    """

    is_tokenized = True

    def __init__(self):
        self._jw = JaroWinkler()

    def compare(self, v1: str, v2: str) -> float:
        if v1 == v2:
            return 1.0
        t1 = v1.split()
        t2 = v2.split()
        if not t1 or not t2:
            return 0.0
        if len(t1) > len(t2):
            t1, t2 = t2, t1
        total = 0.0
        for a in t1:
            total += max(self._jw.compare(a, b) for b in t2)
        return total / len(t1)


def qgrams(value: str, q: int) -> set:
    if len(value) < q:
        return {value} if value else set()
    return {value[i : i + q] for i in range(len(value) - q + 1)}


class QGram(Comparator):
    """q-gram set similarity; formula one of overlap|jaccard|dice (default overlap)."""

    is_tokenized = True

    def __init__(self):
        self.q = 2
        self.formula = "overlap"

    def compare(self, v1: str, v2: str) -> float:
        if v1 == v2:
            return 1.0
        g1 = qgrams(v1, self.q)
        g2 = qgrams(v2, self.q)
        if not g1 or not g2:
            return 0.0
        common = len(g1 & g2)
        if self.formula == "jaccard":
            return common / (len(g1) + len(g2) - common)
        if self.formula == "dice":
            return 2.0 * common / (len(g1) + len(g2))
        return common / min(len(g1), len(g2))


class JaccardIndex(Comparator):
    """Whitespace-token Jaccard index."""

    is_tokenized = True

    def compare(self, v1: str, v2: str) -> float:
        if v1 == v2:
            return 1.0
        t1 = set(v1.split())
        t2 = set(v2.split())
        if not t1 or not t2:
            return 0.0
        inter = len(t1 & t2)
        union = len(t1) + len(t2) - inter
        return inter / union


class DiceCoefficient(Comparator):
    """Whitespace-token Dice coefficient."""

    is_tokenized = True

    def compare(self, v1: str, v2: str) -> float:
        if v1 == v2:
            return 1.0
        t1 = set(v1.split())
        t2 = set(v2.split())
        if not t1 or not t2:
            return 0.0
        return 2.0 * len(t1 & t2) / (len(t1) + len(t2))


class Exact(Comparator):
    is_tokenized = False

    def compare(self, v1: str, v2: str) -> float:
        return 1.0 if v1 == v2 else 0.0


class Different(Comparator):
    """Inverse of Exact: evidence that two records differ when values equal."""

    is_tokenized = False

    def compare(self, v1: str, v2: str) -> float:
        return 0.0 if v1 == v2 else 1.0


class Numeric(Comparator):
    """Ratio of two numbers, cut off below ``min-ratio``.

    Configured in the reference demo config with ``min-ratio`` 0.7
    (testdukeconfig.xml:17-20).  Non-numeric values are neutral (0.5, like a
    missing comparator); values of opposite sign or zero/nonzero score 0.
    """

    is_tokenized = False

    def __init__(self):
        self.min_ratio = 0.0

    def compare(self, v1: str, v2: str) -> float:
        try:
            d1 = float(v1)
            d2 = float(v2)
        except (TypeError, ValueError):
            return 0.5
        if math.isnan(d1) or math.isnan(d2) or math.isinf(d1) or math.isinf(d2):
            return 0.5
        if d1 == d2:
            return 1.0
        if d1 == 0.0 or d2 == 0.0 or (d1 < 0.0) != (d2 < 0.0):
            return 0.0
        d1, d2 = abs(d1), abs(d2)
        ratio = min(d1, d2) / max(d1, d2)
        if ratio < self.min_ratio:
            return 0.0
        return ratio


_NAME_SPLIT_RE = re.compile(r"[\s]+")


class PersonName(Comparator):
    """Person-name similarity: token reordering, initials, per-token edit distance."""

    is_tokenized = True

    def __init__(self):
        self._lev = Levenshtein()

    def _token_sim(self, a: str, b: str) -> float:
        if a == b:
            return 1.0
        # initial vs full name: "j" ~ "john"
        if len(a) == 1 and b.startswith(a):
            return 0.8
        if len(b) == 1 and a.startswith(b):
            return 0.8
        return self._lev.compare(a, b)

    def compare(self, v1: str, v2: str) -> float:
        if v1 == v2:
            return 1.0
        t1 = _NAME_SPLIT_RE.split(v1.strip().lower())
        t2 = _NAME_SPLIT_RE.split(v2.strip().lower())
        t1 = [t for t in t1 if t]
        t2 = [t for t in t2 if t]
        if not t1 or not t2:
            return 0.0
        if sorted(t1) == sorted(t2):
            return 0.95  # same tokens, different order
        if len(t1) > len(t2):
            t1, t2 = t2, t1
        used = [False] * len(t2)
        total = 0.0
        for a in t1:
            best, best_j = 0.0, -1
            for j, b in enumerate(t2):
                if used[j]:
                    continue
                s = self._token_sim(a, b)
                if s > best:
                    best, best_j = s, j
            if best_j >= 0:
                used[best_j] = True
            total += best
        # average best-match score over the shorter name, discounted by the
        # token-count mismatch (sqrt so one extra middle name isn't fatal)
        return (total / len(t1)) * math.sqrt(len(t1) / len(t2))


def soundex(value: str) -> str:
    """Classic American Soundex code (letter + 3 digits)."""
    value = "".join(ch for ch in value.upper() if ch.isalpha())
    if not value:
        return ""
    codes = {
        **dict.fromkeys("BFPV", "1"),
        **dict.fromkeys("CGJKQSXZ", "2"),
        **dict.fromkeys("DT", "3"),
        "L": "4",
        **dict.fromkeys("MN", "5"),
        "R": "6",
    }
    first = value[0]
    out = [first]
    prev = codes.get(first, "")
    for ch in value[1:]:
        code = codes.get(ch, "")
        if ch in "HW":
            continue  # H/W do not break runs
        if code and code != prev:
            out.append(code)
            if len(out) == 4:
                break
        prev = code
    return "".join(out).ljust(4, "0")


class Soundex(Comparator):
    is_tokenized = True

    def compare(self, v1: str, v2: str) -> float:
        if v1 == v2:
            return 1.0
        return 0.9 if soundex(v1) == soundex(v2) and soundex(v1) else 0.0


def metaphone(value: str) -> str:
    """Simplified Metaphone phonetic code (covers the common English rules)."""
    v = "".join(ch for ch in value.upper() if ch.isalpha())
    if not v:
        return ""
    # initial-letter exceptions
    for prefix, repl in (("AE", "E"), ("GN", "N"), ("KN", "N"), ("PN", "N"),
                         ("WR", "R"), ("X", "S"), ("WH", "W")):
        if v.startswith(prefix):
            v = repl + v[len(prefix):]
            break
    out = []
    i = 0
    n = len(v)
    vowels = "AEIOU"
    # "\0" as the out-of-bounds sentinel: unlike "", it is never a member of
    # the character-class strings tested below
    while i < n:
        c = v[i]
        nxt = v[i + 1] if i + 1 < n else "\0"
        prv = v[i - 1] if i > 0 else "\0"
        if c in vowels:
            if i == 0:
                out.append(c)
        elif c == "B":
            if not (i == n - 1 and prv == "M"):
                out.append("B")
        elif c == "C":
            if nxt == "H":
                out.append("X")
                i += 1
            elif nxt in "IEY":
                out.append("S")
            else:
                out.append("K")
        elif c == "D":
            if nxt == "G" and i + 2 < n and v[i + 2] in "EIY":
                out.append("J")
                i += 2
            else:
                out.append("T")
        elif c == "G":
            if nxt == "H":
                if i + 2 >= n or v[i + 2] in vowels:
                    out.append("K")
                i += 1
            elif nxt in "IEY":
                out.append("J")
            else:
                out.append("K")
        elif c == "H":
            if prv in vowels and nxt not in vowels:
                pass
            else:
                out.append("H")
        elif c in "FJLMNR":
            out.append(c)
        elif c == "K":
            if prv != "C":
                out.append("K")
        elif c == "P":
            if nxt == "H":
                out.append("F")
                i += 1
            else:
                out.append("P")
        elif c == "Q":
            out.append("K")
        elif c == "S":
            if nxt == "H":
                out.append("X")
                i += 1
            elif nxt == "I" and i + 2 < n and v[i + 2] in "OA":
                out.append("X")
            else:
                out.append("S")
        elif c == "T":
            if nxt == "H":
                out.append("0")
                i += 1
            elif nxt == "I" and i + 2 < n and v[i + 2] in "OA":
                out.append("X")
            else:
                out.append("T")
        elif c == "V":
            out.append("F")
        elif c == "W":
            if nxt in vowels:
                out.append("W")
        elif c == "X":
            out.append("KS")
        elif c == "Y":
            if nxt in vowels:
                out.append("Y")
        elif c == "Z":
            out.append("S")
        i += 1
    # collapse doubled codes
    code = []
    for ch in "".join(out):
        if not code or code[-1] != ch:
            code.append(ch)
    return "".join(code)


class Metaphone(Comparator):
    is_tokenized = True

    def compare(self, v1: str, v2: str) -> float:
        if v1 == v2:
            return 1.0
        m1, m2 = metaphone(v1), metaphone(v2)
        return 0.9 if m1 and m1 == m2 else 0.0


def norphone(value: str) -> str:
    """Norphone-style phonetic code for Norwegian names.

    Follows the published Norphone rule set (Garshol): silent H/D endings,
    AA->A, C->K, W->V, PH->F, TH->T, SKJ/KJ/TJ->X(sh-sound), etc.
    """
    v = "".join(ch for ch in value.upper() if ch.isalpha() or ch in "ÆØÅ")
    if not v:
        return ""
    subs = [
        ("AA", "Å"), ("PH", "F"), ("TH", "T"), ("DT", "T"), ("CH", "K"),
        ("CK", "K"), ("GJ", "J"), ("GH", "K"), ("HJ", "J"), ("HG", "K"),
        ("LD", "L"), ("ND", "N"), ("RD", "R"), ("SKJ", "X"), ("SJ", "X"),
        ("KJ", "X"), ("TJ", "X"), ("QU", "KV"),
    ]
    for a, b in subs:
        v = v.replace(a, b)
    v = v.replace("C", "K").replace("W", "V").replace("Z", "S").replace("Q", "K")
    # drop non-initial vowels, collapse runs
    vowels = "AEIOUYÆØÅ"
    out = [v[0]]
    for ch in v[1:]:
        if ch in vowels:
            continue
        if out[-1] != ch:
            out.append(ch)
    return "".join(out)


class Norphone(Comparator):
    is_tokenized = True

    def compare(self, v1: str, v2: str) -> float:
        if v1 == v2:
            return 1.0
        n1, n2 = norphone(v1), norphone(v2)
        return 0.9 if n1 and n1 == n2 else 0.0


_EARTH_RADIUS_M = 6371000.0


class Geoposition(Comparator):
    """Similarity of two 'lat,long' coordinates by haversine distance.

    Param ``max-distance`` (meters): sim falls linearly from 1 at distance 0
    to 0 at max-distance.  Referenced (but gated off) by the reference's
    blocking layer (IncrementalLuceneDatabase.java:461-463); fully supported
    here.
    """

    is_tokenized = False

    def __init__(self):
        self.max_distance = 0.0

    @staticmethod
    def _parse(v: str):
        parts = v.replace(";", ",").split(",")
        if len(parts) != 2:
            return None
        try:
            return math.radians(float(parts[0])), math.radians(float(parts[1]))
        except ValueError:
            return None

    def compare(self, v1: str, v2: str) -> float:
        p1 = self._parse(v1)
        p2 = self._parse(v2)
        if p1 is None or p2 is None:
            return 0.5
        (lat1, lon1), (lat2, lon2) = p1, p2
        dlat = lat2 - lat1
        dlon = lon2 - lon1
        a = math.sin(dlat / 2) ** 2 + math.cos(lat1) * math.cos(lat2) * math.sin(dlon / 2) ** 2
        dist = 2 * _EARTH_RADIUS_M * math.asin(min(1.0, math.sqrt(a)))
        if self.max_distance <= 0:
            return 1.0 if dist == 0 else 0.0
        return max(0.0, 1.0 - dist / self.max_distance)


class LongestCommonSubstring(Comparator):
    """Iterated longest-common-substring similarity (Duke's shape).

    Repeatedly removes the longest common substring of length >= ``minlen``
    and accumulates its length; similarity is the accumulated length over the
    length of the shorter input.
    """

    is_tokenized = True

    def __init__(self):
        self.minlen = 2

    @staticmethod
    def _lcs(s1: str, s2: str):
        best_len, best_i, best_j = 0, 0, 0
        prev = [0] * (len(s2) + 1)
        for i in range(1, len(s1) + 1):
            cur = [0] * (len(s2) + 1)
            for j in range(1, len(s2) + 1):
                if s1[i - 1] == s2[j - 1]:
                    cur[j] = prev[j - 1] + 1
                    if cur[j] > best_len:
                        best_len, best_i, best_j = cur[j], i, j
            prev = cur
        return best_len, best_i - best_len, best_j - best_len

    def compare(self, v1: str, v2: str) -> float:
        if v1 == v2:
            return 1.0
        shorter = min(len(v1), len(v2))
        if shorter == 0:
            return 0.0
        total = 0
        s1, s2 = v1, v2
        min_take = max(1, self.minlen)  # minlen<=0 would loop forever on length-0 LCS
        while True:
            length, i, j = self._lcs(s1, s2)
            if length < min_take:
                break
            total += length
            s1 = s1[:i] + s1[i + length :]
            s2 = s2[:j] + s2[j + length :]
        return min(1.0, total / shorter)


_REGISTRY: Dict[str, Type[Comparator]] = {}


def register_comparator(cls: Type[Comparator], *names: str) -> None:
    for name in names:
        _REGISTRY[name] = cls


_DUKE = "no.priv.garshol.duke.comparators."
register_comparator(Levenshtein, _DUKE + "Levenshtein", "Levenshtein", "levenshtein")
register_comparator(
    WeightedLevenshtein, _DUKE + "WeightedLevenshtein", "WeightedLevenshtein", "weighted-levenshtein"
)
register_comparator(JaroWinkler, _DUKE + "JaroWinkler", "JaroWinkler", "jaro-winkler")
register_comparator(
    JaroWinklerTokenized,
    _DUKE + "JaroWinklerTokenized",
    "JaroWinklerTokenized",
    "jaro-winkler-tokenized",
)
register_comparator(QGram, _DUKE + "QGramComparator", "QGramComparator", "qgram")
register_comparator(
    JaccardIndex, _DUKE + "JaccardIndexComparator", "JaccardIndexComparator", "jaccard"
)
register_comparator(
    DiceCoefficient,
    _DUKE + "DiceCoefficientComparator",
    "DiceCoefficientComparator",
    "dice",
)
register_comparator(Exact, _DUKE + "ExactComparator", "ExactComparator", "exact")
register_comparator(
    Different, _DUKE + "DifferentComparator", "DifferentComparator", "different"
)
register_comparator(
    Numeric, _DUKE + "NumericComparator", "NumericComparator", "numeric"
)
register_comparator(
    PersonName, _DUKE + "PersonNameComparator", "PersonNameComparator", "person-name"
)
register_comparator(
    Soundex, _DUKE + "SoundexComparator", "SoundexComparator", "soundex"
)
register_comparator(
    Metaphone, _DUKE + "MetaphoneComparator", "MetaphoneComparator", "metaphone"
)
register_comparator(
    Norphone, _DUKE + "NorphoneComparator", "NorphoneComparator", "norphone"
)
register_comparator(
    Geoposition, _DUKE + "GeopositionComparator", "GeopositionComparator", "geoposition"
)
register_comparator(
    LongestCommonSubstring,
    _DUKE + "LongestCommonSubstringComparator",
    "LongestCommonSubstringComparator",
    "longest-common-substring",
)


def make_comparator(name: str) -> Comparator:
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown comparator '{name}'. Known comparators: {sorted(_REGISTRY)}"
        ) from None
    return cls()


def comparator_class(name: str) -> Type[Comparator]:
    return _REGISTRY[name]


def has_comparator(name: str) -> bool:
    return name in _REGISTRY


def available_comparators() -> Sequence[str]:
    return sorted(_REGISTRY)
