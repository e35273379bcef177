"""Host-side per-record feature extraction for the device scoring path.

A copy of the JAX package's ``ops/features.py``.  Value hashing and
q-gram sets take the port's C++ host library (``native``) while
``DUKE_TPU_NATIVE`` is on (the default); the numpy / Python paths below
produce the identical hashes and tensors and are its oracle.
``extract_batch`` consults the digest-keyed feature cache
(``ops.feature_cache``) and fans slabs of ``DEVICE_EXTRACT_PARALLEL_MIN``
records or more out to the shared-memory process pool
(``ops.parallel_extract``); both are off unless their knobs turn them on.

Design: the O(N) per-record work (unicode handling, hashing, phonetic codes,
numeric parsing, tokenization) stays on the host where strings are natural;
the O(N^2) per-pair work runs on device over the padded tensors produced
here.  This replaces the reference's per-pair string handling inside Duke
comparators (SURVEY.md section 1 L1) with a tokenize-once/compare-many split.

Each schema property is assigned a *feature kind* based on its comparator
class; ``extract_batch`` turns a list of records into a dict of numpy arrays
per property, every array shaped ``(N, V, ...)`` where ``V`` is the number of
value slots (Duke records are multi-valued; pair probability is the max over
value pairs — Processor.compare / ops.scoring).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import comparators as C
from ..core.config import DukeSchema
from ..core.records import Record

# Static shape defaults (device tensors are padded to these; chars/grams
# beyond the padded width are truncated — documented in tests/test_ops.py;
# the *value* axis auto-sizes to the data in engine.device_matcher, so
# multi-valued records are not truncated below DEVICE_VALUE_SLOTS_MAX).
# Env-tunable: the CPU test backend uses smaller
# shapes (tests/conftest.py) since it executes the kernels without an MXU.
# MAX_CHARS defaults to 32 so edit distance rides the Myers bit-parallel
# kernel (one uint32 word per pattern, ~100x the scan-DP throughput);
# DEVICE_MAX_CHARS=64 restores 64-char fidelity via the general DP.
from ..env import env_int

MAX_CHARS = env_int("DEVICE_MAX_CHARS", 32)
MAX_GRAMS = env_int("DEVICE_MAX_GRAMS", 64)
MAX_TOKENS = env_int("DEVICE_MAX_TOKENS", 16)

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF
# values longer than this hash on the scalar path (vectorization pads to
# the bucket max; a lone multi-KB value must not inflate the whole batch)
_BATCH_HASH_MAX_BYTES = 4096

# Sentinel for empty sorted-set slots: int32 max sorts last.
SET_PAD = np.int32(2**31 - 1)

# Char tensors hold UTF-16 CODE UNITS in uint16 (r5) — not uint32
# codepoints.  Halves the dominant HBM/row term, the restart upload, the
# snapshot, and the bootstrap payload at once, and it is the reference's
# own text model: Duke comparators run on java.lang.String char units,
# so a surrogate pair counts as TWO units there too (e.g.
# Levenshtein.java operates per char).  The host comparators apply the
# same expansion for non-BMP text (core.comparators._utf16_expand), so
# host and device distances stay bit-identical.
CHAR_DTYPE = np.uint16


def char_units(value: str) -> int:
    """Length of ``value`` in UTF-16 code units (the char-axis unit)."""
    if value.isascii():  # O(1) flag check — the ingest hot path's case
        return len(value)
    # C-speed for the non-ASCII remainder (no Python per-char loop)
    return len(value.encode("utf-16-le", "surrogatepass")) >> 1


def fnv1a64(value: str) -> int:
    h = _FNV_OFFSET
    # surrogatepass: json.loads accepts lone surrogates, so record values can
    # contain them; hashing must be total
    for b in value.encode("utf-8", "surrogatepass"):
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


def fnv1a64_batch(values: Sequence[str]) -> np.ndarray:
    """Vectorized ``fnv1a64`` over many strings -> (N,) uint64.

    Bit-identical to the scalar loop (differential-tested).  With the C++
    library on: one bulk pass over the concatenated UTF-8 bytes
    (``native.fnv1a64_bytes_batch``; ingest hashes every value, q-gram and
    token of every record).  Else the numpy fold over byte POSITIONS,
    vectorized across values, O(max_len) numpy ops.
    """
    n = len(values)
    out = np.full((n,), _FNV_OFFSET, dtype=np.uint64)
    if n == 0:
        return out
    bufs = [v.encode("utf-8", "surrogatepass") for v in values]
    from .. import native

    if native.available():
        return native.fnv1a64_bytes_batch(bufs)
    # group by byte-length power of two: a naive single padded matrix is
    # O(n * maxlen), so ONE long outlier value (arbitrary JSON fields) in
    # a big batch would balloon both the matrix and the fold loop; within
    # a bucket padding waste is <= 2x, and oversized values take the
    # scalar path
    groups: Dict[int, List[int]] = {}
    for idx, b in enumerate(bufs):
        length = len(b)
        if length == 0:
            continue
        if length > _BATCH_HASH_MAX_BYTES:
            h = _FNV_OFFSET
            for byte in b:
                h = ((h ^ byte) * _FNV_PRIME) & _MASK64
            out[idx] = h
            continue
        groups.setdefault((length - 1).bit_length(), []).append(idx)
    prime = np.uint64(_FNV_PRIME)
    for idxs in groups.values():
        gbufs = [bufs[i] for i in idxs]
        lens = np.fromiter((len(b) for b in gbufs), dtype=np.int64,
                           count=len(gbufs))
        maxlen = int(lens.max())
        mat = np.zeros((len(gbufs), maxlen), dtype=np.uint64)
        for row, b in enumerate(gbufs):
            mat[row, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        acc = np.full((len(gbufs),), _FNV_OFFSET, dtype=np.uint64)
        for j in range(maxlen):
            active = lens > j
            h = (acc ^ mat[:, j]) * prime  # uint64 wraps mod 2^64 (the mask)
            acc = np.where(active, h, acc)
        out[np.asarray(idxs)] = acc
    return out


def _split2x32(h: np.ndarray):
    """(hi, lo) int32 views of (N,) uint64 hashes (matches _hash2x32)."""
    lo = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (h >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return hi, lo


def _fold32(h: np.ndarray) -> np.ndarray:
    """(N,) int32 folded hashes (matches _hash32)."""
    return ((h ^ (h >> np.uint64(32))) & np.uint64(0xFFFFFFFF)).astype(
        np.uint32
    ).view(np.int32)


def _hash2x32(value: str) -> tuple:
    h = fnv1a64(value)
    lo = np.int64(h & 0xFFFFFFFF).astype(np.int32)
    hi = np.int64(h >> 32).astype(np.int32)
    return hi, lo


def _hash32(value: str) -> np.int32:
    h = fnv1a64(value)
    return np.int64((h ^ (h >> 32)) & 0xFFFFFFFF).astype(np.int32)


# -- feature kinds -----------------------------------------------------------

CHARS = "chars"              # padded codepoints + length (+ hash)
CHARS_WEIGHTED = "chars_w"   # chars + per-char class for weighted edits
GRAM_SET = "gram_set"        # sorted distinct q-gram hashes
TOKEN_SET = "token_set"      # sorted distinct token hashes
HASH = "hash"                # value hash only (exact/different)
PHONETIC = "phonetic"        # value hash + phonetic code hash
NUMERIC = "numeric"          # parsed float
GEO = "geo"                  # parsed lat/lon

# THE kind registry; every member has a ``_SIM_ERROR_BOUND`` entry in
# ops.bounds (an absent entry would read as inf/uncertifiable).
ALL_KINDS = (CHARS, CHARS_WEIGHTED, GRAM_SET, TOKEN_SET, HASH, PHONETIC,
             NUMERIC, GEO)


def feature_kind(comparator) -> Optional[str]:
    """Feature kind for a comparator instance, or None if the comparator has
    no device kernel yet (scored on host via the hybrid pruning path —
    engine.device_matcher)."""
    if comparator is None:
        return None
    if isinstance(comparator, C.WeightedLevenshtein):
        return CHARS_WEIGHTED
    if isinstance(comparator, (C.Levenshtein, C.JaroWinkler)) and not isinstance(
        comparator, C.JaroWinklerTokenized
    ):
        return CHARS
    if isinstance(comparator, C.QGram):
        return GRAM_SET
    if isinstance(comparator, (C.JaccardIndex, C.DiceCoefficient)):
        return TOKEN_SET
    if isinstance(comparator, (C.Exact, C.Different)):
        return HASH
    if isinstance(comparator, (C.Soundex, C.Metaphone, C.Norphone)):
        return PHONETIC
    if isinstance(comparator, C.Numeric):
        return NUMERIC
    if isinstance(comparator, C.Geoposition):
        return GEO
    return None


def _phonetic_code(comparator, value: str) -> str:
    if isinstance(comparator, C.Soundex):
        return C.soundex(value)
    if isinstance(comparator, C.Metaphone):
        return C.metaphone(value)
    return C.norphone(value)


@dataclass
class PropertyFeatureSpec:
    """Static description of one schema property's device representation."""

    name: str
    kind: str
    low: float
    high: float
    comparator: object
    values_per_record: int = 1
    # per-property char-tensor width (CHARS kinds): starts at the global
    # MAX_CHARS default and auto-grows with the data in
    # engine.device_matcher, so ONE long-text property widens its own
    # tensors (and rides the scan-DP fallback past MYERS_MAX_CHARS)
    # without dragging every short property off the 32-char Myers path
    max_chars: int = 0

    @property
    def v(self) -> int:
        return self.values_per_record

    @property
    def chars(self) -> int:
        return self.max_chars or MAX_CHARS


@dataclass
class SchemaFeatures:
    """Per-schema feature plan: which properties score on device vs host."""

    device_props: List[PropertyFeatureSpec] = field(default_factory=list)
    host_props: List = field(default_factory=list)  # core Property objects

    @classmethod
    def plan(cls, schema: DukeSchema, values_per_record: int = 1) -> "SchemaFeatures":
        plan = cls()
        for prop in schema.comparison_properties():
            kind = feature_kind(prop.comparator)
            if kind is None:
                plan.host_props.append(prop)
            else:
                plan.device_props.append(
                    PropertyFeatureSpec(
                        name=prop.name,
                        kind=kind,
                        low=prop.low,
                        high=prop.high,
                        comparator=prop.comparator,
                        values_per_record=values_per_record,
                    )
                )
        return plan


# -- extraction --------------------------------------------------------------


def _char_class(ch: str) -> int:
    if ch.isdigit():
        return 2
    if ch.isalpha():
        return 1
    return 0


def extract_property(
    spec: PropertyFeatureSpec, values_per_record: Sequence[List[str]]
) -> Dict[str, np.ndarray]:
    """Extract one property's features for N records.

    ``values_per_record[i]`` is record i's (cleaned, non-empty) value list
    for this property; slots beyond ``spec.v`` are dropped (Duke scores the
    max over all value pairs; we bound the value axis for static shapes).
    """
    n = len(values_per_record)
    v = spec.v
    out: Dict[str, np.ndarray] = {}
    valid = np.zeros((n, v), dtype=bool)
    hash_hi = np.zeros((n, v), dtype=np.int32)
    hash_lo = np.zeros((n, v), dtype=np.int32)

    kind = spec.kind
    if kind in (CHARS, CHARS_WEIGHTED):
        L = spec.chars
        chars = np.zeros((n, v, L), dtype=CHAR_DTYPE)
        length = np.zeros((n, v), dtype=np.int32)
        classes = (
            np.zeros((n, v, L), dtype=np.int32)
            if kind == CHARS_WEIGHTED
            else None
        )
    elif kind == GRAM_SET:
        grams = np.full((n, v, MAX_GRAMS), SET_PAD, dtype=np.int32)
        gram_count = np.zeros((n, v), dtype=np.int32)
        q = int(getattr(spec.comparator, "q", 2))
    elif kind == TOKEN_SET:
        tokens = np.full((n, v, MAX_TOKENS), SET_PAD, dtype=np.int32)
        token_count = np.zeros((n, v), dtype=np.int32)
    elif kind == PHONETIC:
        code_hi = np.zeros((n, v), dtype=np.int32)
        code_lo = np.zeros((n, v), dtype=np.int32)
        code_valid = np.zeros((n, v), dtype=bool)
    elif kind == NUMERIC:
        number = np.zeros((n, v), dtype=np.float32)
        number_valid = np.zeros((n, v), dtype=bool)
    elif kind == GEO:
        lat = np.zeros((n, v), dtype=np.float32)
        lon = np.zeros((n, v), dtype=np.float32)
        geo_valid = np.zeros((n, v), dtype=bool)

    # flatten the ragged (record, slot) structure once; value hashing is
    # then ONE vectorized fnv pass instead of a Python byte loop per value
    flat: List[tuple] = [
        (i, k, value)
        for i, values in enumerate(values_per_record)
        for k, value in enumerate(values[:v])
    ]
    if flat:
        m = len(flat)
        ii = np.fromiter((t[0] for t in flat), dtype=np.int64, count=m)
        kk = np.fromiter((t[1] for t in flat), dtype=np.int64, count=m)
        hi, lo = _split2x32(fnv1a64_batch([t[2] for t in flat]))
        valid[ii, kk] = True
        hash_hi[ii, kk] = hi
        hash_lo[ii, kk] = lo

    if kind in (CHARS, CHARS_WEIGHTED):
        if flat:
            # utf-16-le: text rides the device as UTF-16 CODE UNITS in
            # uint16 — half the HBM/row, upload, snapshot, and bootstrap
            # bytes of the old uint32 codepoints, and EXACT parity with
            # the reference, whose comparators run on java.lang.String
            # char units (Duke Levenshtein.distance etc. count a
            # surrogate PAIR as two units).  surrogatepass round-trips
            # lone surrogates; slicing the byte buffer at 2*L may split
            # a pair, which is precisely Java's substring-on-code-units
            # behavior.  One concatenated buffer + boolean-mask scatter
            # fills the whole (m, L) block (row-major mask order ==
            # concatenation order).
            # slice to L CHARS first so a multi-KB value pays O(L), not
            # O(len), per extraction; L chars cover >= L code units, so
            # the byte cap after encoding is exact
            bufs = [
                t[2][:L].encode("utf-16-le", "surrogatepass")[: 2 * L]
                for t in flat
            ]
            m = len(flat)
            lens = np.fromiter((len(b) >> 1 for b in bufs), np.int64,
                               count=m)
            mat = np.zeros((m, L), dtype=CHAR_DTYPE)
            if int(lens.sum()):
                all_cu = np.frombuffer(b"".join(bufs), dtype="<u2")
                mat[np.arange(L)[None, :] < lens[:, None]] = all_cu
            chars[ii, kk] = mat  # ii/kk from the hash block above
            length[ii, kk] = lens.astype(np.int32)
            if classes is not None:
                # per-UNIT character classes.  Surrogate units class as
                # "other" (0): Java's Character.isDigit/isLetter on a
                # lone surrogate char is false, and the host path sees
                # the same after _utf16_expand — all three agree.
                for i, k, value in flat:
                    j = 0
                    for ch in value:
                        if ord(ch) > 0xFFFF:
                            if j < L:
                                classes[i, k, j] = 0
                            if j + 1 < L:
                                classes[i, k, j + 1] = 0
                            j += 2
                        else:
                            if j < L:
                                classes[i, k, j] = _char_class(ch)
                            j += 1
                        if j >= L:
                            break
    elif kind == GRAM_SET:
        from .. import native

        if flat and native.available():
            # one bulk C pass: window + UTF-8 + hash + dedupe + sort per
            # value
            gmat, gcounts = native.gram_set_batch(
                [t[2] for t in flat], q, MAX_GRAMS, int(SET_PAD)
            )
            grams[ii, kk] = gmat
            gram_count[ii, kk] = gcounts
        elif flat:
            # one flat hash pass over every gram of every value
            gram_lists = [C.qgrams(t[2], q) for t in flat]
            all_ids = _fold32(
                fnv1a64_batch([g for gl in gram_lists for g in gl])
            )
            pos = 0
            for (i, k, _), gl in zip(flat, gram_lists):
                ids = sorted(set(all_ids[pos:pos + len(gl)].tolist()))
                pos += len(gl)
                ids = ids[:MAX_GRAMS]
                grams[i, k, : len(ids)] = ids
                gram_count[i, k] = len(ids)
    elif kind == TOKEN_SET:
        token_lists = [t[2].split() for t in flat]
        all_ids = _fold32(
            fnv1a64_batch([t for tl in token_lists for t in tl])
        )
        pos = 0
        for (i, k, _), tl in zip(flat, token_lists):
            ids = sorted(set(all_ids[pos:pos + len(tl)].tolist()))
            pos += len(tl)
            ids = ids[:MAX_TOKENS]
            tokens[i, k, : len(ids)] = ids
            token_count[i, k] = len(ids)
    elif kind == PHONETIC:
        codes = [_phonetic_code(spec.comparator, t[2]) for t in flat]
        chi, clo = _split2x32(fnv1a64_batch(codes))
        for idx, (i, k, _) in enumerate(flat):
            if codes[idx]:
                code_hi[i, k] = chi[idx]
                code_lo[i, k] = clo[idx]
                code_valid[i, k] = True
    elif kind == NUMERIC:
        for i, k, value in flat:
            try:
                d = float(value)
                if np.isfinite(d):
                    number[i, k] = np.float32(d)
                    number_valid[i, k] = True
            except (TypeError, ValueError):
                pass
    elif kind == GEO:
        for i, k, value in flat:
            parsed = C.Geoposition._parse(value)
            if parsed is not None:
                lat[i, k] = np.float32(parsed[0])
                lon[i, k] = np.float32(parsed[1])
                geo_valid[i, k] = True

    out["valid"] = valid
    out["hash_hi"] = hash_hi
    out["hash_lo"] = hash_lo
    if kind in (CHARS, CHARS_WEIGHTED):
        out["chars"] = chars
        out["length"] = length
        if classes is not None:
            out["classes"] = classes
    elif kind == GRAM_SET:
        out["grams"] = grams
        out["gram_count"] = gram_count
    elif kind == TOKEN_SET:
        out["tokens"] = tokens
        out["token_count"] = token_count
    elif kind == PHONETIC:
        out["code_hi"] = code_hi
        out["code_lo"] = code_lo
        out["code_valid"] = code_valid
    elif kind == NUMERIC:
        out["number"] = number
        out["number_valid"] = number_valid
    elif kind == GEO:
        out["lat"] = lat
        out["lon"] = lon
        out["geo_valid"] = geo_valid
    return out


def extract_batch(
    plan: SchemaFeatures, records: Sequence[Record], *, encoder=None
) -> Dict[str, Dict[str, np.ndarray]]:
    """Extract all device-scored properties for a batch of records.

    Returns ``{property_name: {tensor_name: (N, V, ...) array}}``; with an
    ``encoder`` (the ``ann`` backend's ``ops.embedding.RecordEncoder``) the
    embedding tensors ride under its pseudo-property ``ANN_PROP``.

    The one extraction entry point (corpus appends, plan-growth rebuilds,
    query-side probe extraction), so the digest-keyed feature cache
    (``ops.feature_cache``, ``DUKE_FEATURE_CACHE_MB``) sits here: rows
    whose record content and feature plan match a cached entry scatter
    from the cache, and only the misses are extracted.
    """
    if records:
        from . import feature_cache as FC

        cache = FC.active()
        if cache is not None:
            return FC.cached_extract(cache, plan, records, encoder=encoder)
    return _extract_direct(plan, records, encoder=encoder)


def _extract_direct(
    plan: SchemaFeatures, records: Sequence[Record], *, encoder=None
) -> Dict[str, Dict[str, np.ndarray]]:
    """Cache-bypassing extraction (the feature cache's miss path): slabs of
    at least ``DEVICE_EXTRACT_PARALLEL_MIN`` records fan out to the
    shared-memory process pool (``ops.parallel_extract``), the rest run
    serially here."""
    if records:
        from . import parallel_extract as PX

        if PX.enabled(len(records)):
            out = PX.extract_batch_parallel(plan, records, encoder=encoder)
            if out is not None:
                return out

    out = _extract_serial(plan, records)
    if encoder is not None:
        from .embedding import ANN_PROP

        out[ANN_PROP] = encoder.corpus_tensors(records)
    return out


def _extract_serial(
    plan: SchemaFeatures, records: Sequence[Record]
) -> Dict[str, Dict[str, np.ndarray]]:
    out: Dict[str, Dict[str, np.ndarray]] = {}
    empty: List[str] = []
    for spec in plan.device_props:
        # read-only peek at the live value lists (get_values copies per
        # call); stored values are never empty (Record.add_value drops them)
        values = [r._values.get(spec.name, empty) for r in records]
        out[spec.name] = extract_property(spec, values)
    return out


def concat_features(
    parts: Sequence[Dict[str, Dict[str, np.ndarray]]]
) -> Dict[str, Dict[str, np.ndarray]]:
    """Concatenate per-batch feature dicts along the record axis."""
    if not parts:
        return {}
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for prop in parts[0]:
        out[prop] = {
            name: np.concatenate([p[prop][name] for p in parts], axis=0)
            for name in parts[0][prop]
        }
    return out
