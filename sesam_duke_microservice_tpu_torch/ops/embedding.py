"""The ``ann`` backend's host half: hashed character-trigram record
embeddings and their corpus storage layouts.

Split from ``ops.encoder`` (which re-exports every name here) so that it
imports no ``torch``: the shared-memory extraction workers
(``ops.parallel_extract``) unpickle a ``RecordEncoder`` and embed their
slice in a process that never loads torch.

Every comparison property's character trigrams are hashed into a signed
D-dimensional vector (the hashing trick), L2-normalized; no learned
weights, the encoder is deterministic from the schema alone.  The numpy
encoder is bit for bit the JAX package's numpy path, batched over a block
of records by ``embed_batch``; with the C++ host library on
(``DUKE_TPU_NATIVE``, the default) ``RecordEncoder.encode_batch`` runs the
library's ``embed_batch`` instead, as the JAX package does, which agrees
with numpy within ``NATIVE_EMBED_ATOL``.  Storage: bf16 (the default; kept
on the host as uint16 bit patterns rounded to nearest even and
reinterpreted as ``torch.bfloat16`` on upload) or, under
``DUKE_EMB_INT8``, symmetric per-row int8 codes plus a f32 scale vector.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from ..core.records import Record
from ..env import env_flag
from . import features as F

# The pseudo-property under which the embedding tensors ride inside the
# DeviceCorpus feature tree, so growth, upload and tombstones apply to it
# unchanged; under DUKE_EMB_INT8 the per-row scale is a second tensor.
ANN_PROP = "__ann__"
ANN_TENSOR = "emb"
ANN_SCALE = "scale"

# |C++ - numpy| bound of an embedding component: the C++ library adds a
# bucket's terms in hash-map order and normalizes by a f64 reciprocal, the
# numpy path adds in sorted-hash order and divides by a f32 norm, so the
# two differ in the last bits of a component in [-1, 1].  Empirical, with
# a margin of 16: the largest difference seen over 120,000 random records
# at D = 64, 256 and 1024 was 2^-24.
NATIVE_EMBED_ATOL = 2.0 ** -20


def int8_enabled() -> bool:
    """int8 embedding storage (read when an encoder is built, so one index
    never mixes storage layouts)."""
    return env_flag("DUKE_EMB_INT8", False)


def storage_name() -> str:
    """The storage layout's name, as the JAX package spells it."""
    return "int8" if int8_enabled() else "bfloat16"


def int8_cosine_eps(dim: int) -> float:
    """Certified worst-case |exact cosine - int8-reconstructed cosine| for
    L2-normalized rows: ``2*sqrt(D)/254 + D/254^2`` (each component is off
    by at most scale/2 with scale <= 1/127)."""
    per_side = math.sqrt(float(dim)) / 254.0
    return 2.0 * per_side + per_side * per_side


def quantize_rows(rows: np.ndarray):
    """Symmetric per-row int8 quantization of f32 rows: ``(codes (N, D)
    int8, scale (N,) f32)`` with ``codes * scale[:, None]`` the
    reconstruction; all-zero rows keep scale 0."""
    rows = np.asarray(rows, dtype=np.float32)
    peak = np.abs(rows).max(axis=1)
    scale = (peak / 127.0).astype(np.float32)
    inv = np.where(scale > 0.0, 1.0 / np.where(scale > 0.0, scale, 1.0), 0.0)
    codes = np.rint(rows * inv[:, None]).astype(np.int8)
    return codes, scale


def bf16_bits(rows: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bit patterns (uint16), rounded to nearest even, as
    ``ml_dtypes.bfloat16`` and ``torch.bfloat16`` round."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    bits = rows.view(np.uint32)
    with np.errstate(over="ignore"):
        rounded = bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16))
                                              & np.uint32(1))
    out = (rounded >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(rows)
    if nan.any():  # keep NaN a (quiet) NaN, never round it to infinity
        out[nan] = ((bits[nan] >> np.uint32(16)) | np.uint32(0x40)).astype(
            np.uint16)
    return out


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns -> the f32 values they hold (exact)."""
    return (np.asarray(bits, dtype=np.uint16).astype(np.uint32)
            << np.uint32(16)).view(np.float32)


def corpus_tensors_from_f32(rows: np.ndarray, storage: str):
    """f32 rows -> the ANN_PROP tensor dict of ``storage``: ``{emb}`` bf16
    bit patterns, or ``{emb, scale}`` for ``"int8"``."""
    if storage == "int8":
        codes, scale = quantize_rows(rows)
        return {ANN_TENSOR: codes, ANN_SCALE: scale}
    return {ANN_TENSOR: bf16_bits(rows)}


def dequantize_rows(tree) -> np.ndarray:
    """ANN_PROP tensor dict (host mirror) -> f32 rows, either layout."""
    emb = tree[ANN_TENSOR]
    if emb.dtype == np.int8:
        return emb.astype(np.float32) * np.asarray(
            tree[ANN_SCALE], dtype=np.float32)[:, None]
    if emb.dtype == np.uint16:
        return bf16_to_f32(emb)
    return np.asarray(emb, dtype=np.float32)


# -- the encoder (host) --------------------------------------------------------

_NGRAM = 3
# one odd multiplier per window position plus a murmur3-style finalizer,
# in wrapping uint64 numpy arithmetic
_H_MULT = (
    np.uint64(0x9E3779B97F4A7C15),
    np.uint64(0xC2B2AE3D27D4EB4F),
    np.uint64(0x165667B19E3779F9),
)
_FM1 = np.uint64(0xFF51AFD7ED558CCD)
_FM2 = np.uint64(0xC4CEB9FE1A85EC53)

_SALTS: Dict[str, np.uint64] = {}


def _native_embed():
    """The C++ host library when it is on and the window is the trigram
    it hard-codes, else None (the numpy path)."""
    if _NGRAM != 3:
        return None
    from .. import native

    return native if native.available() else None


def _salt(prop: str) -> np.uint64:
    # one salt per property: "oslo" in NAME and in CITY hash apart
    s = _SALTS.get(prop)
    if s is None:
        s = _SALTS[prop] = np.uint64(F.fnv1a64(prop))
    return s


def embed_values(prop_values: Sequence[tuple], dim: int) -> np.ndarray:
    """One L2-normalized signed-hash embedding from (property, value)
    pairs: each distinct trigram hash counted, bucket ``hash % dim``, sign
    from bit 32, weight sqrt(count)."""
    return embed_batch([prop_values], dim)[0]


def embed_batch(records_values: Sequence[Sequence[tuple]],
                dim: int) -> np.ndarray:
    """``embed_values`` of many records -> (N, dim) f32, bit for bit the
    JAX package's per-record numpy encoder.

    All values of all records are hashed in one pass over the concatenated
    codepoints; the (record, hash) pairs are sorted and counted, so each
    record's buckets receive their additions in ``np.unique``'s hash
    order, and each row is normalized by ``sqrt(row.dot(row))``, which is
    what ``np.linalg.norm`` computes for a vector."""
    out = np.zeros((len(records_values), dim), dtype=np.float32)
    strings, salts, owner = [], [], []
    for i, pairs in enumerate(records_values):
        for prop, value in pairs:
            # lower-cased and space-padded codepoints (a non-BMP char is
            # one unit); shorter than a window, zero-filled to one
            padded = f" {value.lower()} "
            strings.append(padded + "\0" * (_NGRAM - len(padded)))
            salts.append(_salt(prop))
            owner.append(i)
    if not strings:
        return out
    lengths = np.fromiter((len(t) for t in strings), dtype=np.int64,
                          count=len(strings))
    cp = np.frombuffer("".join(strings).encode("utf-32-le", "surrogatepass"),
                       dtype=np.uint32).astype(np.uint64)
    # windows lie inside one string: its last NGRAM-1 positions start none
    ends = np.cumsum(lengths)
    starts_ok = np.ones(cp.size, dtype=bool)
    for j in range(1, _NGRAM):
        starts_ok[ends - j] = False
    pos = np.flatnonzero(starts_ok)
    string_of = np.repeat(np.arange(len(strings)), lengths)[pos]
    with np.errstate(over="ignore"):
        h = np.asarray(salts, dtype=np.uint64)[string_of]
        for j in range(_NGRAM):
            h = h ^ (cp[pos + j] * _H_MULT[j])
        h ^= h >> np.uint64(33)
        h *= _FM1
        h ^= h >> np.uint64(29)
        h *= _FM2
        h ^= h >> np.uint64(32)
    rec = np.asarray(owner, dtype=np.int64)[string_of]
    order = np.lexsort((h, rec))
    rec, h = rec[order], h[order]
    first = np.ones(h.size, dtype=bool)
    first[1:] = (rec[1:] != rec[:-1]) | (h[1:] != h[:-1])
    at = np.flatnonzero(first)
    counts = np.diff(np.append(at, h.size))
    uniq, rec = h[at], rec[at]
    buckets = (uniq % np.uint64(dim)).astype(np.int64)
    signs = np.where((uniq >> np.uint64(32)) & np.uint64(1), 1.0,
                     -1.0).astype(np.float32)
    np.add.at(out.reshape(-1), rec * dim + buckets,
              signs * np.sqrt(counts).astype(np.float32))
    norm = np.sqrt(np.array([row.dot(row) for row in out], dtype=np.float32))
    live = norm > 0.0
    out[live] /= norm[live, None]
    return out


class RecordEncoder:
    """Schema-bound encoder: records -> (N, dim) normalized f32 embeddings
    over every comparison property."""

    def __init__(self, schema, dim: int):
        self.dim = dim
        self.props: List[str] = [p.name
                                 for p in schema.comparison_properties()]
        # resolved once: an index never mixes storage layouts
        self.storage = storage_name()

    def encode(self, record: Record) -> np.ndarray:
        """One record's normalized f32 embedding (the numpy path; the
        ``ann`` explain reads the pair's cosine from it)."""
        pairs = []
        for name in self.props:
            for value in record.get_values(name):
                if value:
                    pairs.append((name, value))
        return embed_values(pairs, self.dim)

    def encode_batch(self, records: Sequence[Record]) -> np.ndarray:
        native = _native_embed()
        if native is not None:
            return self._encode_batch_native(records, native)
        return embed_batch([[(name, value) for name in self.props
                             for value in r.get_values(name) if value]
                            for r in records], self.dim)

    def _encode_batch_native(self, records: Sequence[Record],
                             native) -> np.ndarray:
        # one foreign call for the whole batch, as the JAX package does
        strings: List[str] = []
        salts: List[np.uint64] = []
        rec_off = np.zeros(len(records) + 1, dtype=np.int64)
        empty: List[str] = []
        prop_salts = [(name, _salt(name)) for name in self.props]
        for i, record in enumerate(records):
            values_map = record._values  # read-only peek (no copies)
            for name, salt in prop_salts:
                for value in values_map.get(name, empty):
                    if value:
                        strings.append(f" {value.lower()} ")
                        salts.append(salt)
            rec_off[i + 1] = len(strings)
        return native.embed_batch(
            strings, np.asarray(salts, dtype=np.uint64), rec_off, self.dim)

    def corpus_tensors(self, records: Sequence[Record]) -> Dict[str, np.ndarray]:
        """The ANN_PROP tensor dict of a record batch in this encoder's
        storage layout."""
        return corpus_tensors_from_f32(self.encode_batch(records),
                                       self.storage)
