"""Hashed character-n-gram record embeddings and the ``ann`` backend's
cosine retrieval.

Counterpart of the JAX package's ``ops/encoder.py``.  The ``ann`` backend
(``engine.ann_matcher``) replaces brute-force blocking with two stages: a
cosine top-C retrieval over a dense embedding matrix, then exact rescoring
of only the retrieved rows (``ops.scoring.build_ann_scorer``).  Every
comparison property's character trigrams are hashed into a signed
D-dimensional vector (the hashing trick), L2-normalized; no learned
weights, the encoder is deterministic from the schema alone.

Host half: the numpy encoder (bit for bit the JAX package's numpy path,
batched over a block of records by ``embed_batch``) and the corpus
storage layouts -- bf16 (the default; kept on the host as
uint16 bit patterns rounded to nearest even and reinterpreted as
``torch.bfloat16`` on upload) or, under ``DUKE_EMB_INT8``, symmetric
per-row int8 codes plus a f32 scale vector.

Device half: ``retrieval_scan`` picks one of two routes from shapes and
knobs alone, before anything runs, exactly as the JAX package does on its
TPU (where Pallas is on):

  * the fused route: the hand-written segment-max kernel
    (``ops.cuda_kernels.retrieval_segmax``) scores, masks and reduces the
    corpus into strided bins, then an exact top-C runs over the bin
    winners;
  * the scan route: corpus chunks of up to ``DEVICE_ANN_RETRIEVAL_CHUNK``
    rows, each scored by one matmul, masked, and merged into a running
    top-C.

Both top-C selections are exact where the TPU's ``lax.approx_max_k`` is
approximate; on the CPU ``approx_max_k`` is exact, so the port equals the
JAX package run on the CPU.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core.records import Record
from ..env import env_flag, env_float, env_int
from . import cuda_kernels as ck
from . import features as F
from .bounds import NEG_INF

# The pseudo-property under which the embedding tensors ride inside the
# DeviceCorpus feature tree, so growth, upload and tombstones apply to it
# unchanged; under DUKE_EMB_INT8 the per-row scale is a second tensor.
ANN_PROP = "__ann__"
ANN_TENSOR = "emb"
ANN_SCALE = "scale"

# Retrieval calls by route since the last reset (the fused route is the
# one that launches the segment-max kernel).
ROUTES = {"fused": 0, "scan": 0}


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

    def encode_batch(self, records: Sequence[Record]) -> np.ndarray:
        return embed_batch([[(name, value) for name in self.props
                             for value in r.get_values(name) if value]
                            for r in records], self.dim)

    def corpus_tensors(self, records: Sequence[Record]) -> Dict[str, np.ndarray]:
        """The ANN_PROP tensor dict of a record batch in this encoder's
        storage layout."""
        return corpus_tensors_from_f32(self.encode_batch(records),
                                       self.storage)


# -- retrieval (device) ----------------------------------------------------------


def as_emb_tree(x) -> Dict:
    """A bare embedding matrix -> ``{ANN_TENSOR: x}``; dicts pass."""
    return x if isinstance(x, dict) else {ANN_TENSOR: x}


def is_int8_tree(tree: Dict) -> bool:
    return ANN_SCALE in tree


def int8_cosine_eps_dynamic(q_tree: Dict, c_tree: Dict) -> torch.Tensor:
    """Per-block certified cosine-error bound from the block's ACTUAL row
    scales: ``sqrt(D)/2 * (sq + sc) + D/4 * sq * sc`` with sq / sc the
    largest query / corpus scale (``int8_cosine_eps`` with the worst scale
    1/127); a f32 0-d tensor, the JAX package's f32 operations in order."""
    d = float(q_tree[ANN_TENSOR].shape[-1])
    root = math.sqrt(d) / 2.0
    sq = q_tree[ANN_SCALE].max()
    sc = c_tree[ANN_SCALE].max()
    return root * (sq + sc) + (root * sq) * (root * sc)


# int8 codes multiply exactly in f32 while every partial sum of D products
# of at most 127 x 127 stays an integer below 2^24 (D <= 1040)
_INT8_F32_EXACT_DIM = (1 << 24) // (127 * 127)


def chunk_sims(q_tree: Dict, c_emb: torch.Tensor, c_scale=None):
    """(Q, chunk) cosine scores for one corpus chunk.

    bf16 storage: bf16 operands, f32 accumulation (the products of two bf16
    values are exact in f32).  int8 storage: the integer dot of the codes,
    exact (an f32 product of the codes up to D = 1040, f64 beyond), then
    rescaled by the query and corpus row scales as the JAX package does."""
    q_emb = q_tree[ANN_TENSOR]
    if c_scale is not None:
        wide = (torch.float32 if q_emb.shape[1] <= _INT8_F32_EXACT_DIM
                else torch.float64)
        raw = (q_emb.to(wide) @ c_emb.to(wide).T).float()
        return (raw * q_tree[ANN_SCALE][:, None]) * c_scale[None, :]
    return (q_emb.to(torch.bfloat16).float()
            @ c_emb.to(torch.bfloat16).float().T)


def fused_route(n: int, d: int, q: int, top_c: int, recall_target: float):
    """``(tc, seg)`` when the fused segment-max route takes these shapes,
    else None -- the JAX package's gate, tile ``tc`` included: ``tc``
    decides which rows share a bin, so it decides the candidate set.

    ``tc`` is the largest power of two dividing the capacity, capped at
    2048 and at ``2^21 / Qp`` (Q rounded up to 128), and must be at least
    ``max(1024, 8 * seg)``; the bin count ``n / seg`` must reach
    ``top_c / (1 - recall_target)`` (the expected recall of C winners
    over strided bins)."""
    seg = env_int("DEVICE_ANN_SEG", 64)
    if d % 128 != 0 or seg <= 0 or seg & (seg - 1) or n < 2 * seg:
        return None
    qp = -(-q // 128) * 128
    tc = min(n & -n, 2048, (1 << 21) // qp)
    min_bins = int(top_c / max(1e-3, 1.0 - recall_target))
    if tc < max(1024, seg * 8) or n % tc or n // seg < min_bins:
        return None
    return tc, seg


def _stable_desc(x: torch.Tensor) -> torch.Tensor:
    """Row-wise descending order, ties by lower position (-0.0 ties +0.0),
    as ``lax.approx_max_k`` orders on the CPU."""
    return torch.sort(x, dim=1, descending=True, stable=True).indices


def _total_order_desc(x: torch.Tensor) -> torch.Tensor:
    """Row-wise descending order of f32 values under IEEE total order
    (-0.0 below +0.0), ties by lower position: ``lax.top_k``'s order."""
    bits = x.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return torch.sort(key, dim=1, descending=True, stable=True).indices


def _fused_retrieval(q_emb, corpus_emb, corpus_valid, corpus_deleted,
                     corpus_group, query_group, query_row, *, top_c: int,
                     tc: int, seg: int, group_filtering: bool):
    """The fused route: per-bin (max, argmax) from the segment-max kernel,
    then the exact top-C over the bin winners; all-masked bins (-3e38)
    come back as row -1."""
    seg_max, seg_arg = ck.retrieval_segmax(
        q_emb.to(torch.bfloat16).contiguous(),
        corpus_emb.to(torch.bfloat16).contiguous(), corpus_valid,
        corpus_deleted, corpus_group, query_row, query_group, tc=tc,
        seg=seg, group_filtering=group_filtering)
    sel = _stable_desc(seg_max)[:, :top_c]
    top_sim = seg_max.gather(1, sel)
    top_idx = torch.where(top_sim < -1e30, -1, seg_arg.gather(1, sel))
    return top_sim, top_idx


def retrieval_scan(q_emb, corpus_emb, corpus_valid, corpus_deleted,
                   corpus_group, query_group, query_row, *, chunk: int,
                   top_c: int, group_filtering: bool):
    """Cosine top-C of each query over the corpus embedding matrix:
    ``(top_sim (Q, C) f32, top_index (Q, C) int32)``, -1 for empty slots.

    ``q_emb`` / ``corpus_emb`` are bare matrices or ANN_PROP tensor dicts
    (``{emb}`` bf16, ``{emb, scale}`` int8).  The fused route runs when
    ``DEVICE_ANN_FUSED`` is on (the default), storage is bf16, the top-C
    is not forced exact (``DEVICE_ANN_EXACT_TOPK``, or C >= chunk / 4) and
    ``fused_route`` takes the shapes.  Otherwise the scan: the chunk
    widens to ``DEVICE_ANN_RETRIEVAL_CHUNK`` where the capacity divides;
    per chunk the masked scores are cut to their exact top-C (``exact``:
    all of them), and the running top-C comes FIRST in the merge, so an
    all-masked chunk never displaces its -1 sentinels.
    """
    from .scoring import candidate_mask

    cap = corpus_valid.shape[0]
    wide = env_int("DEVICE_ANN_RETRIEVAL_CHUNK", 65536)
    while chunk < wide and chunk * 2 <= cap and cap % (chunk * 2) == 0:
        chunk *= 2
    q_tree = as_emb_tree(q_emb)
    c_tree = as_emb_tree(corpus_emb)
    int8 = is_int8_tree(c_tree)
    q_emb = q_tree[ANN_TENSOR]
    corpus_emb = c_tree[ANN_TENSOR]
    q = q_emb.shape[0]
    device = corpus_valid.device

    exact = env_flag("DEVICE_ANN_EXACT_TOPK", False) or top_c * 4 >= chunk
    if not exact and not int8 and env_flag("DEVICE_ANN_FUSED", True):
        route = fused_route(cap, corpus_emb.shape[1], q, top_c,
                            env_float("DEVICE_ANN_RECALL_TARGET", 0.99))
        if route is not None:
            ROUTES["fused"] += 1
            return _fused_retrieval(
                q_emb, corpus_emb, corpus_valid, corpus_deleted,
                corpus_group, query_group, query_row, top_c=top_c,
                tc=route[0], seg=route[1], group_filtering=group_filtering)
    ROUTES["scan"] += 1

    top_sim = torch.full((q, top_c), NEG_INF, dtype=torch.float32,
                         device=device)
    top_idx = torch.full((q, top_c), -1, dtype=torch.int32, device=device)
    for start in range(0, cap - cap % chunk, chunk):
        stop = start + chunk
        sims = chunk_sims(q_tree, corpus_emb[start:stop],
                          c_tree[ANN_SCALE][start:stop] if int8 else None)
        cidx = torch.arange(start, stop, dtype=torch.int32, device=device)
        mask = candidate_mask(
            corpus_valid[start:stop], corpus_deleted[start:stop],
            corpus_group[start:stop], cidx, query_group, query_row,
            group_filtering)
        sims = torch.where(mask, sims, NEG_INF)
        if exact:
            cand_sim, cand_idx = sims, cidx.expand(q, chunk)
        else:
            sel = _stable_desc(sims)[:, :top_c]
            cand_sim, cand_idx = sims.gather(1, sel), cidx[sel]
        merged_sim = torch.cat([top_sim, cand_sim], dim=1)
        merged_idx = torch.cat([top_idx, cand_idx], dim=1)
        sel = _total_order_desc(merged_sim)[:, :top_c]
        top_sim = merged_sim.gather(1, sel)
        top_idx = merged_idx.gather(1, sel)
    return top_sim, top_idx
