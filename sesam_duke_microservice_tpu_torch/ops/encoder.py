"""Hashed character-n-gram record embeddings and the ``ann`` backend's
cosine retrieval.

Counterpart of the JAX package's ``ops/encoder.py``.  The ``ann`` backend
(``engine.ann_matcher``) replaces brute-force blocking with two stages: a
cosine top-C retrieval over a dense embedding matrix, then exact rescoring
of only the retrieved rows (``ops.scoring.build_ann_scorer``).  Every
comparison property's character trigrams are hashed into a signed
D-dimensional vector (the hashing trick), L2-normalized; no learned
weights, the encoder is deterministic from the schema alone.

Host half: ``ops.embedding`` (the encoder and the corpus storage
layouts, bf16 or int8 + scale), which imports no torch and whose names
this module re-exports.

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
from typing import Dict

import torch

from ..env import env_flag, env_float, env_int
from . import cuda_kernels as ck
from .bounds import NEG_INF
from .embedding import (  # noqa: F401 -- the host half, re-exported
    ANN_PROP,
    ANN_SCALE,
    ANN_TENSOR,
    RecordEncoder,
    _salt,
    bf16_bits,
    bf16_to_f32,
    corpus_tensors_from_f32,
    dequantize_rows,
    embed_batch,
    embed_values,
    int8_cosine_eps,
    int8_enabled,
    quantize_rows,
    storage_name,
)


# Retrieval calls by route since the last reset (the fused route is the
# one that launches the segment-max kernel).
ROUTES = {"fused": 0, "scan": 0}


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
                     tc: int, seg: int, group_filtering: bool,
                     row_offset: int = 0):
    """The fused route: per-bin (max, argmax) from the segment-max kernel,
    then the exact top-C over the bin winners; all-masked bins (-3e38)
    come back as row -1.  The kernel masks in local row coordinates, so
    the query's own global row shifts down by ``row_offset`` (a negative
    row matches nothing) and the winners shift back up."""
    if row_offset:
        query_row = query_row - row_offset
    seg_max, seg_arg = ck.retrieval_segmax(
        q_emb.to(torch.bfloat16).contiguous(),
        corpus_emb.to(torch.bfloat16).contiguous(), corpus_valid,
        corpus_deleted, corpus_group, query_row, query_group, tc=tc,
        seg=seg, group_filtering=group_filtering)
    sel = _stable_desc(seg_max)[:, :top_c]
    top_sim = seg_max.gather(1, sel)
    top_idx = torch.where(top_sim < -1e30, -1,
                          seg_arg.gather(1, sel) + row_offset)
    return top_sim, top_idx


def retrieval_scan(q_emb, corpus_emb, corpus_valid, corpus_deleted,
                   corpus_group, query_group, query_row, *, chunk: int,
                   top_c: int, group_filtering: bool, row_offset: int = 0):
    """Cosine top-C of each query over the corpus embedding matrix:
    ``(top_sim (Q, C) f32, top_index (Q, C) int32)``, -1 for empty slots.
    ``row_offset`` maps local rows to global ids as in ``ops.scoring.
    scan_topk`` (a shard of a mesh passes its first global row).

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
                tc=route[0], seg=route[1], group_filtering=group_filtering,
                row_offset=row_offset)
    ROUTES["scan"] += 1

    top_sim = torch.full((q, top_c), NEG_INF, dtype=torch.float32,
                         device=device)
    top_idx = torch.full((q, top_c), -1, dtype=torch.int32, device=device)
    for start in range(0, cap - cap % chunk, chunk):
        stop = start + chunk
        sims = chunk_sims(q_tree, corpus_emb[start:stop],
                          c_tree[ANN_SCALE][start:stop] if int8 else None)
        cidx = torch.arange(row_offset + start, row_offset + stop,
                            dtype=torch.int32, device=device)
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
