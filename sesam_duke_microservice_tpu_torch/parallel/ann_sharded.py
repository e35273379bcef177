"""Mesh-sharded ``ann`` scoring: retrieval + rescoring per shard, merge on
the lead device.

Counterpart of the JAX package's ``parallel/ann_sharded.py``: the two-stage
``ann`` program (``ops.scoring.build_ann_scorer``) over the record-axis
layout of ``parallel.sharded`` -- corpus tensors, the ``ops.encoder``
embedding tree among them (the int8 scale vector splits with it), split
over the shards; queries replicated.

Per-shard work is local: cosine top-C over the shard's embedding rows
(``ops.encoder.retrieval_scan`` with the shard's ``row_offset`` -- on the
card the segment-max kernel wherever the fused route takes the LOCAL
shape), then exact rescoring of the shard's candidates, whose rows are
clipped into the shard's local range before the gather (on the card the
gathered Myers kernel), so no gather crosses shards.  Only the (Q, C)
scored results move to the lead device, where ``merge_topk`` reduces the
D lists to the global top-C (across processes: one ``all_gather`` for the
merge and one ``all_reduce`` for the saturation count).

The merged candidate pool is a superset of the single-device pool on the
scan route, whose top-C is exact: every shard keeps its own local top-C
before the merge, and the global top-C by cosine lies in their union
(tests/test_torch_ann_sharded.py).  The fused route's top-C is over
strided bins of the capacity (``encoder.fused_route``), so the superset
holds there only where each shard's local shape puts the same rows in its
bins as the single-device app's -- each shard holding that app's capacity
(``chip_smoke.py``'s mesh phase sizes the ``sharded`` app so, for the
fused route's gate).  Where the shards hold less (a deployment's granule
growth, or one budget split over D cards), a shard may take the other
route, or bin its rows apart: the sharded pool can then miss a
single-device candidate, and blocking recall can fall as well as rise.

IVF placement follows the shared partition rules: the ``(nshards * K, B)``
cell-membership matrix of shard-LOCAL rows splits so each shard sees its
own (K, B) block, while the small (K, D) centroid matrix is copied to
every shard.  Every shard probes the same top-``nprobe`` cells and scans
only its local members of those cells.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops import encoder as E
from ..ops import ivf as IVF
from ..ops import scoring as S
from .sharded import max_counts, merge_topk, replicate, shard_offsets


def _local_rescore(pair_logits, q_tree, qfeats, feats, emb_tree, top_sim,
                   top_index, row_offset: int, min_logit: float, *,
                   top_c: int):
    """Per-shard tail of both sharded ``ann`` programs: exact rescoring of
    the shard's retrieved candidates (gathers never cross shards) and the
    shared ``scoring.saturation_count`` on the LOCAL count (a local top-C
    whose int8 cutoff band holds quantization-ambiguous candidates may
    have truncated a true candidate before the merge)."""
    retrieved = top_index >= 0
    local_rows = (top_index - row_offset).clamp_min(0).reshape(-1)
    q = top_index.shape[0]
    cfeats = {
        prop: {name: arr.index_select(0, local_rows).reshape(
                   (q, top_c) + tuple(arr.shape[1:]))
               for name, arr in tensors.items()}
        for prop, tensors in feats.items()
    }
    logits = torch.where(retrieved, pair_logits(qfeats, cfeats), S.NEG_INF)
    local_count = S.saturation_count(
        logits, top_sim, retrieved, min_logit,
        S.retrieval_amb_eps(q_tree, emb_tree))
    return logits, top_index, local_count


def _merge(mesh, logits, top_index, local_count, min_logit: float, *,
           top_c: int):
    """Merge the per-shard (Q, C) results to the global top-C.

    The escalation signal sees BOTH truncation modes: a shard whose local
    top-C saturated (it may have dropped above-bound rows before the
    merge: the max over shards of ``local_count``), and a merged pool with
    more above-bound rows than the merge keeps (rows are unique across
    shards, so counting the merged pool counts each candidate once)."""
    out_logit, out_index, merged_logit = merge_topk(mesh, logits, top_index,
                                                    top_c)
    merged_above = (merged_logit > min_logit).sum(dim=1).to(torch.int32)
    local_max = max_counts(mesh, local_count)
    return out_logit, out_index, torch.maximum(local_max, merged_above)


def _split_ann(tree):
    """A shard's corpus tree -> (its embedding tree, the property
    features)."""
    return (E.as_emb_tree(tree[E.ANN_PROP]),
            {prop: t for prop, t in tree.items() if prop != E.ANN_PROP})


def build_sharded_ann_scorer(plan, mesh, *, chunk: int = 512,
                             top_c: int = 64,
                             group_filtering: bool = False) -> Callable:
    """``ops.scoring.build_ann_scorer`` over a record-axis-split corpus::

        fn(q_emb, qfeats, corpus_feats, corpus_valid, corpus_deleted,
           corpus_group, query_group, query_row, min_logit)
        -> (top_logit (Q, C), top_index (Q, C) global rows, count_sat (Q,))

    ``corpus_*`` are per-shard lists; each shard's tree includes the
    ``ops.encoder.ANN_PROP`` embedding tree ({emb} bf16 or {emb, scale}
    int8).  ``count_sat`` is the recall-escalation signal: the max of
    (a) any shard's local above-``min_logit`` count, widened by the int8
    cosine-ambiguity credit, and (b) the merged pool's above-bound count.
    The caller escalates when ``count_sat >= top_c``."""
    pair_logits = S.build_gathered_pair_logits(plan)

    def score(q_emb, qfeats, corpus_feats, corpus_valid, corpus_deleted,
              corpus_group, query_group, query_row, min_logit):
        min_logit = float(np.float32(min_logit))
        offsets = shard_offsets(mesh, corpus_valid[0].shape[0])
        qt, qf, qg, qr = (replicate(mesh, t) for t in (
            E.as_emb_tree(q_emb), qfeats, query_group, query_row))
        logits, index, counts = [], [], []
        for s in range(mesh.local_size):
            emb_tree, feats = _split_ann(corpus_feats[s])
            top_sim, top_index = E.retrieval_scan(
                qt[s], emb_tree, corpus_valid[s], corpus_deleted[s],
                corpus_group[s], qg[s], qr[s], chunk=chunk, top_c=top_c,
                group_filtering=group_filtering, row_offset=offsets[s])
            out = _local_rescore(pair_logits, qt[s], qf[s], feats, emb_tree,
                                 top_sim, top_index, offsets[s], min_logit,
                                 top_c=top_c)
            logits.append(out[0])
            index.append(out[1])
            counts.append(out[2])
        return _merge(mesh, logits, index, counts, min_logit, top_c=top_c)

    return score


def build_sharded_ivf_scorer(plan, mesh, *, top_c: int = 64,
                             nprobe: int = 8,
                             group_filtering: bool = False) -> Callable:
    """IVF cell-probe retrieval over the mesh::

        fn(q_emb, qfeats, corpus_feats, centroids, cell_rows, corpus_valid,
           corpus_deleted, corpus_group, query_group, query_row, min_logit)
        -> (top_logit, top_index, count_sat)

    ``centroids`` is the per-shard list of (K, D) copies, ``cell_rows``
    the per-shard list of (K, B) local-row membership blocks of the
    stacked matrix ``ops.ivf.IvfState(nshards=mesh.size)`` builds."""
    pair_logits = S.build_gathered_pair_logits(plan)
    slot_chunk = IVF.scan_slots()

    def score(q_emb, qfeats, corpus_feats, centroids, cell_rows,
              corpus_valid, corpus_deleted, corpus_group, query_group,
              query_row, min_logit):
        min_logit = float(np.float32(min_logit))
        offsets = shard_offsets(mesh, corpus_valid[0].shape[0])
        qt, qf, qg, qr = (replicate(mesh, t) for t in (
            E.as_emb_tree(q_emb), qfeats, query_group, query_row))
        logits, index, counts = [], [], []
        for s in range(mesh.local_size):
            emb_tree, feats = _split_ann(corpus_feats[s])
            top_sim, top_index = IVF.ivf_probe_topc(
                qt[s], emb_tree, centroids[s], cell_rows[s],
                corpus_valid[s], corpus_deleted[s], corpus_group[s], qg[s],
                qr[s], top_c=top_c, nprobe=nprobe, slot_chunk=slot_chunk,
                group_filtering=group_filtering, row_offset=offsets[s])
            out = _local_rescore(pair_logits, qt[s], qf[s], feats, emb_tree,
                                 top_sim, top_index, offsets[s], min_logit,
                                 top_c=top_c)
            logits.append(out[0])
            index.append(out[1])
            counts.append(out[2])
        return _merge(mesh, logits, index, counts, min_logit, top_c=top_c)

    return score
