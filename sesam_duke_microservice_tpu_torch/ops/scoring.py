"""The device scoring program: per-property kernels + naive-Bayes combine,
and the certified double-double survivor rescorer.

Counterpart of the JAX package's ``ops/scoring.py``.  For a schema feature
plan (``ops.features.SchemaFeatures``) ``build_corpus_scorer`` scores a
block of Q query records against the whole device-resident corpus in
chunks, keeping a running top-K per query:

    for each corpus chunk (a Python loop; every op is queued on the device):
        sims  = per-property pairwise similarities   (ops.cuda_kernels /
                                                      ops.pairwise)
        probs = Duke's [low, high] similarity map     (per property)
        logit = sum of clamped log-odds               (naive Bayes)
        merge chunk scores into the running top-K     (stable sort)

Every device comparator kind scores here: Levenshtein (the Myers tile
kernel up to 256 chars), Jaro-Winkler (its tile kernel up to 32 chars),
q-gram / Jaccard / Dice sets (the intersection kernel up to 256 ids), and
the flat ``ops.pairwise`` paths for wider text and sets, weighted
Levenshtein, exact / different, phonetic, numeric and geoposition.

``build_ann_scorer`` is the ``ann`` backend's program: cosine retrieval
(``ops.encoder``) of a top-C per query, then exact rescoring of those
gathered rows through the same per-property paths.

Host-only comparators contribute an optimistic constant bound through the
survivor filter (``ops.bounds``).  ``build_dd_rescorer`` re-scores a
resolved block's surviving (Q, K) pairs in double-double (``ops.dd``) for
the certified verdict split of ``engine.finalize``.  The float32 arithmetic
follows the JAX program operation for operation, so top-K order and
candidate counts match it.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..core import comparators as C
from . import bounds as B
from . import cuda_kernels as ck
from . import dd as D
from . import encoder as E
from . import features as F
from . import pairwise as pw
from .bounds import _EPS, NEG_INF

__all__ = [
    "NEG_INF", "build_ann_scorer", "build_corpus_scorer", "build_dd_rescorer",
    "build_gathered_pair_logits", "build_pair_logits", "candidate_mask",
    "dd_rescorer", "gather_rows", "rescore_retrieved", "retrieval_amb_eps",
    "saturation_count", "scan_topk",
]


# -- per-property pair similarity -------------------------------------------


def _pair_expand(qa: torch.Tensor, ca: torch.Tensor) -> tuple:
    """(Q, Vq, ...) x (C, Vc, ...) -> flat (Q*C*Vq*Vc, ...) pair operands."""
    q, vq = qa.shape[0], qa.shape[1]
    c, vc = ca.shape[0], ca.shape[1]
    rq = tuple(qa.shape[2:])
    rc = tuple(ca.shape[2:])
    a = qa[:, None, :, None].expand((q, c, vq, vc) + rq)
    b = ca[None, :, None, :].expand((q, c, vq, vc) + rc)
    return (a.reshape((q * c * vq * vc,) + rq),
            b.reshape((q * c * vq * vc,) + rc))


def _pair_expand_gathered(qa: torch.Tensor, ca: torch.Tensor) -> tuple:
    """(Q, Vq, ...) x gathered (Q, C, Vc, ...) -> flat (Q*C*Vq*Vc, ...):
    candidate c of query q is a specific corpus row (the dd layout)."""
    q, vq = qa.shape[0], qa.shape[1]
    c, vc = ca.shape[1], ca.shape[2]
    rq = tuple(qa.shape[2:])
    rc = tuple(ca.shape[3:])
    a = qa[:, None, :, None].expand((q, c, vq, vc) + rq)
    b = ca[:, :, None, :].expand((q, c, vq, vc) + rc)
    return (a.reshape((q * c * vq * vc,) + rq),
            b.reshape((q * c * vq * vc,) + rc))


def _tiled_combo_sim(tile_fn, q: int, c: int, vq: int, vc: int,
                     equal) -> torch.Tensor:
    """Run a (Q, C) tile kernel per (query-value, corpus-value) slot pair
    and stack into the flat (Q*C*Vq*Vc,) layout ``_pair_expand`` makes."""
    eq4 = equal.reshape(q, c, vq, vc)
    rows = []
    for a in range(vq):
        cols = [tile_fn(a, b, eq4[:, :, a, b]) for b in range(vc)]
        rows.append(torch.stack(cols, dim=-1))         # (Q, C, Vc)
    return torch.stack(rows, dim=-2).reshape(-1)       # (Q, C, Vq, Vc)


def _set_names(spec) -> tuple:
    """(ids tensor, count tensor, formula) of a set property."""
    cmp = spec.comparator
    if spec.kind == F.GRAM_SET:
        return "grams", "gram_count", cmp.formula
    formula = "dice" if isinstance(cmp, C.DiceCoefficient) else "jaccard"
    return "tokens", "token_count", formula


def _flat_sim(spec, qf: Dict, cf: Dict, equal, expand=_pair_expand):
    """Flat-path similarity of the kinds with a char or set axis, over
    the expanded (Q*C*Vq*Vc, width) pairs."""
    kind = spec.kind
    cmp = spec.comparator
    if kind in (F.GRAM_SET, F.TOKEN_SET):
        ids, count, formula = _set_names(spec)
        g1, g2 = expand(qf[ids], cf[ids])
        n1, n2 = expand(qf[count], cf[count])
        common = pw.set_intersection_count(g1, n1, g2, n2)
        return pw.sim_from_set_intersection(common, n1, n2, equal,
                                            formula=formula)
    c1, c2 = expand(qf["chars"], cf["chars"])
    l1, l2 = expand(qf["length"], cf["length"])
    if kind == F.CHARS_WEIGHTED:
        k1, k2 = expand(qf["classes"], cf["classes"])
        return pw.weighted_levenshtein_sim(
            c1, k1, l1, c2, k2, l2, equal, digit_weight=cmp.digit_weight,
            letter_weight=cmp.letter_weight, other_weight=cmp.other_weight)
    if isinstance(cmp, C.JaroWinkler):
        return pw.jaro_winkler_sim(
            c1, l1, c2, l2, equal, prefix_scale=cmp.prefix_scale,
            boost_threshold=cmp.boost_threshold,
            max_prefix=int(cmp.max_prefix))
    return pw.levenshtein_sim(c1, l1, c2, l2, equal)


def _flat_sim_blocked(spec, qf: Dict, cf: Dict, equal, width: int,
                      gathered: bool = False):
    """``_flat_sim`` over query sub-blocks of at most
    ``cuda_kernels.BLOCK_ELEMENTS`` expanded (pair x width) elements: the
    same per-pair arithmetic, in pieces that fit on the card (at
    DEVICE_CHUNK=8192, one value slot and 64 chars: 32 queries).
    ``gathered``: ``cf`` holds each query's own (Q, C, Vc, ...) candidates
    and is cut with the queries."""
    q, vq = qf["valid"].shape
    c, vc = cf["valid"].shape[-2:]
    expand = _pair_expand_gathered if gathered else _pair_expand
    eq = equal.reshape(q, -1)
    parts = []
    for s, e in ck.row_blocks(q, c * vq * vc * width):
        sub = {name: t[s:e] for name, t in qf.items()}
        csub = {name: t[s:e] for name, t in cf.items()} if gathered else cf
        parts.append(_flat_sim(spec, sub, csub, eq[s:e].reshape(-1), expand))
    return torch.cat(parts)


def _gathered_sim(spec, qf: Dict, cf: Dict, equal) -> torch.Tensor:
    """Flat (Q*C*Vq*Vc,) similarity of each query against its own gathered
    (Q, C, Vc, ...) candidates (the ``ann`` rescoring layout).  A
    single-slot Levenshtein property of at most 32 chars takes the
    gathered Myers kernel, as the JAX package's Pallas branch does; every
    other kind takes the flat paths."""
    kind = spec.kind
    cmp = spec.comparator
    if (kind == F.CHARS and not isinstance(cmp, C.JaroWinkler)
            and qf["chars"].shape[1] == 1 and cf["chars"].shape[2] == 1
            and qf["chars"].shape[2] <= ck.GATHERED_MAX_CHARS):
        q = qf["valid"].shape[0]
        c = cf["valid"].shape[1]
        qlen = qf["length"][:, 0].contiguous()
        clen = cf["length"][:, :, 0].contiguous()
        dist = ck.myers_distance_gathered(
            qf["chars"][:, 0].contiguous(), qlen,
            cf["chars"][:, :, 0].contiguous(), clen)
        return pw.levenshtein_sim_from_distance(
            dist, qlen[:, None], clen, equal.reshape(q, c)).reshape(-1)
    if kind in (F.CHARS, F.CHARS_WEIGHTED):
        return _flat_sim_blocked(spec, qf, cf, equal, qf["chars"].shape[2],
                                 gathered=True)
    if kind in (F.GRAM_SET, F.TOKEN_SET):
        return _flat_sim_blocked(spec, qf, cf, equal,
                                 qf[_set_names(spec)[0]].shape[2],
                                 gathered=True)
    return _plain_sim(spec, qf, cf, equal, _pair_expand_gathered)


def _plain_sim(spec, qf: Dict, cf: Dict, equal, expand) -> torch.Tensor:
    """Similarity of the kinds without a char or set axis (exact /
    different, phonetic, numeric, geoposition) over expanded pairs."""
    kind = spec.kind
    cmp = spec.comparator
    if kind == F.HASH:
        return (pw.different_sim(equal) if isinstance(cmp, C.Different)
                else pw.exact_sim(equal))
    if kind == F.PHONETIC:
        ch1, ch2 = expand(qf["code_hi"], cf["code_hi"])
        cl1, cl2 = expand(qf["code_lo"], cf["code_lo"])
        cv1, cv2 = expand(qf["code_valid"], cf["code_valid"])
        return pw.phonetic_sim(equal, (ch1 == ch2) & (cl1 == cl2), cv1 & cv2)
    if kind == F.NUMERIC:
        d1, d2 = expand(qf["number"], cf["number"])
        nv1, nv2 = expand(qf["number_valid"], cf["number_valid"])
        return pw.numeric_sim(d1, nv1, d2, nv2, min_ratio=cmp.min_ratio)
    if kind == F.GEO:
        la1, la2 = expand(qf["lat"], cf["lat"])
        lo1, lo2 = expand(qf["lon"], cf["lon"])
        gv1, gv2 = expand(qf["geo_valid"], cf["geo_valid"])
        return pw.geoposition_sim(la1, lo1, gv1, la2, lo2, gv2,
                                  max_distance=cmp.max_distance)
    raise ValueError(  # pragma: no cover - plan() never emits unknown kinds
        f"no device kernel for feature kind {kind!r}")


def _property_sim(spec: F.PropertyFeatureSpec, qf: Dict, cf: Dict,
                  gathered: bool = False) -> tuple:
    """Pair similarity for one property: (sim, combo_valid), both flat
    (Q*C*Vq*Vc,).  Mirrors the JAX ``_property_sim`` with its tile
    branches on; ``gathered`` is its aligned-candidate layout."""
    expand = _pair_expand_gathered if gathered else _pair_expand
    hh1, hh2 = expand(qf["hash_hi"], cf["hash_hi"])
    hl1, hl2 = expand(qf["hash_lo"], cf["hash_lo"])
    v1, v2 = expand(qf["valid"], cf["valid"])
    combo_valid = v1 & v2
    equal = (hh1 == hh2) & (hl1 == hl2) & combo_valid
    if gathered:
        return _gathered_sim(spec, qf, cf, equal), combo_valid

    kind = spec.kind
    cmp = spec.comparator
    q, vq = qf["valid"].shape
    c, vc = cf["valid"].shape
    if kind == F.CHARS:
        jw = isinstance(cmp, C.JaroWinkler)
        width = qf["chars"].shape[2]
        if width <= (ck.JW_MAX_CHARS if jw else ck.MYERS_MAX_CHARS):
            # tiled path: (Q, C) tiles from the hand-written kernels, no
            # expanded (Q*C, L) pair operands
            def tile(a, b, eq):
                args = (qf["chars"][:, a].contiguous(),
                        qf["length"][:, a].contiguous(),
                        cf["chars"][:, b].contiguous(),
                        cf["length"][:, b].contiguous(), eq)
                if jw:
                    return ck.jaro_winkler_sim_tiles(
                        *args, prefix_scale=cmp.prefix_scale,
                        boost_threshold=cmp.boost_threshold,
                        max_prefix=int(cmp.max_prefix))
                return ck.levenshtein_sim_tiles(*args)

            sim = _tiled_combo_sim(tile, q, c, vq, vc, equal)
        else:
            sim = _flat_sim_blocked(spec, qf, cf, equal, width)
    elif kind in (F.GRAM_SET, F.TOKEN_SET):
        ids, count, formula = _set_names(spec)
        width = qf[ids].shape[2]
        if width <= ck.SET_MAX_WIDTH:
            sim = _tiled_combo_sim(
                lambda a, b, eq: ck.set_sim_tiles(
                    qf[ids][:, a].contiguous(), qf[count][:, a].contiguous(),
                    cf[ids][:, b].contiguous(), cf[count][:, b].contiguous(),
                    eq, formula=formula),
                q, c, vq, vc, equal)
        else:
            sim = _flat_sim_blocked(spec, qf, cf, equal, width)
    elif kind == F.CHARS_WEIGHTED:
        sim = _flat_sim_blocked(spec, qf, cf, equal, qf["chars"].shape[2])
    else:
        sim = _plain_sim(spec, qf, cf, equal, _pair_expand)
    return sim, combo_valid


def _property_logit(spec: F.PropertyFeatureSpec, qf: Dict, cf: Dict,
                    q: int, c: int, gathered: bool = False) -> torch.Tensor:
    """Per-pair clamped log-odds contribution of one property: (Q, C) f32.

    Duke's map: sim >= 0.5 -> (high-0.5)*sim^2 + 0.5, else -> low; the max
    over value-pair combos is taken in probability space; a property
    missing on either side is neutral (prob 0.5 -> logit 0).  The same f32
    operations in the same order as the JAX program.
    """
    sim, combo_valid = _property_sim(spec, qf, cf, gathered)
    # Python scalars, not device tensors: building a CUDA tensor from a
    # host value would synchronize the stream inside the chunk loop
    prob = torch.where(sim >= 0.5, (spec.high - 0.5) * sim * sim + 0.5,
                       spec.low)
    prob = torch.where(combo_valid, prob, -1.0)
    # the trailing (Vq*Vc) combo axis folds away; Vq may differ from Vc
    best = prob.reshape(q, c, -1).amax(dim=2)
    any_valid = combo_valid.reshape(q, c, -1).any(dim=2)
    best = torch.where(any_valid, best, 0.5)
    best = best.clamp(_EPS, 1.0 - _EPS)
    return torch.log(best) - torch.log1p(-best)


def build_pair_logits(plan: F.SchemaFeatures) -> Callable:
    """Returns fn(qfeats, cfeats) -> (Q, C) partial logit over device props,
    summed in plan order."""
    specs = list(plan.device_props)

    def pair_logits(qfeats: Dict[str, Dict],
                    cfeats: Dict[str, Dict]) -> torch.Tensor:
        first = next(iter(qfeats.values()))
        q = first["valid"].shape[0]
        firstc = next(iter(cfeats.values()))
        c = firstc["valid"].shape[0]
        total = torch.zeros((q, c), dtype=torch.float32,
                            device=first["valid"].device)
        for spec in specs:
            total = total + _property_logit(
                spec, qfeats[spec.name], cfeats[spec.name], q, c
            )
        return total

    return pair_logits


def build_property_logits(plan: F.SchemaFeatures) -> Callable:
    """The explain variant of ``build_pair_logits``: returns
    fn(qfeats, cfeats) -> (Q, C, P) with the per-property clamped
    log-odds kept un-reduced (axis P follows ``plan.device_props``
    order).  Summed over P it is the pair logit of the fast path: the
    same ``_property_logit`` per property, so on a CUDA tensor the same
    hand kernels run (at the explain call's one-pair shapes), and on a
    CPU tensor their plain versions.  A separate builder, so explain
    traffic never touches the scan's scorers.

    Used by ``engine.explain`` to reproduce a pair's device f32 verdict
    with per-property provenance.
    """
    specs = list(plan.device_props)

    def property_logits(qfeats: Dict[str, Dict],
                        cfeats: Dict[str, Dict]) -> torch.Tensor:
        first = next(iter(qfeats.values()))
        q = first["valid"].shape[0]
        firstc = next(iter(cfeats.values()))
        c = firstc["valid"].shape[0]
        per_prop = [
            _property_logit(spec, qfeats[spec.name], cfeats[spec.name], q, c)
            for spec in specs
        ]
        return torch.stack(per_prop, dim=-1)  # (Q, C, P)

    return property_logits


def candidate_mask(cvalid, cdeleted, cgroup, cidx, query_group, query_row,
                   group_filtering: bool):
    """(Q, chunk) candidate-eligibility mask: live non-tombstoned rows only;
    linkage excludes same-group rows; a query never matches its own row."""
    mask = cvalid & ~cdeleted
    if group_filtering:
        mask = mask & (cgroup[None, :] != query_group[:, None])
    return mask & (cidx[None, :] != query_row[:, None])


def candidate_mask_gathered(gvalid, gdeleted, ggroup, grows, query_group,
                            query_row, group_filtering: bool):
    """``candidate_mask`` for ALIGNED gathered candidates: every operand is
    a (Q, S) per-query gather (the IVF probe, ``ops.ivf``) beside the
    corpus row ids ``grows`` (-1 for padding slots).  The same policy,
    plus the padding-slot exclusion the gathered layout brings."""
    mask = (grows >= 0) & gvalid & ~gdeleted
    if group_filtering:
        mask = mask & (ggroup != query_group[:, None])
    return mask & (grows != query_row[:, None])


# -- the blockwise corpus scorer --------------------------------------------


def scan_topk(pair_logits: Callable, qfeats, corpus_feats, corpus_valid,
              corpus_deleted, corpus_group, query_group, query_row,
              min_logit, *, chunk: int, top_k: int, group_filtering: bool,
              row_offset: int = 0, init=None):
    """Score Q queries against the corpus chunk by chunk, keeping a running
    top-K (mirrors the JAX ``scan_topk`` with a Python loop over chunks).

    Tie order matches ``lax.top_k``: the merge puts the running top-K
    first and the chunk after it in row order, and a STABLE descending
    sort keeps the lower position first among equal logits (the
    ``NEG_INF`` fill included).  Nothing here waits on the device.

    ``row_offset`` maps local corpus rows to global row ids: 0 on one
    device, ``shard * local_capacity`` for a shard of a mesh
    (``parallel.sharded``), so self-exclusion through ``query_row`` and
    the returned ``top_index`` stay global.  ``init`` seeds the running
    ``(top_logit, top_index, count)`` carry: the ring scorer
    (``parallel.ring``) threads a query block's top-K through successive
    shards with it.  The count accumulates in int64 and comes back int32.
    """
    first = next(iter(qfeats.values()))
    q = first["valid"].shape[0]
    device = corpus_valid.device
    cap = corpus_valid.shape[0]
    # the f32 bound as a Python float (exactly representable, so the f32
    # comparison the JAX program makes is the one made here)
    min_logit = float(np.float32(min_logit))
    if init is not None:
        top_logit, top_index, count = init
        count = count.to(torch.int64)
    else:
        top_logit = torch.full((q, top_k), NEG_INF, dtype=torch.float32,
                               device=device)
        top_index = torch.full((q, top_k), -1, dtype=torch.int32,
                               device=device)
        count = torch.zeros((q,), dtype=torch.int64, device=device)
    for start in range(0, cap - cap % chunk, chunk):
        stop = start + chunk
        cf = {
            prop: {name: arr[start:stop] for name, arr in tensors.items()}
            for prop, tensors in corpus_feats.items()
        }
        logits = pair_logits(qfeats, cf)                  # (Q, chunk)
        cidx = torch.arange(row_offset + start, row_offset + stop,
                            dtype=torch.int32, device=device)
        mask = candidate_mask(
            corpus_valid[start:stop], corpus_deleted[start:stop],
            corpus_group[start:stop], cidx, query_group, query_row,
            group_filtering,
        )
        logits = torch.where(mask, logits, NEG_INF)
        count = count + (logits > min_logit).sum(dim=1)
        merged_logit = torch.cat([top_logit, logits], dim=1)
        merged_index = torch.cat([top_index, cidx.expand(q, chunk)], dim=1)
        order = torch.sort(merged_logit, dim=1, descending=True,
                           stable=True).indices[:, :top_k]
        top_logit = merged_logit.gather(1, order)
        top_index = merged_index.gather(1, order)
    return top_logit, top_index, count.to(torch.int32)


def gather_rows(tree, rows: torch.Tensor):
    """Gather record rows out of a corpus feature tree (on device)."""
    return {
        prop: {name: arr.index_select(0, rows) for name, arr in t.items()}
        for prop, t in tree.items()
    }


def build_corpus_scorer(plan: F.SchemaFeatures, *, chunk: int = 512,
                        top_k: int = 64, group_filtering: bool = False,
                        queries_from_rows: bool = False) -> Callable:
    """Build the query-block x corpus scorer::

        fn(qfeats, corpus_feats, corpus_valid, corpus_deleted, corpus_group,
           query_group, query_row, min_logit)
        -> (top_logit (Q, K) f32, top_index (Q, K) i32, count_above (Q,) i32)

    ``corpus_*`` tensors are padded to a multiple of ``chunk`` rows.  With
    ``queries_from_rows`` the ``qfeats`` argument is ignored and the query
    features are gathered on the device from the corpus at ``query_row``
    (padding rows, -1, gather row 0 and are discarded by the caller).
    """
    pair_logits = build_pair_logits(plan)

    def score(qfeats, corpus_feats, corpus_valid, corpus_deleted,
              corpus_group, query_group, query_row, min_logit):
        if queries_from_rows:
            qfeats = gather_rows(corpus_feats, query_row.clamp_min(0))
        return scan_topk(
            pair_logits, qfeats, corpus_feats, corpus_valid, corpus_deleted,
            corpus_group, query_group, query_row, min_logit,
            chunk=chunk, top_k=top_k, group_filtering=group_filtering,
        )

    return score


# -- the ann backend: cosine retrieval + exact rescoring ----------------------


def build_gathered_pair_logits(plan: F.SchemaFeatures) -> Callable:
    """Returns fn(qfeats (Q, ...), cfeats gathered (Q, C, ...)) -> (Q, C):
    ``build_pair_logits`` for aligned candidates (candidate c of query q
    is a specific corpus row), summed in plan order."""
    specs = list(plan.device_props)

    def pair_logits(qfeats: Dict[str, Dict],
                    cfeats: Dict[str, Dict]) -> torch.Tensor:
        first = next(iter(cfeats.values()))["valid"]
        q, c = first.shape[0], first.shape[1]
        total = torch.zeros((q, c), dtype=torch.float32, device=first.device)
        for spec in specs:
            total = total + _property_logit(
                spec, qfeats[spec.name], cfeats[spec.name], q, c,
                gathered=True)
        return total

    return pair_logits


def retrieval_amb_eps(q_tree, emb_tree):
    """int8 storage's certified per-block cosine error bound (the
    escalation trigger's ambiguity credit), or None for bf16 storage."""
    if E.is_int8_tree(emb_tree):
        return E.int8_cosine_eps_dynamic(q_tree, emb_tree)
    return None


def saturation_count(logits, top_sim, retrieved, min_logit: float, amb_eps):
    """The escalation count of every retrieval tail: candidates above
    ``min_logit``, plus -- under int8 storage, when the retrieved set is
    full -- the above-bound candidates whose cosine sits within
    ``2 * amb_eps`` of the top-C cutoff (a candidate displaced by
    quantization is cosine-adjacent to exactly these)."""
    above = logits > min_logit
    count = above.sum(dim=1).to(torch.int32)
    if amb_eps is not None:
        full = retrieved.all(dim=1)
        cutoff = top_sim[:, -1:]  # sorted descending: the smallest kept
        amb = ((top_sim < cutoff + 2.0 * amb_eps) & retrieved & above).sum(
            dim=1).to(torch.int32)
        count = count + torch.where(full, amb, 0)
    return count


def rescore_retrieved(pair_logits, qfeats, corpus_feats, top_sim, top_index,
                      min_logit: float, *, amb_eps=None):
    """Gather the retrieved rows' features, score them with the exact
    per-property kernels and count for escalation: ``(logits (Q, C),
    top_index, count (Q,))``; empty slots (-1) score NEG_INF."""
    retrieved = top_index >= 0
    q, top_c = top_index.shape
    rows = top_index.clamp_min(0).reshape(-1)
    cfeats = {
        prop: {name: arr.index_select(0, rows).reshape(
                   (q, top_c) + tuple(arr.shape[1:]))
               for name, arr in tensors.items()}
        for prop, tensors in corpus_feats.items()
    }
    logits = torch.where(retrieved, pair_logits(qfeats, cfeats), NEG_INF)
    count = saturation_count(logits, top_sim, retrieved, min_logit, amb_eps)
    return logits, top_index, count


def build_ann_scorer(plan: F.SchemaFeatures, *, chunk: int = 512,
                     top_c: int = 64, group_filtering: bool = False,
                     queries_from_rows: bool = False) -> Callable:
    """The two-stage ``ann`` program: cosine retrieval of the top ``top_c``
    rows per query (``ops.encoder.retrieval_scan``), then exact rescoring
    of those rows::

        fn(q_emb, qfeats, corpus_emb, corpus_feats, corpus_valid,
           corpus_deleted, corpus_group, query_group, query_row, min_logit)
        -> (top_logit (Q, C), top_index (Q, C), count_above (Q,))

    The logits are on ``build_corpus_scorer``'s scale; only the candidate
    set is approximate, and ``count_above`` reaching ``top_c`` tells the
    caller to escalate C.  ``corpus_emb`` / ``q_emb`` are ANN_PROP tensor
    dicts; ``corpus_feats`` holds the other properties.  With
    ``queries_from_rows`` both query sides are gathered from the corpus at
    ``query_row`` and ``q_emb`` / ``qfeats`` are ignored.
    """
    pair_logits = build_gathered_pair_logits(plan)

    def score(q_emb, qfeats, corpus_emb, corpus_feats, corpus_valid,
              corpus_deleted, corpus_group, query_group, query_row,
              min_logit):
        emb_tree = E.as_emb_tree(corpus_emb)
        if queries_from_rows:
            qrows = query_row.clamp_min(0)
            q_tree = {name: arr.index_select(0, qrows)
                      for name, arr in emb_tree.items()}
            qfeats = gather_rows(corpus_feats, qrows)
        else:
            q_tree = E.as_emb_tree(q_emb)
        top_sim, top_index = E.retrieval_scan(
            q_tree, emb_tree, corpus_valid, corpus_deleted, corpus_group,
            query_group, query_row, chunk=chunk, top_c=top_c,
            group_filtering=group_filtering)
        return rescore_retrieved(
            pair_logits, qfeats, corpus_feats, top_sim, top_index,
            float(np.float32(min_logit)),
            amb_eps=retrieval_amb_eps(q_tree, emb_tree))

    return score


# -- the dd survivor rescore program ------------------------------------------
#
# Counterpart of the JAX package's ``build_dd_rescorer`` (ops/scoring.py
# :410-817): the resolved block's (Q, K) survivor pairs are gathered from
# the corpus and their ratio -> probability map -> clamped logit is redone
# in double-double from the exact integer counts.  Plain torch operators
# on (hi, lo) pairs, each its own kernel, so nothing fuses a multiply into
# an add (see ops/dd.py); the one kernel here is the gathered Myers
# distance of single-slot Levenshtein properties of at most 32 chars.

# JW branch-guard half-width: far above the ~1e-12 evaluation noise of
# ``j``, far below the ~1e-7 rational spacing of non-boundary values;
# pairs inside it go to the host residue.
_DD_JW_BRANCH_GUARD = float(np.float32(1e-9))
# The oracle's clamp rails (core.bayes.probability_logit).
_DD_EPS_P = 1e-10


def _dd_map_probability(spec, sim, one):
    """Duke's probability map in dd, returning (p, one_minus_p): ``p``
    term for term as the oracle's ``(high-0.5)*sim^2 + 0.5``, the
    complement in the cancellation-free form ``0.5*(1-sim^2) +
    (1-high)*sim^2`` so its relative accuracy survives ``high`` near 1."""
    like = sim[0]
    half = D.const(0.5, like)
    ge05 = D.ge(sim, half)
    s2 = D.mul(sim, sim)
    hc = D.const(float(spec.high) - 0.5, like)
    p_hi = D.add(D.mul(hc, s2), half)
    omp_hi = D.add(
        D.mul(half, D.sub(one, s2)),
        D.mul(D.const(1.0 - float(spec.high), like), s2),
    )
    p_lo = D.const(float(spec.low), like)
    omp_lo = D.const(1.0 - float(spec.low), like)
    return D.where(ge05, p_hi, p_lo), D.where(ge05, omp_hi, omp_lo)


def _dd_levenshtein_sim(c1, l1, c2, l2, equal, *, dist=None):
    """Levenshtein similarity in dd from the exact integer distance."""
    if dist is None:
        if c1.shape[1] <= 32:
            dist = pw.levenshtein_distance_myers(c1, l1, c2, l2)
        else:
            dist = pw.levenshtein_distance(c1, l1, c2, l2)
    shorter = torch.minimum(l1, l2)
    longer = torch.maximum(l1, l2)
    dist = torch.minimum(dist, shorter)
    one = D.from_f32(torch.ones(dist.shape, dtype=torch.float32,
                                device=dist.device))
    sim = D.sub(one, D.div(D.from_int(dist),
                           D.from_int(shorter.clamp_min(1))))
    zero = ((longer - shorter) * 2 > shorter) | (shorter == 0)
    sim = D.where(zero, D.const(0.0, sim[0]), sim)
    return D.where(equal, one, sim)


def _dd_jaro_winkler_sim(c1, l1, c2, l2, equal, cmp):
    """Jaro-Winkler in dd from the exact match / transposition / prefix
    counts.  Returns (sim, branch_unsafe): pairs whose ``j`` sits inside
    the guard band of the 0.5 map split or the boost threshold go to the
    host residue."""
    m, t = pw.jaro_counts(c1, l1, c2, l2)
    prefix = pw.common_prefix_count(c1, c2, l1, l2,
                                    max_prefix=int(cmp.max_prefix))
    md = D.from_int(m)
    a = D.div(md, D.from_int(l1.clamp_min(1)))
    b = D.div(md, D.from_int(l2.clamp_min(1)))
    cpart = D.div(D.from_int(m - t), D.from_int(m.clamp_min(1)))
    like = a[0]
    j = D.div(D.add(D.add(a, b), cpart), D.const(3.0, like))
    zero = (m == 0) | (l1 == 0) | (l2 == 0)
    j = D.where(zero, D.const(0.0, like), j)
    one = D.from_f32(torch.ones_like(like))
    # oracle: j + prefix * prefix_scale * (1.0 - j), left-associated
    boosted = D.add(j, D.mul(
        D.mul(D.from_int(prefix), D.const(float(cmp.prefix_scale), like)),
        D.sub(one, j),
    ))
    boost_c = D.const(float(cmp.boost_threshold), like)
    sim = D.where(D.lt(j, boost_c), j, boosted)
    near_map = D.sub(j, D.const(0.5, like))[0].abs() < _DD_JW_BRANCH_GUARD
    near_boost = D.sub(j, boost_c)[0].abs() < _DD_JW_BRANCH_GUARD
    unsafe = (near_map | near_boost) & ~equal & ~zero
    return D.where(equal, one, sim), unsafe


def _dd_set_sim(common, f1, f2, equal, *, formula):
    """Set-overlap similarity in dd from exact intersection counts."""
    c = D.from_int(common)
    if formula == "jaccard":
        sim = D.div(c, D.from_int((f1 + f2 - common).clamp_min(1)))
    elif formula == "dice":
        sim = D.div(D.from_int(2 * common),
                    D.from_int((f1 + f2).clamp_min(1)))
    else:
        sim = D.div(c, D.from_int(torch.minimum(f1, f2).clamp_min(1)))
    one = D.from_f32(torch.ones(common.shape, dtype=torch.float32,
                                device=common.device))
    sim = D.where((f1 == 0) | (f2 == 0), D.const(0.0, sim[0]), sim)
    return D.where(equal, one, sim)


def _dd_property_sim(spec, qf, cf):
    """(dd sim, combo_valid, branch_unsafe | None) for one certified
    property in the gathered layout ((Q, Vq, ...) queries x (Q, K, Vc, ...)
    candidates), flat combos."""
    expand = _pair_expand_gathered
    hh1, hh2 = expand(qf["hash_hi"], cf["hash_hi"])
    hl1, hl2 = expand(qf["hash_lo"], cf["hash_lo"])
    v1, v2 = expand(qf["valid"], cf["valid"])
    combo_valid = v1 & v2
    equal = (hh1 == hh2) & (hl1 == hl2) & combo_valid

    kind = spec.kind
    cmp = spec.comparator
    if kind == F.CHARS and isinstance(cmp, C.JaroWinkler):
        c1, c2 = expand(qf["chars"], cf["chars"])
        l1, l2 = expand(qf["length"], cf["length"])
        sim, branch_unsafe = _dd_jaro_winkler_sim(c1, l1, c2, l2, equal, cmp)
        return sim, combo_valid, branch_unsafe
    if kind == F.CHARS:
        if (qf["chars"].shape[1] == 1 and cf["chars"].shape[2] == 1
                and qf["chars"].shape[2] <= ck.GATHERED_MAX_CHARS):
            # the single-slot shape: the gathered Myers kernel's exact
            # integer distance, the ratio and map in dd outside it
            q = qf["valid"].shape[0]
            k = cf["valid"].shape[1]
            dist = ck.myers_distance_gathered(
                qf["chars"][:, 0].contiguous(),
                qf["length"][:, 0].contiguous(),
                cf["chars"][:, :, 0].contiguous(),
                cf["length"][:, :, 0].contiguous(),
            ).reshape(-1)
            l1 = qf["length"][:, None, 0].expand(q, k).reshape(-1)
            l2 = cf["length"][:, :, 0].reshape(-1)
            return (_dd_levenshtein_sim(None, l1, None, l2, equal,
                                        dist=dist), combo_valid, None)
        c1, c2 = expand(qf["chars"], cf["chars"])
        l1, l2 = expand(qf["length"], cf["length"])
        return (_dd_levenshtein_sim(c1, l1, c2, l2, equal), combo_valid,
                None)
    if kind in (F.GRAM_SET, F.TOKEN_SET):
        ids, count, formula = _set_names(spec)
        g1, g2 = expand(qf[ids], cf[ids])
        n1, n2 = expand(qf[count], cf[count])
        common = pw.set_intersection_count(g1, n1, g2, n2)
        return (_dd_set_sim(common, n1, n2, equal, formula=formula),
                combo_valid, None)
    one = D.from_f32(torch.ones(equal.shape, dtype=torch.float32,
                                device=equal.device))
    zero = D.const(0.0, one[0])
    if kind == F.HASH:
        if isinstance(cmp, C.Different):
            return D.where(equal, zero, one), combo_valid, None
        return D.where(equal, one, zero), combo_valid, None
    if kind == F.PHONETIC:
        ch1, ch2 = expand(qf["code_hi"], cf["code_hi"])
        cl1, cl2 = expand(qf["code_lo"], cf["code_lo"])
        cv1, cv2 = expand(qf["code_valid"], cf["code_valid"])
        code_eq = (ch1 == ch2) & (cl1 == cl2) & cv1 & cv2
        sim = D.where(code_eq, D.const(0.9, one[0]), zero)
        return D.where(equal, one, sim), combo_valid, None
    raise ValueError(  # pragma: no cover - dd_certifiable_spec gates kinds
        f"no dd kernel for feature kind {kind!r}")


def _dd_property_logit(spec, qf, cf, q: int, c: int):
    """One certified property's clamped log-odds in dd plus its
    branch-unsafety: (((Q, C) hi, lo), (Q, C) bool).  The max over value
    combos is taken in probability space, then the clamped logit, with
    the clamp rails emitting the oracle's own f64 constants; a pair is
    unsafe when any valid combo carries a branch-guard flag."""
    sim, combo_valid, branch_unsafe = _dd_property_sim(spec, qf, cf)
    one = D.from_f32(torch.ones_like(sim[0]))
    p, omp = _dd_map_probability(spec, sim, one)
    ncombo = sim[0].shape[0] // (q * c)
    p3 = (p[0].reshape(q, c, ncombo), p[1].reshape(q, c, ncombo))
    omp3 = (omp[0].reshape(q, c, ncombo), omp[1].reshape(q, c, ncombo))
    valid3 = combo_valid.reshape(q, c, ncombo)
    best_p = D.const(-1.0, p3[0][:, :, 0])
    best_omp = D.const(1.0, best_p[0])
    for i in range(ncombo):
        pi = (p3[0][:, :, i], p3[1][:, :, i])
        oi = (omp3[0][:, :, i], omp3[1][:, :, i])
        take = valid3[:, :, i] & D.lt(best_p, pi)
        best_p = D.where(take, pi, best_p)
        best_omp = D.where(take, oi, best_omp)
    any_valid = valid3.any(dim=2)

    like = best_p[0]
    eps = D.const(_DD_EPS_P, like)
    ome = D.const(1.0 - _DD_EPS_P, like)
    below = D.le(best_p, eps)
    above = D.ge(best_p, ome)
    pc = D.clamp(best_p, eps, ome)
    # complement floor far below the real rail: rail lanes take the
    # oracle's constants right after; this only keeps the division finite
    ompc = D.clamp(best_omp, D.const(1e-12, like), D.const(1.0, like))
    logit = D.log(D.div(pc, ompc))
    logit = D.where(above, D.const(B.probability_to_logit(1.0), like), logit)
    logit = D.where(below, D.const(B.probability_to_logit(0.0), like), logit)
    if branch_unsafe is None:
        unsafe_qc = torch.zeros((q, c), dtype=torch.bool, device=like.device)
    else:
        unsafe_qc = (branch_unsafe.reshape(q, c, ncombo) & valid3).any(dim=2)
    return D.where(any_valid, logit, D.const(0.0, like)), unsafe_qc


def _dd_unsafe_mask(spec, qf, cf, *, value_slots_cap: int) -> torch.Tensor:
    """(Q, C) bool: pairs whose tensors MAY have truncated the records --
    value slots full at the auto-growth cap, a length at the char width,
    a set count at the gram / token capacity.  Such pairs take the host
    compare (reason "truncation")."""
    def side(f):
        valid = f["valid"]
        u = torch.zeros(valid.shape[:-1], dtype=torch.bool,
                        device=valid.device)
        if value_slots_cap and valid.shape[-1] >= value_slots_cap:
            u = u | valid.all(dim=-1)
        if spec.kind == F.CHARS:
            width = f["chars"].shape[-1]
            u = u | ((f["length"] >= width) & valid).any(dim=-1)
        elif spec.kind in (F.GRAM_SET, F.TOKEN_SET):
            ids, count, _ = _set_names(spec)
            cap = f[ids].shape[-1]
            u = u | ((f[count] >= cap) & valid).any(dim=-1)
        return u

    return side(qf)[:, None] | side(cf)


def build_dd_rescorer(plan: "F.SchemaFeatures", *,
                      queries_from_rows: bool = True,
                      value_slots_cap: int = 0):
    """The survivor dd-rescore program, or None when no property is
    dd-certifiable::

        fn(qfeats, corpus_feats, query_row, top_index)
          -> (logit_hi (Q, K) f32, logit_lo (Q, K) f32, unsafe (Q, K) bool)

    ``top_index`` is the resolved block's (Q, K) corpus rows (-1 padding
    gathers row 0; the caller ignores those lanes); ``qfeats`` is ``{}``
    under ``queries_from_rows`` (query features gather from the corpus at
    ``query_row``).  ``hi + lo`` summed in f64 on the host is the dd logit
    over the dd-certifiable properties.  The queries run in sub-blocks of
    at most ``cuda_kernels.BLOCK_ELEMENTS`` expanded pair elements, with
    the same per-pair arithmetic.
    """
    specs = B.dd_plan_specs(plan)
    if not specs:
        return None

    def width(spec, f):
        if spec.kind == F.CHARS:
            return f["chars"].shape[-1]
        if spec.kind in (F.GRAM_SET, F.TOKEN_SET):
            return f[_set_names(spec)[0]].shape[-1]
        return 1

    def rescore(qfeats, corpus_feats, query_row, top_index):
        q, k = top_index.shape
        device = top_index.device
        rows_all = top_index.clamp_min(0)
        if queries_from_rows:
            qrows = query_row.clamp_min(0)
            qfeats = {
                spec.name: {name: arr.index_select(0, qrows)
                            for name, arr in corpus_feats[spec.name].items()}
                for spec in specs
            }
        per_query = k * max(
            qfeats[s.name]["valid"].shape[1]
            * corpus_feats[s.name]["valid"].shape[1]
            * width(s, corpus_feats[s.name]) for s in specs)
        his, los, unsafes = [], [], []
        for s, e in ck.row_blocks(q, per_query):
            n = e - s
            rows = rows_all[s:e].reshape(-1)
            total = (torch.zeros((n, k), dtype=torch.float32, device=device),
                     torch.zeros((n, k), dtype=torch.float32, device=device))
            unsafe = torch.zeros((n, k), dtype=torch.bool, device=device)
            for spec in specs:
                cf = {name: arr.index_select(0, rows).reshape(
                          (n, k) + tuple(arr.shape[1:]))
                      for name, arr in corpus_feats[spec.name].items()}
                qf = {name: t[s:e] for name, t in qfeats[spec.name].items()}
                prop_logit, branch_unsafe = _dd_property_logit(
                    spec, qf, cf, n, k)
                total = D.add(total, prop_logit)
                unsafe = unsafe | branch_unsafe | _dd_unsafe_mask(
                    spec, qf, cf, value_slots_cap=value_slots_cap)
            his.append(total[0])
            los.append(total[1])
            unsafes.append(unsafe)
        return torch.cat(his), torch.cat(los), torch.cat(unsafes)

    return rescore


# Process-wide memo of built dd rescorers by plan VALUE: many workloads
# share one schema shape.  Lock-free by design: a concurrent miss builds
# twice and one instance wins the dict slot.  Bounded FIFO.
_DD_CACHE: Dict[tuple, object] = {}
_DD_CACHE_CAP = 64


def _dd_plan_key(plan: "F.SchemaFeatures", extra: tuple) -> tuple:
    key = [extra]
    for s in B.dd_plan_specs(plan):
        cmp = s.comparator
        key.append((
            s.name, s.kind, float(s.low), float(s.high), s.v, s.chars,
            type(cmp).__name__,
            getattr(cmp, "formula", None),
            float(getattr(cmp, "prefix_scale", 0.0)),
            float(getattr(cmp, "boost_threshold", 0.0)),
            int(getattr(cmp, "max_prefix", 0)),
        ))
    return tuple(key)


def dd_rescorer(plan: "F.SchemaFeatures", *, queries_from_rows: bool = True,
                value_slots_cap: int = 0):
    """Memoized ``build_dd_rescorer`` (None when nothing is certifiable)."""
    if not B.dd_plan_specs(plan):
        return None
    key = _dd_plan_key(plan, (queries_from_rows, value_slots_cap))
    fn = _DD_CACHE.get(key)
    if fn is None:
        fn = build_dd_rescorer(plan, queries_from_rows=queries_from_rows,
                               value_slots_cap=value_slots_cap)
        if len(_DD_CACHE) >= _DD_CACHE_CAP:
            _DD_CACHE.pop(next(iter(_DD_CACHE)))
        _DD_CACHE[key] = fn
    return fn
