"""The device scoring program: per-property kernels + naive-Bayes combine.

Counterpart of the brute-force half of the JAX package's ``ops/scoring.py``.
For a schema feature plan (``ops.features.SchemaFeatures``) it scores a
block of Q query records against the whole device-resident corpus in
chunks, keeping a running top-K per query:

    for each corpus chunk (a Python loop; every op is queued on the device):
        sims  = per-property pairwise similarities   (ops.cuda_kernels /
                                                      ops.pairwise)
        probs = Duke's [low, high] similarity map     (per property)
        logit = sum of clamped log-odds               (naive Bayes)
        merge chunk scores into the running top-K     (stable sort)

Host-only comparators contribute an optimistic constant bound through the
survivor filter (``ops.bounds``); survivors are rescored exactly on the host
(engine.finalize).  The float32 arithmetic follows the JAX program operation
for operation, so top-K order and candidate counts match it exactly.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..core import comparators as C
from ..core.records import SchemaError
from . import cuda_kernels as ck
from . import features as F
from . import pairwise as pw
from .bounds import _EPS, NEG_INF

__all__ = [
    "NEG_INF", "build_corpus_scorer", "build_pair_logits", "candidate_mask",
    "check_plan", "gather_rows", "scan_topk",
]


def _unsupported(spec) -> str:
    """Why ``spec`` has no device path in this port, or '' when it has."""
    cmp = spec.comparator
    if spec.kind == F.CHARS and not isinstance(cmp, C.JaroWinkler):
        return ""
    if spec.kind in (F.HASH, F.NUMERIC):
        return ""
    return (f"property {spec.name!r}: comparator {type(cmp).__name__} "
            f"(feature kind {spec.kind!r}) has no device kernel in the "
            f"PyTorch port yet; only Levenshtein, Exact, Different and "
            f"Numeric score on the device")


def check_plan(plan: F.SchemaFeatures) -> None:
    """Raise ``SchemaError`` naming the first device property whose
    comparator this port cannot score on the device."""
    for spec in plan.device_props:
        why = _unsupported(spec)
        if why:
            raise SchemaError(why)


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


def _property_sim(spec: F.PropertyFeatureSpec, qf: Dict, cf: Dict) -> tuple:
    """Pair similarity for one property: (sim, combo_valid), both flat
    (Q*C*Vq*Vc,)."""
    why = _unsupported(spec)
    if why:
        raise SchemaError(why)
    hh1, hh2 = _pair_expand(qf["hash_hi"], cf["hash_hi"])
    hl1, hl2 = _pair_expand(qf["hash_lo"], cf["hash_lo"])
    v1, v2 = _pair_expand(qf["valid"], cf["valid"])
    combo_valid = v1 & v2
    equal = (hh1 == hh2) & (hl1 == hl2) & combo_valid

    kind = spec.kind
    cmp = spec.comparator
    if kind == F.CHARS and qf["chars"].shape[2] <= ck.MYERS_MAX_CHARS:
        # tiled path: (Q, C) distance tiles from the hand-written kernel,
        # no expanded (Q*C, L) pair operands
        def tile(a, b, eq):
            return ck.levenshtein_sim_tiles(
                qf["chars"][:, a].contiguous(),
                qf["length"][:, a].contiguous(),
                cf["chars"][:, b].contiguous(),
                cf["length"][:, b].contiguous(), eq,
            )

        sim = _tiled_combo_sim(
            tile, qf["valid"].shape[0], cf["valid"].shape[0],
            qf["chars"].shape[1], cf["chars"].shape[1], equal,
        )
    elif kind == F.CHARS:
        # past the kernel's width: the flat scan-DP over expanded pairs
        c1, c2 = _pair_expand(qf["chars"], cf["chars"])
        l1, l2 = _pair_expand(qf["length"], cf["length"])
        sim = pw.levenshtein_sim(c1, l1, c2, l2, equal)
    elif kind == F.HASH:
        sim = (pw.different_sim(equal) if isinstance(cmp, C.Different)
               else pw.exact_sim(equal))
    else:  # F.NUMERIC
        d1, d2 = _pair_expand(qf["number"], cf["number"])
        nv1, nv2 = _pair_expand(qf["number_valid"], cf["number_valid"])
        sim = pw.numeric_sim(d1, nv1, d2, nv2, min_ratio=cmp.min_ratio)
    return sim, combo_valid


def _property_logit(spec: F.PropertyFeatureSpec, qf: Dict, cf: Dict,
                    q: int, c: int) -> torch.Tensor:
    """Per-pair clamped log-odds contribution of one property: (Q, C) f32.

    Duke's map: sim >= 0.5 -> (high-0.5)*sim^2 + 0.5, else -> low; the max
    over value-pair combos is taken in probability space; a property
    missing on either side is neutral (prob 0.5 -> logit 0).  The same f32
    operations in the same order as the JAX program.
    """
    sim, combo_valid = _property_sim(spec, qf, cf)
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
    check_plan(plan)
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


def candidate_mask(cvalid, cdeleted, cgroup, cidx, query_group, query_row,
                   group_filtering: bool):
    """(Q, chunk) candidate-eligibility mask: live non-tombstoned rows only;
    linkage excludes same-group rows; a query never matches its own row."""
    mask = cvalid & ~cdeleted
    if group_filtering:
        mask = mask & (cgroup[None, :] != query_group[:, None])
    return mask & (cidx[None, :] != query_row[:, None])


# -- the blockwise corpus scorer --------------------------------------------


def scan_topk(pair_logits: Callable, qfeats, corpus_feats, corpus_valid,
              corpus_deleted, corpus_group, query_group, query_row,
              min_logit, *, chunk: int, top_k: int, group_filtering: bool):
    """Score Q queries against the corpus chunk by chunk, keeping a running
    top-K (mirrors the JAX ``scan_topk`` with a Python loop over chunks).

    Tie order matches ``lax.top_k``: the merge puts the running top-K
    first and the chunk after it in row order, and a STABLE descending
    sort keeps the lower position first among equal logits (the
    ``NEG_INF`` fill included).  Nothing here waits on the device.
    """
    first = next(iter(qfeats.values()))
    q = first["valid"].shape[0]
    device = corpus_valid.device
    cap = corpus_valid.shape[0]
    # the f32 bound as a Python float (exactly representable, so the f32
    # comparison the JAX program makes is the one made here)
    min_logit = float(np.float32(min_logit))
    top_logit = torch.full((q, top_k), NEG_INF, dtype=torch.float32,
                           device=device)
    top_index = torch.full((q, top_k), -1, dtype=torch.int32, device=device)
    count = torch.zeros((q,), dtype=torch.int64, device=device)
    for start in range(0, cap - cap % chunk, chunk):
        stop = start + chunk
        cf = {
            prop: {name: arr[start:stop] for name, arr in tensors.items()}
            for prop, tensors in corpus_feats.items()
        }
        logits = pair_logits(qfeats, cf)                  # (Q, chunk)
        cidx = torch.arange(start, stop, dtype=torch.int32, device=device)
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
