"""Match-decision explainability: per-pair score provenance replay (the
JAX package's ``engine/explain.py`` on torch).

Given two records — by id or raw — replay the full scoring pipeline in
explain mode and return a structured breakdown answering "why did (or
didn't) A link to B":

  * **retrieval provenance** — how the pair would meet: inverted-index
    terms hit with tf/idf contributions (host backend,
    index.inverted.explain_retrieval), embedding cosine + retrieval rank
    + the effective top-C after recall escalation (``ann`` backend) — or
    the exhaustive brute-force bounds (device backend);
  * **host breakdown** — per comparison property: the cleaned values,
    per-value-pair comparator similarities, Duke's probability map, and
    the clamped naive-Bayes logit contribution.  Contributions sum (from
    the 0.5 prior, logit 0) to EXACTLY the pair logit
    ``Processor.compare`` folds — same clamps, same iteration order —
    so ``sigmoid(sum)`` reproduces the emitted probability bit-for-bit;
  * **device verdict** — the per-property float32 logits from
    ``ops.scoring.build_property_logits`` (the explain variant of the
    fast path: the same per-property functions, so on the card the same
    hand kernels at one-pair shapes), the certified f32 margin, the
    survivor-filter and decisive-prune bounds, and which band the pair
    lands in (filtered / pruned / rescored), plus the dd replay's
    ``decided_path``;
  * **link state** — the current link row between the two ids, if any.

Replay is SIDE-EFFECT FREE by construction: nothing here indexes,
emits listener events, or writes links — held by the replay test of
tests/test_torch_explain.py.  ``explain_request`` takes the workload
lock (read-style, 1 s timeout -> busy) for the whole assembly; the
built per-property function is cached per plan.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.bayes import probability_logit
from ..core.records import Record, record_digest
from ..telemetry.decisions import classify, explanation_digest

__all__ = [
    "ExplainBusy",
    "ExplainError",
    "host_breakdown",
    "device_breakdown",
    "retrieval_provenance",
    "explain_pair",
    "explain_request",
    "resolve_records",
]

# value-pair rows listed per property in the breakdown; the BEST pair is
# always reported, this only bounds the exhaustive listing for
# pathological multi-valued records (V x V combos)
_MAX_PAIR_ROWS = 16


class ExplainError(Exception):
    """4xx-shaped client error (unknown id / malformed payload)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class ExplainBusy(Exception):
    """Workload lock unavailable within the read timeout."""


# -- host breakdown -----------------------------------------------------------


def host_breakdown(schema, r1: Record, r2: Record) -> Dict[str, Any]:
    """Per-property provenance of ``Processor.compare(r1, r2)``.

    Mirrors the host engine's fold exactly: per property the max over
    value pairs of ``Property.compare_probability`` (strict ``>`` — the
    first maximum wins, as in the engine), per-property logit via the
    same clamped ``core.bayes.probability_logit``, summed from the 0.5
    prior.  A property with values missing on either side contributes
    nothing (and reports ``status: "missing"``).
    """
    props: List[Dict[str, Any]] = []
    total = 0.0
    for prop in schema.comparison_properties():
        vs1 = [v for v in r1.get_values(prop.name) if v]
        vs2 = [v for v in r2.get_values(prop.name) if v]
        entry: Dict[str, Any] = {
            "name": prop.name,
            "comparator": (type(prop.comparator).__name__
                           if prop.comparator is not None else None),
            "low": prop.low,
            "high": prop.high,
            "values1": vs1,
            "values2": vs2,
        }
        if not vs1 or not vs2:
            entry.update(status="missing", probability=None,
                         best_similarity=None, logit=0.0)
            props.append(entry)
            continue
        best = 0.0
        best_sim: Optional[float] = None
        best_pair: Optional[Tuple[str, str]] = None
        pair_rows: List[Dict[str, Any]] = []
        for v1 in vs1:
            for v2 in vs2:
                p = prop.compare_probability(v1, v2)
                sim = (prop.comparator.compare(v1, v2)
                       if prop.comparator is not None else None)
                if len(pair_rows) < _MAX_PAIR_ROWS:
                    pair_rows.append({
                        "value1": v1, "value2": v2,
                        "similarity": sim, "probability": p,
                    })
                if p > best:
                    best, best_sim, best_pair = p, sim, (v1, v2)
        logit = probability_logit(best)
        total += logit
        entry.update(
            status="compared", probability=best, best_similarity=best_sim,
            best_pair=list(best_pair) if best_pair else None,
            logit=logit, pairs=pair_rows,
        )
        props.append(entry)
    probability = 1.0 / (1.0 + math.exp(-total))
    return {
        "properties": props,
        "pair_logit": total,
        "probability": probability,
    }


# -- device breakdown ---------------------------------------------------------

# built explain functions per plan identity (ops.scoring
# .build_property_logits), in place of the JAX package's jit cache
_SCORER_LOCK = threading.Lock()
_SCORERS: Dict[tuple, Any] = {}
_SCORER_CAP = 32


def _plan_key(plan) -> tuple:
    # id() distinguishes comparator PARAMETER changes (QGram q, numeric
    # min_ratio, ...) that name/kind/low/high/widths would not capture.
    # Sound only because each cache entry holds a strong reference to
    # its plan (and so its comparators): a live entry's comparator can
    # never be garbage-collected, so its id can never be reused by a
    # different-parameter comparator from a config reload.
    return tuple(
        (s.name, s.kind, s.low, s.high, s.v, s.chars, id(s.comparator))
        for s in plan.device_props
    )


def _explain_scorer(plan):
    from ..ops import scoring as S

    key = _plan_key(plan)
    with _SCORER_LOCK:
        entry = _SCORERS.get(key)
        if entry is None:
            # (fn, plan): the plan ref pins the comparators — see
            # _plan_key's id()-soundness note
            entry = (S.build_property_logits(plan), plan)
            if len(_SCORERS) >= _SCORER_CAP:
                _SCORERS.pop(next(iter(_SCORERS)))
            _SCORERS[key] = entry
        return entry[0]


def _frozen_plan(plan):
    """Immutable spec copies: the live plan mutates in place under
    ingest (value-slot growth, demotion), and a replay must never read a
    spec mid-mutation."""
    from dataclasses import replace

    from ..ops import features as F

    return F.SchemaFeatures(
        device_props=[replace(s) for s in plan.device_props],
        host_props=list(plan.host_props),
    )


def _pair_tensors(feats, device):
    """(query, candidate) one-row feature trees on ``device`` from the
    two-row host extraction (row 0 the query, row 1 the candidate)."""
    from .device_matcher import _to_device

    qf = {prop: {name: _to_device(arr[0:1], device, prop)
                 for name, arr in tensors.items()}
          for prop, tensors in feats.items()}
    cf = {prop: {name: _to_device(arr[1:2], device, prop)
                 for name, arr in tensors.items()}
          for prop, tensors in feats.items()}
    return qf, cf


def device_breakdown(index, r1: Record, r2: Record, *,
                     decisive: bool = True,
                     device: bool = True) -> Optional[Dict[str, Any]]:
    """The pair's device-path f32 verdict with per-property provenance.

    Extracts both records under a frozen copy of the CORPUS plan (so
    char truncation / value-slot caps reproduce what device pruning of
    indexed rows actually saw) and runs the un-reduced per-property
    logits on the index's device: on a CUDA device the hand kernels at
    one-pair shapes, on the CPU their plain versions.  Returns None for
    backends without a feature plan (host inverted index).
    """
    from ..ops import bounds as B

    plan = getattr(index, "plan", None)
    if plan is None or not plan.device_props:
        return None
    frozen = _frozen_plan(plan)
    device_names = {s.name for s in frozen.device_props}
    feats = index._extract([r1, r2], plan=frozen)
    # the ANN backend rides its embedding matrix through _extract as a
    # pseudo-property; pair scoring wants only the kernel tensors
    feats = {k: v for k, v in feats.items() if k in device_names}
    qf, cf = _pair_tensors(feats, index.device)
    per_prop = _explain_scorer(frozen)(qf, cf)[0, 0].cpu().numpy()
    device_logit = float(np.asarray(per_prop, dtype=np.float64).sum())
    schema = index.schema
    margin = B.certified_f32_margin(frozen)
    survivor_bound = B.emit_bound_logit(schema, frozen, 1e-3)
    prune = B.emit_bound_logit(schema, frozen, margin)
    if device_logit <= survivor_bound:
        verdict = "filtered"
    elif decisive and device_logit <= prune:
        verdict = "pruned"
    else:
        verdict = "rescored"
    out = {
        "per_property": [
            {"name": spec.name, "logit": float(x)}
            for spec, x in zip(frozen.device_props, per_prop)
        ],
        "host_properties": [p.name for p in frozen.host_props],
        "logit": device_logit,
        "certified_margin": margin,
        "host_bound_logit": B.host_bound_logit(frozen.host_props),
        "survivor_bound": survivor_bound,
        "decisive_prune_logit": prune,
        "decisive_band_enabled": bool(decisive),
        "band_verdict": verdict,
    }
    out.update(_dd_breakdown(index, frozen, feats, r1, r2, verdict,
                             device=device))
    return out


def _dd_breakdown(index, frozen, feats, r1: Record, r2: Record,
                  band_verdict: str, *, device: bool) -> Dict[str, Any]:
    """Certified-finalization provenance: the pair's dd logit, the dd
    margin/bounds, and ``decided_path`` — which finalization path decided
    this pair (``device_certified`` | ``host_rescore`` | ``band_skip``) —
    so an operator can audit why a pair never touched the host.  Replays
    the dd rescore program the live path runs, in its gathered layout at
    Q = K = 1 (on the card: the gathered Myers kernel at K = 1).
    """
    from ..ops import bounds as B
    from ..ops import scoring as S

    schema = index.schema
    if not device:
        return {"decided_path": ("band_skip"
                                 if band_verdict in ("filtered", "pruned")
                                 else "host_rescore"),
                "device_finalize_enabled": False}
    dd_specs = B.dd_plan_specs(frozen)
    fallback = B.dd_fallback_props(schema, frozen)
    out: Dict[str, Any] = {
        "device_finalize_enabled": True,
        "dd_certifiable": [s.name for s in dd_specs],
        "dd_fallback_properties": [p.name for p in fallback],
    }
    if band_verdict in ("filtered", "pruned"):
        out["decided_path"] = "band_skip"
        return out
    if not getattr(getattr(index, "scorer_cache", None), "supports_dd",
                   True):
        # a mesh that spans processes: the live path rescores on the
        # host (its dd survivor gather would be a collective the
        # followers never enter)
        out["decided_path"] = "host_rescore"
        out["dd_residue_reason"] = "backend"
        return out
    if not dd_specs:
        out["decided_path"] = "host_rescore"
        out["dd_residue_reason"] = "kind"
        return out
    from ..engine.finalize import fallback_pair_logit
    from .device_matcher import _VALUE_SLOTS_MAX

    # same value-slot cap as the live dd rescore (device_matcher), so
    # the replayed dd_unsafe/decided_path agrees with what the live
    # finalizer did for value-slot-saturated records
    fn = S.dd_rescorer(frozen, queries_from_rows=False,
                       value_slots_cap=_VALUE_SLOTS_MAX)
    dd_names = {s.name for s in dd_specs}
    qf, cf = _pair_tensors(
        {k: v for k, v in feats.items() if k in dd_names}, index.device)
    device = torch.device(index.device)
    hi, lo, unsafe = fn(qf, cf,
                        torch.full((1,), -1, dtype=torch.int32,
                                   device=device),
                        torch.zeros((1, 1), dtype=torch.int32,
                                    device=device))
    dd_logit = float(np.float64(hi.cpu().numpy()[0, 0])
                     + np.float64(lo.cpu().numpy()[0, 0]))
    total = dd_logit + fallback_pair_logit(fallback, r1, r2)
    dd_margin = B.certified_dd_margin(frozen)
    reject = B.dd_reject_bound(schema, frozen)
    event = B.dd_event_bound(schema, frozen)
    out.update(
        dd_logit=dd_logit,
        certified_dd_margin=dd_margin,
        dd_total_logit=total,
        dd_reject_bound=reject,
        dd_event_bound=event,
        dd_unsafe=bool(unsafe.cpu().numpy()[0, 0]),
    )
    if out["dd_unsafe"]:
        out["decided_path"] = "host_rescore"
        out["dd_residue_reason"] = "truncation"
    elif total <= reject or total >= event:
        # certified verdict: a reject skips the host entirely; a
        # certified event still fetches its bit-exact confidence from
        # one host compare, but the CLASS was decided on device
        out["decided_path"] = "device_certified"
    else:
        out["decided_path"] = "host_rescore"
        out["dd_residue_reason"] = "margin"
    return out


# -- retrieval provenance -----------------------------------------------------


def retrieval_provenance(workload, r1: Record,
                         r2: Record) -> Optional[Dict[str, Any]]:
    """How retrieval would (or would not) surface ``r2`` as a candidate
    for ``r1`` — dispatched to the blocking backend's
    ``explain_retrieval`` (index.inverted / engine.device_matcher /
    engine.ann_matcher)."""
    explain = getattr(workload.index, "explain_retrieval", None)
    if explain is None:
        return None
    gf = bool(getattr(workload.processor, "group_filtering", False))
    try:
        return explain(r1, r2, group_filtering=gf)
    except ValueError as e:
        # group-filtering precondition (missing dukeGroupNo): report
        # instead of failing the whole explanation
        return {"error": str(e)}


# -- request assembly ---------------------------------------------------------


def _resolve_one(workload, payload: Dict[str, Any], n: int) -> Record:
    rid = payload.get(f"id{n}")
    if rid is not None:
        record = workload.index.find_record_by_id(str(rid))
        if record is None:
            raise ExplainError(
                404, f"Unknown record id '{rid}' for workload "
                     f"'{workload.name}'")
        return record
    raw = payload.get(f"record{n}")
    if isinstance(raw, dict):
        dataset = raw.get("dataset")
        entity = raw.get("entity")
        if not isinstance(entity, dict):
            raise ExplainError(
                400, f"record{n} must be "
                     "{\"dataset\": <datasetId>, \"entity\": {...}}")
        datasource = workload.datasources.get(str(dataset))
        if datasource is None:
            raise ExplainError(
                404, f"Unknown dataset-id '{dataset}' for workload "
                     f"'{workload.name}'")
        try:
            return datasource.record_for_entity(entity)
        except Exception as e:
            raise ExplainError(400, f"record{n} conversion failed: {e}")
    raise ExplainError(
        400, f"Provide id{n} (an indexed record id) or record{n} "
             "({\"dataset\": ..., \"entity\": {...}})")


def resolve_records(workload, payload: Dict[str, Any]) -> Tuple[Record, Record]:
    return _resolve_one(workload, payload, 1), _resolve_one(workload, payload, 2)


def _existing_link(workload, id1: str, id2: str) -> Optional[Dict[str, Any]]:
    try:
        for link in workload.link_database.get_all_links_for(id1):
            if {link.id1, link.id2} == {id1, id2}:
                return {
                    "status": link.status.value,
                    "kind": link.kind.value,
                    "confidence": link.confidence,
                    "timestamp": link.timestamp,
                }
    except Exception:
        return None  # closed/raced link DB: omit rather than fail
    return None


def explain_pair(workload, r1: Record, r2: Record) -> Dict[str, Any]:
    """Assemble the full explanation (call with ``workload.lock`` held)."""
    schema = workload.processor.schema
    host = host_breakdown(schema, r1, r2)
    probability = host["probability"]
    outcome = classify(probability, schema.threshold,
                       schema.maybe_threshold)
    finalizer = getattr(workload.processor, "finalizer", None)
    device = device_breakdown(
        workload.index, r1, r2,
        decisive=finalizer.decisive if finalizer is not None else True,
        device=finalizer.device if finalizer is not None else True,
    )
    out: Dict[str, Any] = {
        "workload": workload.name,
        "kind": workload.kind,
        "id1": r1.record_id,
        "id2": r2.record_id,
        "thresholds": {
            "threshold": schema.threshold,
            "maybe_threshold": schema.maybe_threshold,
        },
        "retrieval": retrieval_provenance(workload, r1, r2),
        "properties": host["properties"],
        "pair_logit": host["pair_logit"],
        "probability": probability,
        "classification": outcome,
        "link": _existing_link(workload, r1.record_id, r2.record_id),
        "explanation_digest": explanation_digest(
            record_digest(r1), record_digest(r2), probability),
    }
    if device is not None:
        out["device"] = device
    return out


def explain_request(workload, payload: Dict[str, Any], *,
                    lock_timeout: float = 1.0) -> Dict[str, Any]:
    """``POST /explain`` entry: lock (read-timeout semantics, matching
    the feed endpoints), resolve the two records, assemble the
    explanation.  Raises ``ExplainBusy`` on lock timeout and
    ``ExplainError`` for client errors."""
    if not isinstance(payload, dict):
        raise ExplainError(400, "Request body must be a JSON object")
    if not workload.lock.acquire(timeout=lock_timeout):
        raise ExplainBusy()
    try:
        if workload.closed:
            raise ExplainBusy()
        r1, r2 = resolve_records(workload, payload)
        return explain_pair(workload, r1, r2)
    finally:
        workload.lock.release()
