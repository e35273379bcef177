"""Host finalization of device-scored survivor pairs.

Counterpart of the JAX package's ``engine/finalize.py``:

  * **Parallel**: per-query survivor finalization fans out over a worker
    pool sized by ``DUKE_FINALIZE_THREADS`` (else the processor's
    ``threads``).  Workers only compute the exact f64 ``compare`` per
    survivor and the would-be events; the caller emits listener events in
    strict query order, so streams are identical at any thread count.
  * **Skippable** (decisive-band pruning, ``DUKE_DECISIVE_BAND``): a
    survivor whose optimistic device logit, with the certified f32 margin
    credited in its favor, still cannot reach ``min(threshold,
    maybe_threshold)`` emits no event, so its host ``compare`` is skipped.
  * **Device-certified** (``DUKE_DEVICE_FINALIZE``, default on; ``=0``
    pins the host path exactly): the caller attaches the block's dd
    rescore (``ops.scoring.build_dd_rescorer``) to the result, and each
    survivor falls in one of three classes --

      - **certified reject**: the dd logit plus the exact host logits of
        the uncertifiable properties sits below every threshold by more
        than ``certified_dd_margin``; no compare runs;
      - **certified event**: provably above the lowest threshold; the
        pair takes one host compare for its bit-exact f64 confidence,
        through a comparison-signature memo (``compare`` is a pure
        function of the comparison properties' value lists, so a
        duplicate group costs one compare);
      - **residue**: inside the dd band (reason "margin"), no certifiable
        property (reason "kind"), or tensors that may have truncated the
        record (reason "truncation"): the host path.

    Events emit from the caller in query order through the same path, so
    streams and link rows are bit-identical to ``DUKE_DEVICE_FINALIZE=0``;
    the only difference is the compares that provably emit nothing.  The
    memos take no lock: dict get / set are atomic under the GIL and the
    over-capacity reset rebinds a fresh dict.
  * **Shadow-checked** (``DUKE_NUMCHECK=1``, ``utils.numcheck``): every
    certified event's compare doubles as an oracle check of its class
    and margin, and a sampled share of the certified rejects pays one
    shadow compare each.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

from ..core.bayes import probability_logit
from ..core.records import Record, record_digest
from ..env import env_flag, env_str
from ..ops import bounds as B
from ..telemetry.decisions import PairDecision
from ..utils import numcheck


def fallback_pair_logit(props, r1: Record, r2: Record) -> float:
    """Exact f64 logit contribution of the host-fallback properties: the
    per-property fold ``Processor.compare`` performs (max over value pairs
    of ``compare_probability``, clamped logit, missing sides contribute
    nothing), restricted to ``props`` (``ops.bounds.dd_fallback_props``)."""
    total = 0.0
    for prop in props:
        vs1 = [v for v in r1.get_values(prop.name) if v]
        vs2 = [v for v in r2.get_values(prop.name) if v]
        if not vs1 or not vs2:
            continue
        best = 0.0
        for v1 in vs1:
            for v2 in vs2:
                p = prop.compare_probability(v1, v2)
                if p > best:
                    best = p
        total += probability_logit(best)
    return total


class QueryOutcome:
    """One query's finalization result: ``events`` holds
    ``(event_name, candidate, probability)`` in survivor (descending device
    logit) order; an empty list means ``no_match_for``.  The counters feed
    ``ProfileStats``.  ``decisions`` carries the per-pair decision inputs
    (``telemetry.decisions.PairDecision``, survivor order) for the
    decision recorder -- empty when recording is off; ``prune`` /
    ``margin`` / ``host_bound`` are the block's decisive bound, certified
    f32 margin and optimistic host-property logit (None / 0 without a
    decisive band)."""

    __slots__ = ("events", "survivors", "rescored", "skipped",
                 "decisions", "prune", "margin", "host_bound",
                 "device_certified", "residue_margin", "residue_kind",
                 "residue_truncation")

    def __init__(self, events: List[Tuple[str, Record, float]],
                 survivors: int, rescored: int, skipped: int,
                 decisions: Optional[list] = None,
                 prune: Optional[float] = None,
                 margin: Optional[float] = None,
                 host_bound: float = 0.0,
                 device_certified: int = 0, residue_margin: int = 0,
                 residue_kind: int = 0, residue_truncation: int = 0):
        self.events = events
        self.survivors = survivors
        self.rescored = rescored
        self.skipped = skipped
        self.decisions = decisions if decisions is not None else []
        self.prune = prune
        self.margin = margin
        self.host_bound = host_bound
        self.device_certified = device_certified
        self.residue_margin = residue_margin
        self.residue_kind = residue_kind
        self.residue_truncation = residue_truncation


def _resolve_threads(threads: int) -> int:
    env = env_str("DUKE_FINALIZE_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            logging.getLogger("finalize").warning(
                "ignoring non-integer DUKE_FINALIZE_THREADS=%r", env)
    return max(1, threads)


# Confidence-memo capacity; both memos reset wholesale when full.
_CONF_CACHE_MAX = 1 << 16


class FinalizeExecutor:
    """Block-scoped survivor-finalization executor (one per processor; the
    pool is created on the first multi-threaded block and reused)."""

    def __init__(self, threads: int = 1):
        self.threads = _resolve_threads(threads)
        self.decisive = env_flag("DUKE_DECISIVE_BAND", True)
        self.device = env_flag("DUKE_DEVICE_FINALIZE", True)
        # once per workload: which properties force the per-pair host path
        self._kind_fallback_logged = False
        # (query sig, candidate sig) -> compare's f64 result, and record
        # digest -> sig (the tuple of its comparison-property value lists)
        self._conf_cache: dict = {}
        self._sig_cache: dict = {}
        self._pool: Optional[ThreadPoolExecutor] = None

    def shutdown(self) -> None:
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def _log_fallback(self, schema, plan, plan_has_dd: bool) -> None:
        self._kind_fallback_logged = True
        forced = (B.dd_fallback_props(schema, plan) if plan_has_dd
                  else list(schema.comparison_properties()))
        if forced:
            logging.getLogger("finalize").info(
                "device finalize: %s fall back to per-pair host scoring (no "
                "certified dd kernel for their comparator kinds)%s",
                sorted(p.name for p in forced),
                "" if plan_has_dd else
                " -- no property is dd-certifiable, every survivor takes "
                "the host path")

    def finalize_block(self, proc, block: Sequence[Record],
                       result) -> List[QueryOutcome]:
        """Every query's outcome for one scored block, in query order.

        ``proc`` is the owning DeviceProcessor (``compare``, the record
        mirror, thresholds); ``result`` is the resolved ``_BlockResult``,
        whose ``dd`` holds the block's (hi, lo, unsafe) dd rescore or None.
        """
        database = proc.database
        plan = database.plan
        schema = proc.schema
        row_ids = database.corpus.row_ids
        resolver = database.records.get
        threshold = schema.threshold
        maybe = schema.maybe_threshold
        # recomputed per block: long-text demotion can move a property to
        # the host side between batches, and the bounds must track it
        prune = (B.decisive_prune_logit(schema, plan)
                 if self.decisive else None)
        # decision-recorder inputs: the certified margin classifies
        # near-threshold band skips, the host bound turns a device logit
        # into the f32 filter verdict.  Host arithmetic on the plan only
        # (no device read), and only while the processor's recorder is on
        recorder = getattr(proc, "decisions", None)
        record_decisions = recorder is not None and recorder.enabled
        margin = (B.certified_f32_margin(plan)
                  if record_decisions and prune is not None else None)
        host_bound = (B.host_bound_logit(plan.host_props)
                      if record_decisions else 0.0)
        compare = proc.compare
        dd = getattr(result, "dd", None) if self.device else None
        plan_has_dd = self.device and bool(B.dd_plan_specs(plan))
        dd_reject = dd_event = None
        fallback: List = []
        nc_margin = None  # DUKE_NUMCHECK: the bound certified verdicts charge
        if dd is not None and plan_has_dd:
            dd_reject = B.dd_reject_bound(schema, plan)
            dd_event = B.dd_event_bound(schema, plan)
            fallback = B.dd_fallback_props(schema, plan)
            if numcheck.enabled():
                # the dd margin plus the probability-space comparison
                # slack
                t_min = threshold
                if maybe is not None and maybe != 0.0:
                    t_min = min(t_min, maybe)
                nc_margin = (B.certified_dd_margin(plan)
                             + B._dd_threshold_slack(t_min))
        if self.device and not self._kind_fallback_logged:
            self._log_fallback(schema, plan, plan_has_dd)
        comparison_props = list(schema.comparison_properties())

        def sig(rec: Record):
            """The value tuple ``compare`` is a pure function of, memoized
            per distinct record content."""
            d = record_digest(rec)
            s = self._sig_cache.get(d)
            if s is None:
                s = tuple(tuple(rec.get_values(p.name))
                          for p in comparison_props)
                sc = self._sig_cache
                if len(sc) >= _CONF_CACHE_MAX:
                    sc = self._sig_cache = {}
                sc[d] = s
            return s

        def one(qi: int, record: Record) -> QueryOutcome:
            events: List[Tuple[str, Record, float]] = []
            survivors = result.survivor_triples(qi)
            rescored = skipped = certified = 0
            res_margin = res_kind = res_trunc = 0
            decisions: List[PairDecision] = []
            rec_id = record.record_id
            query_sig = None  # built lazily, once per query

            def memo_compare(cand: Record) -> float:
                # ordered key: PersonName-style greedy token matching is
                # not provably symmetric.  Shared by the certified-event
                # confidence fetch and the numcheck shadow oracle, so the
                # sanitizer's certified-reject checks stay O(distinct
                # content pairs)
                nonlocal query_sig
                if query_sig is None:
                    query_sig = sig(record)
                ckey = (query_sig, sig(cand))
                cache = self._conf_cache
                p = cache.get(ckey)
                if p is None:
                    p = compare(record, cand)
                    if len(cache) >= _CONF_CACHE_MAX:
                        cache = self._conf_cache = {}
                    cache[ckey] = p
                return p

            for pos, row, device_logit in survivors:
                rid = row_ids[row]
                if rid is None or rid == rec_id:
                    continue
                if prune is not None and device_logit <= prune:
                    skipped += 1
                    if record_decisions:
                        decisions.append(
                            PairDecision(rid, device_logit, True, None))
                    continue
                candidate = None
                reason = None  # why this pair takes the host compare
                dd_total = None  # certified total (numcheck shadow leg)
                certified_event = False
                if dd_reject is not None:
                    if dd[2][qi, pos]:
                        reason = "truncation"
                    else:
                        # an f32 pair sums exactly in f64
                        total = float(dd[0][qi, pos]) + float(dd[1][qi, pos])
                        if fallback:
                            candidate = resolver(rid)
                            if candidate is None:
                                continue
                            total += fallback_pair_logit(
                                fallback, record, candidate)
                        if total <= dd_reject:
                            certified += 1
                            if record_decisions:
                                decisions.append(PairDecision(
                                    rid, device_logit, True, None,
                                    path="device_certified"))
                            if nc_margin is not None \
                                    and numcheck.take_sample():
                                # DUKE_NUMCHECK shadow oracle: the one
                                # verdict class that skips the host
                                # compare pays one back, sampled (and
                                # memoized)
                                shadow = (candidate if candidate
                                          is not None else resolver(rid))
                                if shadow is not None:
                                    numcheck.observe(
                                        "reject", rec_id, rid, total,
                                        memo_compare(shadow),
                                        threshold, maybe, nc_margin)
                            continue
                        if total < dd_event:
                            reason = "margin"
                        else:
                            # certified event: the class is certain, the
                            # emitted confidence is still the exact f64
                            # compare's
                            dd_total = total
                            certified_event = True
                elif self.device and not plan_has_dd:
                    reason = "kind"
                if candidate is None:
                    candidate = resolver(rid)
                    if candidate is None:
                        continue
                if self.device:
                    prob = memo_compare(candidate)
                else:
                    prob = compare(record, candidate)
                if certified_event and nc_margin is not None:
                    # free shadow check: the compare already ran for the
                    # bit-exact confidence -- the oracle must agree an
                    # event emits, and the margin bound must hold
                    numcheck.observe("event", rec_id, rid, dd_total,
                                     prob, threshold, maybe, nc_margin)
                rescored += 1
                if reason == "margin":
                    res_margin += 1
                elif reason == "kind":
                    res_kind += 1
                elif reason == "truncation":
                    res_trunc += 1
                if record_decisions:
                    decisions.append(
                        PairDecision(rid, device_logit, False, prob))
                if prob > threshold:
                    events.append(("matches", candidate, prob))
                elif maybe is not None and maybe != 0.0 and prob > maybe:
                    events.append(("matches_perhaps", candidate, prob))
            return QueryOutcome(events, len(survivors), rescored, skipped,
                                decisions, prune, margin, host_bound,
                                certified, res_margin, res_kind, res_trunc)

        if self.threads <= 1 or len(block) <= 1:
            return [one(qi, r) for qi, r in enumerate(block)]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.threads,
                                            thread_name_prefix="finalize")
        # map() preserves submission order: outcomes line up with the block
        return list(self._pool.map(one, range(len(block)), block))
