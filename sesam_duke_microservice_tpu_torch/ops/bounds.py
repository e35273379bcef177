"""Plan-level bound math for device-logit pruning and certification.

The part of the JAX package's ``ops/scoring.py`` (``:40-408``) that host
finalization needs: the logit transform, the optimistic host-property
bound, the certified float32 margin and the survivor / decisive-prune
bounds derived from them, and the double-double half -- which properties
the dd rescorer certifies, its margin, and the reject / event / gate
bounds of the three-way verdict split.  Same formulas, same constants, so
the port's pruning and certification decisions equal the reference's on
every plan.
"""

from __future__ import annotations

import math

import numpy as np

from ..core import comparators as C
from . import dd as D
from . import features as F

# Sentinel for empty top-K slots (logit scale).
NEG_INF = -3.0e38

# Matches core.bayes._EPS: probabilities clamped away from {0, 1}.
_EPS = 1e-10
_MAX_LOGIT = math.log((1.0 - _EPS) / _EPS)

_F32_EPS = float(np.finfo(np.float32).eps)


def probability_to_logit(p: float) -> float:
    p = min(max(p, _EPS), 1.0 - _EPS)
    return math.log(p / (1.0 - p))


def host_bound_logit(host_props) -> float:
    """Optimistic total logit the host-scored properties could contribute."""
    return sum(max(0.0, probability_to_logit(p.high)) for p in host_props)


# Per-kind absolute similarity-error bounds for the certified margin:
# edit-distance / set / hash / phonetic sims are ratios of exact integer
# counts with one final f32 division (64 ulps is generous); weighted
# Levenshtein accumulates up to ~256 f32 weight additions and numeric is a
# ratio of f32-quantized doubles, so both get wider budgets.  Geoposition
# is not certifiable (f32 lat/lon quantization alone is meters of error),
# which collapses the whole-schema margin to "rescore everything".
_SIM_ERROR_BOUND = {
    F.CHARS: 64.0 * _F32_EPS,
    F.GRAM_SET: 64.0 * _F32_EPS,
    F.TOKEN_SET: 64.0 * _F32_EPS,
    F.HASH: 64.0 * _F32_EPS,
    F.PHONETIC: 64.0 * _F32_EPS,
    F.CHARS_WEIGHTED: 2048.0 * _F32_EPS,
    F.NUMERIC: 256.0 * _F32_EPS,
    F.GEO: float("inf"),
}


def certified_f32_margin(plan: "F.SchemaFeatures") -> float:
    """Certified upper bound on |device f32 logit - exact f64 logit|.

    Per device property: the kind's similarity-error budget amplified by
    the worst-case slope of the probability -> log-odds composition
    (``1/min(high(1-high), low(1-low))``, capped at the clamp range), plus
    32 ulps of log-odds rounding; the sum of ``n`` clamped terms adds
    ``n * ulp(n * _MAX_LOGIT)`` of accumulation error.  Mirrors the JAX
    package's ``certified_f32_margin``.
    """
    n = max(1, len(plan.device_props))
    total = n * _F32_EPS * (n * _MAX_LOGIT)  # accumulation of the sum
    for spec in plan.device_props:
        high = min(max(float(spec.high), _EPS), 1.0 - _EPS)
        low = min(max(float(spec.low), _EPS), 1.0 - _EPS)
        amplification = 1.0 / min(high * (1.0 - high), low * (1.0 - low))
        sim_err = _SIM_ERROR_BOUND.get(spec.kind, float("inf"))
        total += min(sim_err * amplification, 2.0 * _MAX_LOGIT)
        total += 32.0 * _F32_EPS * _MAX_LOGIT      # log-odds rounding
    return total


def emit_bound_logit(schema, plan: "F.SchemaFeatures",
                     margin: float) -> float:
    """The device logit below which a pair cannot emit an event at error
    ``margin``: ``logit(min(threshold, maybe_threshold))`` minus the
    optimistic host-property contribution minus ``margin``.  The survivor
    filter and decisive-band pruning both derive from this one formula."""
    return (
        probability_to_logit(_min_threshold(schema))
        - host_bound_logit(plan.host_props)
        - margin
    )


def _min_threshold(schema) -> float:
    """``min(threshold, maybe_threshold)``: the lowest emitting probability."""
    thresholds = [schema.threshold]
    if schema.maybe_threshold:
        thresholds.append(schema.maybe_threshold)
    return min(thresholds)


def decisive_prune_logit(schema, plan: "F.SchemaFeatures") -> float:
    """Device-logit bound at or below which a survivor is decisively a
    non-event (even with every host property at its optimistic maximum and
    the certified f32 error credited in its favor), so its host ``compare``
    is skipped."""
    return emit_bound_logit(schema, plan, certified_f32_margin(plan))


# -- certified double-double finalization -------------------------------------
#
# The dd rescorer (ops.scoring.build_dd_rescorer) redoes the surviving
# pairs' ratio -> probability map -> clamped logit in two-float arithmetic
# from the exact integer counts the comparators reduce to.  Its logit is
# within ``certified_dd_margin`` of the host's f64 value, so a verdict
# farther than that from every threshold is certified.  Branch soundness
# (the JAX package's ops/scoring.py:198-219): single-division kinds rest
# on rational spacing, Jaro-Winkler on a runtime guard band that flags
# near-boundary pairs into the host residue.

# Feature kinds whose device counts are exact integers: the certified dd
# family.  The rest fall back to the host per property.
DD_KINDS = (F.CHARS, F.GRAM_SET, F.TOKEN_SET, F.HASH, F.PHONETIC)
DD_FALLBACK_KINDS = (F.CHARS_WEIGHTED, F.NUMERIC, F.GEO)

# Past this width the rational spacing of Jaro-Winkler's branch constants
# thins below 1e-7, so wider JW properties fall back to the host.
_DD_JW_MAX_CHARS = 64

# dd similarity-error budgets, in units of DD_EPS: ratio kinds pay one dd
# division plus the map; JW pays three divisions, the 3-term average, the
# prefix boost and the map; hash / phonetic reproduce oracle constants.
_DD_SIM_OPS = {
    F.CHARS: 64.0,
    F.GRAM_SET: 64.0,
    F.TOKEN_SET: 64.0,
    F.HASH: 16.0,
    F.PHONETIC: 16.0,
}
_DD_JW_SIM_OPS = 256.0


def dd_certifiable_spec(spec: "F.PropertyFeatureSpec") -> bool:
    """Can this device property's verdict ride the certified dd rescore?
    Kind must be in the integer-count-ratio family; Jaro-Winkler also
    caps the char width."""
    if spec.kind not in DD_KINDS:
        return False
    if spec.kind == F.CHARS and isinstance(spec.comparator, C.JaroWinkler):
        return spec.chars <= _DD_JW_MAX_CHARS
    return True


def dd_plan_specs(plan: "F.SchemaFeatures"):
    """The dd-certifiable subset of the plan's device properties."""
    return [s for s in plan.device_props if dd_certifiable_spec(s)]


def dd_fallback_props(schema, plan: "F.SchemaFeatures"):
    """Properties the device-finalize path evaluates on the host PER PAIR:
    the host-only properties plus device properties of uncertifiable
    kinds, as core Property objects in schema order."""
    dd_names = {s.name for s in dd_plan_specs(plan)}
    return [p for p in schema.comparison_properties()
            if p.name not in dd_names]


def certified_dd_margin(plan: "F.SchemaFeatures") -> float:
    """Certified bound on |dd device logit - host f64 logit| over the
    dd-certifiable properties: per property, the kind's dd similarity
    budget amplified by the probability -> log-odds slope, plus the dd
    log's budget; plus an f64 accumulation-order term over all
    properties.  Mirrors the JAX package's ``certified_dd_margin``."""
    specs = dd_plan_specs(plan)
    n_all = max(1, len(plan.device_props) + len(plan.host_props))
    total = n_all * D.DD_EPS * (n_all * _MAX_LOGIT)
    for spec in specs:
        high = min(max(float(spec.high), _EPS), 1.0 - _EPS)
        low = min(max(float(spec.low), _EPS), 1.0 - _EPS)
        amplification = 1.0 / min(high * (1.0 - high), low * (1.0 - low))
        if spec.kind == F.CHARS and isinstance(spec.comparator,
                                               C.JaroWinkler):
            sim_err = _DD_JW_SIM_OPS * D.DD_EPS
        else:
            sim_err = _DD_SIM_OPS[spec.kind] * D.DD_EPS
        total += min(sim_err * amplification, 2.0 * _MAX_LOGIT)
        total += 2.0 * (D.LOG_ERR_ABS + D.DD_EPS * _MAX_LOGIT)
    return total


def _dd_threshold_slack(threshold: float) -> float:
    """Logit-space slack covering the host's probability-space compare
    (the sigmoid's f64 rounding amplified by the logit slope at the
    threshold, plus the rounding of ``logit(t)``)."""
    t = min(max(float(threshold), _EPS), 1.0 - _EPS)
    u64 = 2.0 ** -53
    return 64.0 * u64 * (1.0 / (t * (1.0 - t))) + 64.0 * u64 * _MAX_LOGIT


def dd_reject_bound(schema, plan: "F.SchemaFeatures") -> float:
    """Total-logit bound at or below which a survivor is a certified
    reject: its host f64 probability provably clears no threshold."""
    t = _min_threshold(schema)
    return (probability_to_logit(t) - certified_dd_margin(plan)
            - _dd_threshold_slack(t))


def dd_gate_bound(schema, plan: "F.SchemaFeatures") -> float:
    """f32-device-logit bound above which a survivor certifiably cannot
    be a dd certified reject: a block with no survivor at or below it
    skips the dd rescore program.  Host-only properties contribute at
    least ``sum(min(0, logit(min(low, 0.5))))``."""
    lmin = 0.0
    for p in plan.host_props:
        lmin += min(0.0, probability_to_logit(min(float(p.low), 0.5)))
    return (dd_reject_bound(schema, plan) + certified_f32_margin(plan)
            - lmin)


def dd_event_bound(schema, plan: "F.SchemaFeatures") -> float:
    """Total-logit bound at or above which a survivor certifiably emits
    an event (it still takes one host compare for its exact f64
    confidence)."""
    t = _min_threshold(schema)
    return (probability_to_logit(t) + certified_dd_margin(plan)
            + _dd_threshold_slack(t))
