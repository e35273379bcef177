"""Plan-level bound math for device-logit pruning (pure Python).

The part of the JAX package's ``ops/scoring.py`` (``:40-220``) that host
finalization needs: the logit transform, the optimistic host-property
bound, the certified float32 margin and the survivor / decisive-prune
bounds derived from them.  Same formulas, same constants, so the port's
pruning decisions equal the reference's on every plan.
"""

from __future__ import annotations

import math

import numpy as np

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
    thresholds = [schema.threshold]
    if schema.maybe_threshold:
        thresholds.append(schema.maybe_threshold)
    return (
        probability_to_logit(min(thresholds))
        - host_bound_logit(plan.host_props)
        - margin
    )


def decisive_prune_logit(schema, plan: "F.SchemaFeatures") -> float:
    """Device-logit bound at or below which a survivor is decisively a
    non-event (even with every host property at its optimistic maximum and
    the certified f32 error credited in its favor), so its host ``compare``
    is skipped."""
    return emit_bound_logit(schema, plan, certified_f32_margin(plan))
