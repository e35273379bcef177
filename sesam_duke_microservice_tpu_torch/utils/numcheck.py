"""Runtime certified-numerics sanitizer (``DUKE_NUMCHECK=1``; the runtime
half of the JAX package's ``utils/numcheck.py`` on torch -- its static
checkers cover the JAX package only).

The dynamic leg that validates the whole composed certified chain (the
dd survivor rescore, ``ops.scoring.dd_rescorer``, and the certified
finalization, ``engine.finalize``) on *live traffic*:

  * every **certified event** is shadow-checked for free (the finalize
    path already paid the host ``compare`` for its bit-exact
    confidence): the oracle must actually emit an event, and the dd
    total logit must sit within the certified margin of the oracle's;
  * a sampled fraction (``DUKE_NUMCHECK_SAMPLE``, default 1.0 -- check
    everything; production can dial it down) of **certified rejects**
    pays one extra shadow ``compare``: the oracle must NOT emit, and the
    margin bound must hold.

Any certified-vs-oracle class disagreement or margin-bound violation is
recorded in ``violations()`` and every check tail-latches into a
:class:`telemetry.rings.LatchedRing` (violations are latched, so they
survive any sample rate and any ring pressure).  The port's tests gate
per test: tests/test_torch_numcheck.py resets before each test and
asserts an empty list after it.

The margin-bound check reconstructs the oracle's total logit from its
returned probability (``compare`` is ``sigmoid(sum of clamped
per-property logits)`` -- core.bayes), which is only well-conditioned in
the interior: at |logit| = L the reconstruction loses ~``e^L * u64``,
which crosses the ~1e-10 dd margins near L = 14.  Checks outside
``|logit| <= 10`` therefore validate the CLASS only -- precisely the
regime where classes are decided by enormous slack anyway.

Thread model: finalize workers call ``observe`` concurrently.  The
violations list is append-only (GIL-atomic), the ring carries its own
lock, and the sampling counter rides ``itertools.count`` (atomic
``__next__``).
"""

from __future__ import annotations

import itertools
import logging
import math
from typing import List, Optional

from ..env import env_flag, env_float
from ..telemetry.rings import LatchedRing

logger = logging.getLogger("numcheck")

# interior band for the margin-bound leg (see module docstring) and the
# reconstruction allowance inside it (e^10 * u64 * small-constant slack)
_MARGIN_CHECK_LOGIT = 10.0
_RECON_SLACK = 1e-11

_RING_CAPACITY = 256

_counter = itertools.count()
_checked = itertools.count()  # per-observation ring keys
_observed = 0                 # lifetime observations (approximate stat)
_violations: List[str] = []   # append-only; GIL-atomic
_ring = LatchedRing(_RING_CAPACITY)


def enabled() -> bool:
    return env_flag("DUKE_NUMCHECK", False)


def sample_fraction() -> float:
    frac = env_float("DUKE_NUMCHECK_SAMPLE", 1.0)
    return min(max(frac, 0.0), 1.0)


def take_sample(frac: Optional[float] = None) -> bool:
    """Deterministic counter-stride sampling -- no RNG on the hot path."""
    if frac is None:
        frac = sample_fraction()
    if frac <= 0.0:
        return False
    n = next(_counter)
    return math.floor((n + 1) * frac) > math.floor(n * frac)


def _logit(p: float) -> float:
    eps = 1e-10
    p = min(max(p, eps), 1.0 - eps)
    return math.log(p / (1.0 - p))


def _record(kind: str, id1: str, id2: str, total: float, prob: float,
            verdict: Optional[str]) -> None:
    global _observed
    _observed += 1  # approximate under races -- a stat, not a gate
    key = f"{next(_checked)}:{id1}:{id2}"
    _ring.put(key, {
        "kind": kind, "id1": id1, "id2": id2,
        "dd_total_logit": total, "oracle_probability": prob,
        "violation": verdict,
    }, remarkable=verdict is not None, nbytes=0)
    if verdict is not None:
        line = (f"{verdict} [{kind}] pair ({id1}, {id2}): "
                f"dd_total={total!r} oracle_p={prob!r}")
        _violations.append(line)
        logger.error("numcheck: %s", line)


def _emits(prob: float, threshold: float,
           maybe: Optional[float]) -> bool:
    if prob > threshold:
        return True
    return maybe is not None and maybe != 0.0 and prob > maybe


def observe(kind: str, id1: str, id2: str, total: float, prob: float,
            threshold: float, maybe: Optional[float],
            margin: float) -> None:
    """Validate one certified verdict against the oracle's probability.

    ``kind`` is ``"reject"`` (certified no-event; ``prob`` came from the
    shadow compare) or ``"event"`` (certified event; ``prob`` is the
    confidence the finalize path fetched anyway).  ``total`` is the dd
    device logit plus the exact host-fallback logits -- the quantity the
    certification bounds classified; ``margin`` is the certified dd
    margin plus threshold slack the bounds charged.
    """
    verdict = None
    emits = _emits(prob, threshold, maybe)
    if kind == "reject" and emits:
        verdict = ("CERTIFIED-REJECT DISAGREEMENT: oracle emits an "
                   "event the device certified impossible")
    elif kind == "event" and not emits:
        verdict = ("CERTIFIED-EVENT DISAGREEMENT: oracle emits nothing "
                   "for a device-certified event")
    else:
        oracle_logit = _logit(prob)
        if (abs(total) <= _MARGIN_CHECK_LOGIT
                and abs(oracle_logit) <= _MARGIN_CHECK_LOGIT
                and abs(total - oracle_logit) > margin + _RECON_SLACK):
            verdict = (f"MARGIN-BOUND VIOLATION: |dd - oracle| = "
                       f"{abs(total - oracle_logit):.3e} > certified "
                       f"{margin:.3e}")
    _record(kind, id1, id2, total, prob, verdict)


def violations() -> List[str]:
    return list(_violations)


def report() -> dict:
    return {
        "enabled": enabled(),
        "checked": _observed,
        "violations": list(_violations),
        "ring_entries": len(_ring),
        "recent": _ring.records(),
    }


def reset() -> None:
    """Test hook: clear recorded state (the injection tests must not
    leak their deliberate violations into the session gate)."""
    global _counter, _checked, _ring, _observed
    _violations.clear()
    _observed = 0
    _counter = itertools.count()
    _checked = itertools.count()
    _ring = LatchedRing(_RING_CAPACITY)
