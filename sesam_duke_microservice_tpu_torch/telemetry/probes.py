"""Black-box canary probing: corpus derivation, probe state, SLI families
(the JAX package's ``telemetry/probes.py`` on torch).

Every other observability layer is white-box -- the process reports on
itself.  The probe plane closes the loop from the OUTSIDE: a
deterministic canary corpus is derived from the workload's own plan
(per-property perturbed record pairs at known edit distances straddling
the thresholds), expected verdicts are computed ONCE via the host f64
oracle (``Processor.compare`` -- the same arbiter the finalize rescore
uses), and a background prober (service.prober) replays the corpus
through the real path every cycle: scheduler admission, scoring,
finalize, the link store, ``?since=`` feed materialization.  Any drift
between the oracle's verdict and what the served feed says is a
correctness incident, not a latency blip.

This module is the engine-free half: namespace contract, corpus
derivation, per-workload probe state (single-writer, scrape-time
snapshots -- the PhaseRecorder discipline) and the ``duke_probe_*``
metric families.  ``service/prober.py`` owns workload lifecycles and
the injection loop; ``range_probe_family`` is the federation's
per-range family (``service/prober.RangeProber``).

Namespace contract: every probe workload and probe dataset id carries
the ``__probe__`` prefix.  Probe workloads are registered ONLY with the
prober -- never in ``DukeApp.deduplications``/``record_linkages`` -- so
no HTTP route can resolve them, and the HTTP layer additionally rejects
the prefix outright (service/app.py).  User-visible feed and link rows
are therefore byte-identical with the prober on or off
(tests/test_torch_probes.py).
"""

from __future__ import annotations

import hashlib
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from .decisions import _MonitorHist, classify
from .env import env_flag, env_float, env_int
from .registry import DEFAULT_LATENCY_BUCKETS, FamilySnapshot

# Reserved namespace prefix for probe workload names AND probe dataset
# ids.  Anything carrying it is invisible to the HTTP surface.
PROBE_PREFIX = "__probe__"

#: Probe cycle stages, in path order: scheduler admission through batch
#: commit; link-journal verdict readback; full ``?since=`` feed walk.
STAGES = ("ingest", "score", "feed")


def probe_name(name: str) -> str:
    return PROBE_PREFIX + name


def is_probe_name(name: str) -> bool:
    return name.startswith(PROBE_PREFIX)


def probes_enabled() -> bool:
    return env_flag("DUKE_PROBE", True)


def probe_interval_s() -> float:
    return env_float("DUKE_PROBE_INTERVAL_S", 30.0)


# -- canary corpus ------------------------------------------------------------

_ALPHA = "abcdefghijklmnopqrstuvwxyz"


def _token(*parts: str) -> str:
    """Deterministic two-word lowercase value for (pair, property, side).

    Letters only, so the standard cleaners (lowercase/trim) are identity
    on it and edit-distance comparators see exactly the intended string.
    Two words matter: perturbations touch only the SECOND word, so the
    first stays an exact index token and the pair remains retrievable by
    token-level blocking (the inverted-index host backend) -- the probe
    certifies the scoring/threshold path at a known edit distance, not
    the recall limits of exact-token candidate search."""
    h = hashlib.sha256("|".join(parts).encode("utf-8")).hexdigest()
    letters = [_ALPHA[int(c, 16) % 26] for c in h[:16]]
    return "".join(letters[:6]) + " " + "".join(letters[6:])


def _perturb_light(value: str) -> str:
    """Edit distance 1: flip the last character (second word)."""
    tail = "a" if value[-1] != "a" else "b"
    return value[:-1] + tail


def _perturb_heavy(value: str) -> str:
    """Rewrite the whole second word -- similarity drops well under the
    0.5 comparator knee, so the property contributes its low
    probability, while the first word keeps the pair retrievable."""
    head, _, tail = value.rpartition(" ")
    flipped = "".join("a" if c != "a" else "b" for c in tail)
    return head + " " + flipped if head else flipped


class Canary:
    """One expected-verdict record pair: column values for both sides
    plus the oracle's verdict.  Entity ids are stamped per cycle by the
    prober (fresh ids each cycle keep ground truth unambiguous)."""

    __slots__ = ("key", "values_a", "values_b", "expected_prob",
                 "expected_verdict")

    def __init__(self, key: str, values_a: Dict[str, str],
                 values_b: Dict[str, str]):
        self.key = key
        self.values_a = values_a
        self.values_b = values_b
        self.expected_prob: Optional[float] = None
        self.expected_verdict: Optional[str] = None


def _columns_by_property(datasource) -> Dict[str, str]:
    """property name -> first mapped column name for one datasource."""
    out: Dict[str, str] = {}
    for col in datasource.config.columns:
        out.setdefault(col.property, col.name)
    return out


def derive_canaries(schema, ds_a, ds_b, compare) -> List[Canary]:
    """Derive the canary corpus from the plan and stamp oracle verdicts.

    ``ds_a``/``ds_b`` are the injection datasources (same one twice for
    dedup; one per group for linkage); ``compare`` is the host f64
    oracle bound to the probe workload's schema.  Pairs: one identical
    pair (expected match), per comparison property a light (edit
    distance 1) and a heavy (half rewritten) perturbation of just that
    property, and one fully disjoint pair (expected reject).  Values
    flow through ``record_for_entity`` -- the real column/cleaner
    mapping -- before the oracle sees them, so expectations track
    exactly what ingest will index.
    """
    cols_a = _columns_by_property(ds_a)
    cols_b = _columns_by_property(ds_b)
    # only properties both sides can express participate in canaries
    props = [p.name for p in schema.comparison_properties()
             if p.name in cols_a and p.name in cols_b]

    def base(pair_key: str, cols: Dict[str, str], side: str) -> Dict[str, str]:
        return {cols[p]: _token(pair_key, p, side) for p in props}

    canaries: List[Canary] = []

    same = {p: _token("identical", p, "ab") for p in props}
    canaries.append(Canary(
        "identical",
        {cols_a[p]: v for p, v in same.items()},
        {cols_b[p]: v for p, v in same.items()},
    ))

    for prop in props:
        for grade, perturb in (("near", _perturb_light),
                               ("far", _perturb_heavy)):
            key = f"{grade}-{prop}"
            shared = {p: _token(key, p, "ab") for p in props}
            va = {cols_a[p]: v for p, v in shared.items()}
            vb = {cols_b[p]: v for p, v in shared.items()}
            vb[cols_b[prop]] = perturb(shared[prop])
            canaries.append(Canary(key, va, vb))

    canaries.append(Canary(
        "disjoint",
        base("disjoint", cols_a, "a"),
        base("disjoint", cols_b, "b"),
    ))

    for canary in canaries:
        ea = dict(canary.values_a)
        ea["_id"] = f"{canary.key}-a"
        eb = dict(canary.values_b)
        eb["_id"] = f"{canary.key}-b"
        ra = ds_a.record_for_entity(ea)
        rb = ds_b.record_for_entity(eb)
        canary.expected_prob = compare(ra, rb)
        canary.expected_verdict = classify(
            canary.expected_prob, schema.threshold, schema.maybe_threshold
        )
    return canaries


# -- per-workload probe state -------------------------------------------------

def _history_limit() -> int:
    return max(1, env_int("DUKE_PROBE_HISTORY", 32))


class ProbeState:
    """Single-writer per-workload probe accounting (the prober's cycle
    thread writes, /metrics and /debug/probes snapshot at read time --
    plain attribute math, no locks on the cycle path)."""

    __slots__ = ("kind", "name", "cycles", "ok_cycles", "corpus_size",
                 "stage_hists", "failures", "mismatches", "probe_compiles",
                 "last_ok_monotonic", "last", "history")

    def __init__(self, kind: str, name: str):
        self.kind = kind
        self.name = name
        self.cycles = 0
        self.ok_cycles = 0
        self.corpus_size = 0
        self.stage_hists: Dict[str, _MonitorHist] = {
            stage: _MonitorHist(DEFAULT_LATENCY_BUCKETS) for stage in STAGES
        }
        self.failures: Dict[str, int] = {}
        self.mismatches = 0
        # nvcc / g++ builds attributed to the probe workload build
        # (telemetry.costs.compile_count): 0, because the kernels and the
        # host library build once per process
        self.probe_compiles = 0
        self.last_ok_monotonic: Optional[float] = None
        self.last: Optional[dict] = None
        self.history: deque = deque(maxlen=_history_limit())

    def note_failure(self, reason: str) -> None:
        self.failures[reason] = self.failures.get(reason, 0) + 1

    def freshness_seconds(self, now: Optional[float] = None) -> Optional[float]:
        if self.last_ok_monotonic is None:
            return None
        if now is None:
            now = time.monotonic()
        return max(0.0, now - self.last_ok_monotonic)

    def snapshot(self) -> dict:
        out = {
            "kind": self.kind,
            "workload": self.name,
            "cycles": self.cycles,
            "ok_cycles": self.ok_cycles,
            "corpus_size": self.corpus_size,
            "failures": dict(self.failures),
            "verdict_mismatches": self.mismatches,
            "probe_compiles": self.probe_compiles,
            "freshness_seconds": self.freshness_seconds(),
            "last": self.last,
            "history": list(self.history),
        }
        return out


# -- metric families ----------------------------------------------------------

def probe_families(states: Sequence[ProbeState],
                   now: Optional[float] = None) -> List[FamilySnapshot]:
    """The four ``duke_probe_*`` families over a snapshot of states."""
    e2e: List[tuple] = []
    fresh: List[tuple] = []
    fails: List[tuple] = []
    mismatches: List[tuple] = []
    for st in states:
        base = (("kind", st.kind), ("workload", st.name))
        for stage in STAGES:
            e2e.extend(st.stage_hists[stage].samples(
                base + (("stage", stage),)))
        age = st.freshness_seconds(now)
        if age is not None:
            fresh.append(("", base, age))
        for reason, n in sorted(st.failures.items()):
            fails.append(("", base + (("reason", reason),), float(n)))
        mismatches.append(("", base, float(st.mismatches)))
    return [
        FamilySnapshot(
            "duke_probe_e2e_seconds", "histogram",
            "Black-box canary latency per cycle stage "
            "(ingest admission→commit, verdict readback, feed walk).",
            e2e,
        ),
        FamilySnapshot(
            "duke_probe_freshness_seconds", "gauge",
            "Seconds since the last fully successful probe cycle.",
            fresh,
        ),
        FamilySnapshot(
            "duke_probe_failures_total", "counter",
            "Probe cycle failures by reason (submit/observe/feed errors, "
            "missing feed rows).",
            fails,
        ),
        FamilySnapshot(
            "duke_probe_verdict_mismatches_total", "counter",
            "Canary pairs whose served verdict diverged from the host "
            "f64 oracle expectation.",
            mismatches,
        ),
    ]


def range_probe_family(checks: Dict[str, Dict[str, int]],
                       groups: Dict[str, int]) -> FamilySnapshot:
    """``duke_probe_range_checks_total{range,group,outcome}`` -- per-range
    reachability probes through the federation router (service.prober.
    RangeProber).  Registered per group so GroupRollup merges the fleet
    view exactly like every other per-group family."""
    samples = []
    for range_id in sorted(checks):
        for outcome in ("ok", "fail"):
            n = checks[range_id].get(outcome, 0)
            samples.append((
                "",
                (("range", range_id),
                 ("group", str(groups.get(range_id, ""))),
                 ("outcome", outcome)),
                float(n),
            ))
    return FamilySnapshot(
        "duke_probe_range_checks_total", "counter",
        "Per-range black-box reachability probes via the federation "
        "router, by outcome.",
        samples,
    )
