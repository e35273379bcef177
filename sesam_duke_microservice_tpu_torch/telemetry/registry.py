"""Dependency-free metrics registry with Prometheus text exposition.

A copy of the JAX package's ``telemetry/registry.py``: ``Counter`` /
``Gauge`` / ``Histogram`` families with labels, rendered in the Prometheus
text format (0.0.4) by ``render``.  Nothing here imports torch or anything
else from this package -- the registry must be importable from every layer
(service, engine, links, utils) without cycles and must work in processes
that never touch a device.

Concurrency model (mirrors the codebase's existing /stats stance,
engine/device_matcher.py live_records):

  * Children created with the default ``locked=True`` take a per-child
    lock around updates — correct for multi-writer sites like the HTTP
    handler threads, where the nanosecond lock is nowhere near a device
    hot path.
  * Children created with ``locked=False`` update plain attributes with
    no lock at all.  That is the ENGINE contract: scoring-path
    instruments are written by exactly one thread at a time (the
    workload lock already serializes batches), so unlocked updates are
    exact there, and the scoring path acquires no locks for metrics.
    Scrapes read these fields lock-free and tolerate a torn multi-field
    read, exactly like the existing lock-free /stats counters.
  * Child creation (``labels()``) locks the family; steady state is a
    plain dict hit.

Histogram buckets default to a fixed log-scale latency ladder
(100 µs .. 2 min) so every latency family shares one bucket layout and
recording stays O(#buckets) with zero allocation.
"""

from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

# ~log-scale (1 / 2.5 / 5 per decade) from 100 microseconds to 2 minutes:
# wide enough for pair-scoring microbatches and for multi-second
# first-contact XLA compiles on the same ladder.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class _NullLock:
    """No-op context manager for single-writer (engine-side) children."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_LOCK = _NullLock()


def _fmt(value: float) -> str:
    """Prometheus sample value: integers without the trailing .0 noise."""
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if value != value:  # NaN
        return "NaN"
    as_int = int(value)
    return str(as_int) if as_int == value else repr(value)


def escape_label_value(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_labels(labels: Sequence[Tuple[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in labels
    )
    return "{" + inner + "}"


class FamilySnapshot:
    """One family's scrape-time state: metadata + flat samples.

    ``samples`` rows are ``(name_suffix, labels, value)`` where
    ``name_suffix`` is appended to the family name (histograms emit
    ``_bucket`` / ``_sum`` / ``_count``) and ``labels`` is an ordered
    (key, value) tuple sequence.
    """

    __slots__ = ("name", "mtype", "help", "samples")

    def __init__(self, name: str, mtype: str, help: str,
                 samples: List[Tuple[str, Tuple[Tuple[str, str], ...], float]]):
        self.name = name
        self.mtype = mtype
        self.help = help
        self.samples = samples


class _Child:
    __slots__ = ("_lock",)

    def __init__(self, locked: bool):
        self._lock = threading.Lock() if locked else _NULL_LOCK


class CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, locked: bool):
        super().__init__(locked)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class GaugeChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, locked: bool):
        super().__init__(locked)
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        return self._value


class HistogramChild(_Child):
    __slots__ = ("_bounds", "_counts", "_sum", "_count")

    def __init__(self, locked: bool, bounds: Tuple[float, ...]):
        super().__init__(locked)
        self._bounds = bounds
        # per-bucket (NON-cumulative) counts; +Inf bucket is the last slot
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        i = bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(cumulative bucket counts incl. +Inf, sum, count) — reads the
        fields without the child lock; a scrape racing a writer sees a
        momentarily inconsistent (sum, count) pair, the same tolerance
        the lock-free /stats reads already accept."""
        counts = list(self._counts)
        cumulative = []
        acc = 0
        for c in counts:
            acc += c
            cumulative.append(acc)
        return cumulative, self._sum, self._count


class _Family:
    child_class: type = None  # type: ignore[assignment]
    mtype = ""

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 *, locked: bool = True, **child_kwargs):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._locked = locked
        self._child_kwargs = child_kwargs
        # lock-free double-checked reads in labels(); inserts only under
        # the family lock
        self._children: Dict[Tuple[str, ...], _Child] = {}  # guarded by: self._family_lock [writes]
        self._family_lock = threading.Lock()
        if not self.labelnames:
            # label-less families expose one implicit child so the family
            # renders (at zero) before the first event — scrape targets
            # expect series to exist from process start
            self._children[()] = self._make_child()

    def _make_child(self):
        return self.child_class(self._locked, **self._child_kwargs)

    def labels(self, **labelvalues: str):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {tuple(labelvalues)}"
            )
        key = tuple(str(labelvalues[ln]) for ln in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._family_lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make_child()
                    self._children[key] = child
        return child

    # label-less convenience: family proxies its single child.  Public:
    # hot paths pre-resolve the child once at import (`FAMILY.single()`)
    # so the per-event write is a bare child op.
    def single(self):
        if self.labelnames:
            raise ValueError(f"{self.name} requires labels()")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self.single().inc(amount)

    def set(self, value: float) -> None:
        self.single().set(value)

    def dec(self, amount: float = 1.0) -> None:
        self.single().dec(amount)

    def observe(self, value: float) -> None:
        self.single().observe(value)

    def _label_pairs(self, key: Tuple[str, ...]) -> Tuple[Tuple[str, str], ...]:
        return tuple(zip(self.labelnames, key))

    def collect(self) -> FamilySnapshot:
        samples = []
        for key, child in list(self._children.items()):
            samples.extend(self._child_samples(self._label_pairs(key), child))
        return FamilySnapshot(self.name, self.mtype, self.help, samples)

    def _child_samples(self, labels, child):
        raise NotImplementedError


class Counter(_Family):
    child_class = CounterChild
    mtype = "counter"

    def _child_samples(self, labels, child):
        return [("", labels, child.value)]


class Gauge(_Family):
    child_class = GaugeChild
    mtype = "gauge"

    def _child_samples(self, labels, child):
        return [("", labels, child.value)]


class Histogram(_Family):
    child_class = HistogramChild
    mtype = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 *, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                 locked: bool = True):
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError("histogram buckets must be sorted and unique")
        if bounds and bounds[-1] == math.inf:
            bounds = bounds[:-1]  # +Inf is implicit
        self.bounds = bounds
        super().__init__(name, help, labelnames, locked=locked, bounds=bounds)

    def _child_samples(self, labels, child):
        cumulative, total, count = child.snapshot()
        out = []
        for bound, c in zip(self.bounds + (math.inf,), cumulative):
            out.append(("_bucket", labels + (("le", _fmt(bound)),), c))
        out.append(("_sum", labels, total))
        out.append(("_count", labels, count))
        return out


def histogram_snapshot(bounds: Sequence[float],
                       counts: Sequence[int], total: float, count: int,
                       labels: Tuple[Tuple[str, str], ...]):
    """Histogram-typed samples from externally maintained state (the
    engine's single-writer ``PhaseRecorder``): same wire shape as
    ``Histogram._child_samples``.  ``counts`` are non-cumulative with the
    +Inf slot last."""
    out = []
    acc = 0
    for bound, c in zip(tuple(bounds) + (math.inf,), counts):
        acc += c
        out.append(("_bucket", labels + (("le", _fmt(bound)),), acc))
    out.append(("_sum", labels, total))
    out.append(("_count", labels, count))
    return out


class PhaseRecorder:
    """Single-writer per-phase duration accumulator for one processor.

    The engine writes this with PLAIN attribute math — no locks, no
    device syncs — under the workload lock's existing single-writer
    guarantee; /metrics and /stats read it lock-free (torn reads
    tolerated, matching the ProfileStats/live_records stance).  Scrape
    code turns it into histogram samples via ``collect_samples``.
    """

    __slots__ = ("bounds", "_phases")

    def __init__(self, bounds: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        self._phases: Dict[str, list] = {}

    def observe(self, phase: str, seconds: float) -> None:
        state = self._phases.get(phase)
        if state is None:
            # first observation for a phase; the single writer is the
            # only thread that ever inserts
            state = [[0] * (len(self.bounds) + 1), 0.0, 0]
            self._phases[phase] = state
        state[0][bisect_left(self.bounds, seconds)] += 1
        state[1] += seconds
        state[2] += 1

    def phase_seconds(self) -> Dict[str, float]:
        """Total seconds per phase (for /stats and the bench breakdown)."""
        return {phase: state[1] for phase, state in self._phases.items()}

    def collect_samples(self, base_labels: Tuple[Tuple[str, str], ...]):
        out = []
        for phase, state in list(self._phases.items()):
            out.extend(histogram_snapshot(
                self.bounds, list(state[0]), state[1], state[2],
                base_labels + (("phase", phase),),
            ))
        return out


class MetricRegistry:
    """A set of metric families plus scrape-time collectors.

    ``counter`` / ``gauge`` / ``histogram`` are idempotent per name (the
    existing family returns, so module-level singletons and per-app
    registries can both declare-at-use); a name re-declared as a
    different type raises.  ``register_collector`` adds a zero-arg
    callable returning ``FamilySnapshot``s evaluated at scrape time —
    used for state that already has a lock-free home (corpus sizes,
    ProfileStats, PhaseRecorders) rather than double-accounting it into
    registry children.
    """

    def __init__(self):
        self._families: Dict[str, _Family] = {}  # guarded by: self._lock [writes]
        self._collectors: List[Callable[[], Iterable[FamilySnapshot]]] = []  # guarded by: self._lock [writes]
        self._lock = threading.Lock()

    def _family(self, cls, name: str, help: str, labelnames=(), **kwargs):
        with self._lock:
            existing = self._families.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.mtype}"
                    )
                return existing
            fam = cls(name, help, labelnames, **kwargs)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str, labelnames=(), *,
                locked: bool = True) -> Counter:
        return self._family(Counter, name, help, labelnames, locked=locked)

    def gauge(self, name: str, help: str, labelnames=(), *,
              locked: bool = True) -> Gauge:
        return self._family(Gauge, name, help, labelnames, locked=locked)

    def histogram(self, name: str, help: str, labelnames=(), *,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  locked: bool = True) -> Histogram:
        return self._family(Histogram, name, help, labelnames,
                            buckets=buckets, locked=locked)

    def register_collector(
            self, fn: Callable[[], Iterable[FamilySnapshot]]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def unregister_collector(
            self, fn: Callable[[], Iterable[FamilySnapshot]]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def collect(self) -> List[FamilySnapshot]:
        with self._lock:
            families = list(self._families.values())
            collectors = list(self._collectors)
        out = [fam.collect() for fam in families]
        for fn in collectors:
            out.extend(fn())
        return out


# scrape-pass hooks: (begin, end) pairs invoked
# around one render() so expensive state (the HBM ledger's component
# callables) is snapshotted ONCE per scrape no matter how many
# collectors read it — at 200 tenants the per-collector recompute made
# /metrics a hot path.  Registration is import-time only (the ledger
# module's tail), so the list is read-mostly and needs no lock.
_RENDER_HOOKS: List[tuple] = []


def add_render_hook(begin: Callable[[], None],
                    end: Callable[[], None]) -> None:
    _RENDER_HOOKS.append((begin, end))


def render(*registries: MetricRegistry) -> str:
    """Prometheus text exposition (0.0.4) over one or more registries.

    Snapshots sharing a family name merge under one HELP/TYPE header
    (first declaration wins) — required for validity: a name may appear
    in only one block.
    """
    for begin, _end in _RENDER_HOOKS:
        begin()
    try:
        merged: Dict[str, FamilySnapshot] = {}
        for registry in registries:
            for snap in registry.collect():
                existing = merged.get(snap.name)
                if existing is None:
                    merged[snap.name] = FamilySnapshot(
                        snap.name, snap.mtype, snap.help, list(snap.samples)
                    )
                else:
                    existing.samples.extend(snap.samples)
        lines: List[str] = []
        for snap in merged.values():
            help_text = snap.help.replace("\\", "\\\\").replace("\n", "\\n")
            lines.append(f"# HELP {snap.name} {help_text}")
            lines.append(f"# TYPE {snap.name} {snap.mtype}")
            for suffix, labels, value in snap.samples:
                lines.append(
                    f"{snap.name}{suffix}{_fmt_labels(labels)} {_fmt(value)}"
                )
        return "\n".join(lines) + "\n"
    finally:
        for _begin, end in _RENDER_HOOKS:
            end()


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
