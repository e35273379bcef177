"""Distributed tracing + flight recorder (a copy of the JAX package's
``telemetry/tracing.py`` without its mesh-follower capture and graft).

The metrics registry makes the service measurable in aggregate; this
module makes ONE request explainable.  The model is Dapper-style
(Sigelman et al., 2010): low-overhead always-on span recording with
causal span trees, head sampling, and — because aggregates exist
precisely to find the slow outliers — a **tail latch**: every request
records its spans into a per-trace scratch regardless of the sampling
decision, and the tree is retained if it was head-sampled *or* its total
latency crossed ``TRACE_SLOW_MS``.  Slow requests are never lost.

Pieces:

  * ``Span`` — name, monotonic-ns start/end, attributes, status, causal
    parent.  Plain ``__slots__`` object; creating one is two monotonic
    reads and a list append.
  * ``span()`` — nesting context manager over a ``contextvars.ContextVar``
    (composes with ``logctx``'s request ids; worker threads join via
    ``current_context()``/``attach()``).  With no active trace it is a
    single contextvar read — libraries can span unconditionally.
  * ``start_trace()`` — opens a root span + scratch, honoring an inbound
    W3C ``traceparent`` (``parse_traceparent``/``format_traceparent``),
    and on exit applies the tail latch and lands the tree in the
    ``FlightRecorder``.
  * ``FlightRecorder`` — two bounded rings: retained trace trees
    (``/debug/traces``) and an always-on last-N request digest ring with
    per-phase timings even for unretained requests (``/debug/requests``).
  * ``chrome_trace()`` — Chrome trace-event JSON (loadable in Perfetto /
    chrome://tracing), in the JAX package's layout (its ``followers``
    row stays empty: the port has no mesh followers yet).

Overhead stance: the unsampled fast path per span is one contextvar get,
a set/reset pair, two ``monotonic_ns`` reads and a list append — no
locks on the span path (GIL-atomic appends, the registry's
single-writer tolerance), no device reads and no synchronization ever,
and all exporter/digest work happens at retention time.  Device-timeline
bridging (``annotate=True``) activates only while an on-demand
``torch.profiler`` capture is live (``utils.profiling.start_capture``):
the span then also opens a ``torch.profiler.record_function`` range, so
idle serving never touches the profiler from here.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import random
import re
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

from .env import env_float, env_int
from .logctx import current_request_id

__all__ = [
    "Span",
    "TraceContext",
    "FlightRecorder",
    "RECORDER",
    "span",
    "add_span",
    "add_phase_spans",
    "start_trace",
    "current_context",
    "attach",
    "current_trace_id",
    "parse_traceparent",
    "format_traceparent",
    "chrome_trace",
    "trace_to_json",
    "set_device_annotations",
    "device_annotations_active",
]


# -- env knobs (read at call time so tests and reloads take effect) ----------

# shared fallback-on-ValueError parsing (telemetry.env): this runs at
# import via the global RECORDER
_env_int = env_int


def _sample_rate() -> float:
    """Head-sampling probability in [0, 1] (``TRACE_SAMPLE_RATE``)."""
    return min(1.0, max(0.0, env_float("TRACE_SAMPLE_RATE", 0.01)))


def _slow_ms() -> float:
    """Tail-latch threshold (``TRACE_SLOW_MS``); <= 0 disables the latch."""
    return env_float("TRACE_SLOW_MS", 1000.0)


def _max_spans() -> int:
    """Per-trace span cap (``TRACE_MAX_SPANS``) — a pathological request
    (per-link spans over a huge feed) must stay O(cap), not O(work)."""
    return max(1, env_int("TRACE_MAX_SPANS", 512))


# id generation: uniqueness, not cryptographic strength — a per-process
# PRNG (urandom-seeded once) plus a monotone counter tail keeps the
# always-on span path free of per-span os.urandom syscalls while making
# in-process collisions impossible (the counter) and cross-process
# collisions 2^-104 (the random prefix).  getrandbits/next are single
# C calls, atomic under the GIL.
_RNG = random.Random()
_SEQ = itertools.count()


def _new_trace_id() -> str:
    return f"{_RNG.getrandbits(104):026x}{next(_SEQ) & 0xFFFFFF:06x}"


def _new_span_id() -> str:
    return f"{_RNG.getrandbits(40):010x}{next(_SEQ) & 0xFFFFFF:06x}"


class Span:
    """One timed operation.  ``start_ns``/``end_ns`` are monotonic."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start_ns",
                 "end_ns", "attributes", "status")

    def __init__(self, trace_id: str, span_id: str, parent_id: Optional[str],
                 name: str, start_ns: int,
                 attributes: Optional[Dict[str, Any]] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_ns = start_ns
        self.end_ns = start_ns
        self.attributes = attributes
        self.status = "ok"

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def set_attribute(self, key: str, value: Any) -> None:
        if self.attributes is None:
            self.attributes = {}
        self.attributes[key] = value

    def to_dict(self, base_ns: int) -> Dict[str, Any]:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_us": (self.start_ns - base_ns) / 1000.0,
            "duration_us": self.duration_ns / 1000.0,
            "status": self.status,
            "attributes": self.attributes or {},
        }


class _Trace:
    """Per-request scratch: the span buffer behind the tail latch.

    Appends are plain list ops (GIL-atomic) — worker threads adopted via
    ``attach()`` may append concurrently and the rare torn ``dropped``
    increment is accepted, matching the registry's unlocked-child
    stance.
    """

    __slots__ = ("trace_id", "sampled", "spans", "started_ns",
                 "started_unix", "max_spans", "dropped")

    def __init__(self, trace_id: str, sampled: bool):
        self.trace_id = trace_id
        self.sampled = sampled
        self.spans: List[Span] = []
        self.started_ns = time.monotonic_ns()
        self.started_unix = time.time()
        self.max_spans = _max_spans()
        self.dropped = 0

    def add(self, span_obj: Span) -> None:
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            return
        self.spans.append(span_obj)


# (trace, active span id) — None outside any request
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "duke_trace", default=None
)


def current_context():
    """Opaque (trace, span-id) token for cross-thread propagation: a
    worker thread re-enters the request's trace with ``attach(token)``."""
    return _ACTIVE.get()


@contextlib.contextmanager
def attach(ctx) -> Iterator[None]:
    """Adopt a ``current_context()`` token on another thread."""
    token = _ACTIVE.set(ctx)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def current_trace_id() -> Optional[str]:
    active = _ACTIVE.get()
    return active[0].trace_id if active is not None else None


def sampled_trace_id() -> Optional[str]:
    """The active trace id only when that trace is actually recorded —
    the form exemplars (SLO violations) must use, because an unsampled
    id would be a dead link in /debug/traces."""
    active = _ACTIVE.get()
    if active is None or not active[0].sampled:
        return None
    return active[0].trace_id


# -- W3C trace context -------------------------------------------------------

class TraceContext:
    """Parsed ``traceparent``: remote trace id + parent span + sampled."""

    __slots__ = ("trace_id", "parent_id", "sampled")

    def __init__(self, trace_id: str, parent_id: str, sampled: bool):
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.sampled = sampled


_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def parse_traceparent(value: Optional[str]) -> Optional[TraceContext]:
    """W3C traceparent: ``version-traceid-parentid-flags`` (lower hex).
    Returns None for absent/malformed/all-zero values (the spec's
    restart semantics: an invalid header starts a fresh trace)."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip())
    if m is None:
        return None
    version, trace_id, parent_id, flags = m.groups()
    if version == "ff" or set(trace_id) == {"0"} or set(parent_id) == {"0"}:
        return None
    return TraceContext(trace_id, parent_id, bool(int(flags, 16) & 0x01))


def format_traceparent(trace_id: str, span_id: str, sampled: bool) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


# -- flight recorder ---------------------------------------------------------

class TraceRecord:
    """One retained trace tree plus its summary row."""

    __slots__ = ("trace_id", "name", "request_id", "started_unix",
                 "base_ns", "duration_ms", "spans", "sampled", "slow",
                 "status", "dropped")

    def __init__(self, trace: _Trace, root: Span, *, slow: bool):
        self.trace_id = trace.trace_id
        self.name = root.name
        self.request_id = (root.attributes or {}).get(
            "request_id", current_request_id())
        self.started_unix = trace.started_unix
        self.base_ns = root.start_ns
        self.duration_ms = root.duration_ns / 1e6
        self.spans = trace.spans
        self.sampled = trace.sampled
        self.slow = slow
        self.status = root.status
        self.dropped = trace.dropped

    def summary(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "request_id": self.request_id,
            "time_unix": round(self.started_unix, 3),
            "duration_ms": round(self.duration_ms, 3),
            "span_count": len(self.spans),
            "slow": self.slow,
            "sampled": self.sampled,
            "status": self.status,
        }


_PHASES = ("encode", "retrieve", "score", "persist")


def _phase_seconds(spans: List[Span]) -> Dict[str, float]:
    """Per-phase seconds summed from engine phase spans: the four names
    from engine/processor.py, or a span's ``phase`` attribute (the spans
    an engine records in their stead)."""
    out: Dict[str, float] = {}
    for s in spans:
        phase = (s.attributes or {}).get("phase")
        if phase is None and s.name in _PHASES:
            phase = s.name
        if phase is not None:
            out[phase] = out.get(phase, 0.0) + s.duration_ns / 1e9
    return {k: round(v, 6) for k, v in out.items()}


class FlightRecorder:
    """Two bounded rings: retained trace trees + always-on request digests.

    Ring sizes come from ``TRACE_RING_SIZE`` (retained trees, default 128)
    and ``REQUEST_RING_SIZE`` (digests, default 512) at construction.
    All mutation happens at retention time under a short lock — never on
    the span recording path.  The retained-tree ring is a
    ``rings.LatchedRing`` (the eviction/latch core shared with the
    decision recorder): slow/errored traces are *remarkable*, so an
    upstream stamping every request sampled cannot flush them.
    """

    def __init__(self, trace_capacity: Optional[int] = None,
                 digest_capacity: Optional[int] = None):
        from .rings import LatchedRing

        if trace_capacity is None:
            trace_capacity = _env_int("TRACE_RING_SIZE", 128)
        if digest_capacity is None:
            digest_capacity = _env_int("REQUEST_RING_SIZE", 512)
        self._lock = threading.Lock()
        self._ring = LatchedRing(max(1, trace_capacity))
        self._digests: deque = deque(maxlen=max(1, digest_capacity))

    def finish(self, trace: _Trace, root: Span) -> bool:
        """Apply the tail latch to a completed trace: always digest,
        retain the tree when sampled / slow / errored.  Returns whether
        the tree was retained."""
        duration_ms = root.duration_ns / 1e6
        slow_ms = _slow_ms()
        slow = slow_ms > 0 and duration_ms >= slow_ms
        retain = trace.sampled or slow or root.status != "ok"
        digest = {
            "trace_id": trace.trace_id,
            "request_id": (root.attributes or {}).get(
                "request_id", current_request_id()),
            "name": root.name,
            "time_unix": round(trace.started_unix, 3),
            "duration_ms": round(duration_ms, 3),
            "span_count": len(trace.spans),
            "status": root.status,
            "phase_seconds": _phase_seconds(trace.spans),
            "slow": slow,
            "sampled": trace.sampled,
            "retained": retain,
        }
        with self._lock:
            self._digests.append(digest)
        if retain:
            with self._ring.lock:
                existing = self._ring.get(trace.trace_id)
                if existing is not None:
                    # the same trace id retained again — a client
                    # reusing a traceparent: MERGE into the stored tree
                    # (same-process monotonic clock, so the first
                    # record's base anchors the added spans correctly)
                    # rather than silently dropping the earlier trees.
                    # Bounded: a fixed traceparent must not grow one
                    # record without limit (4x the per-trace cap, then
                    # overflow counts as dropped)
                    room = 4 * _max_spans() - len(existing.spans)
                    added = trace.spans[:max(0, room)]
                    existing.spans = existing.spans + added
                    existing.dropped += (trace.dropped
                                         + len(trace.spans) - len(added))
                    existing.slow = existing.slow or slow
                    if root.status != "ok":
                        existing.status = root.status
                    existing.duration_ms = max(
                        existing.duration_ms, root.duration_ns / 1e6)
                    record = existing
                else:
                    record = TraceRecord(trace, root, slow=slow)
                # keeps the key's ring position on merge; eviction
                # prefers unremarkable (fast, ok) records — rings.py
                self._ring.put(
                    record.trace_id, record,
                    remarkable=record.slow or record.status != "ok",
                )
        return retain

    def summaries(self) -> List[Dict[str, Any]]:
        """Most-recent-first summary rows for ``GET /debug/traces``."""
        return [r.summary() for r in self._ring.records()]

    def get(self, trace_id: str) -> Optional[TraceRecord]:
        return self._ring.get(trace_id)

    def digests(self) -> List[Dict[str, Any]]:
        """Most-recent-first request digests for ``GET /debug/requests``."""
        with self._lock:
            return list(reversed(self._digests))

    def clear(self) -> None:
        self._ring.clear()
        with self._lock:
            self._digests.clear()


RECORDER = FlightRecorder()


# -- device-timeline bridging ------------------------------------------------

# flipped by utils/profiling while a torch.profiler capture is live:
# spans created with ``annotate=True`` then also open a
# ``torch.profiler.record_function`` range so the capture's timeline
# carries the same names.  A plain bool read on the span path; the
# profiler is touched only while capturing.
_ANNOTATE = False


def set_device_annotations(enabled: bool) -> None:
    global _ANNOTATE
    _ANNOTATE = bool(enabled)


def device_annotations_active() -> bool:
    return _ANNOTATE


def _enter_annotation(name: str):
    try:
        from torch.profiler import record_function

        ann = record_function(name)
        ann.__enter__()
        return ann
    except Exception:
        return None


# -- span recording ----------------------------------------------------------

class _SpanCtx:
    """The ``span()`` context manager as a slotted class: the unsampled
    fast path stays one contextvar get (+ a set/reset pair and two
    monotonic reads when a trace is active)."""

    __slots__ = ("_name", "_attributes", "_annotate", "_span", "_token",
                 "_trace", "_ann")

    def __init__(self, name: str, attributes: Optional[Dict[str, Any]],
                 annotate: bool):
        self._name = name
        self._attributes = attributes
        self._annotate = annotate
        self._span = None
        self._token = None
        self._trace = None
        self._ann = None

    def __enter__(self) -> Optional[Span]:
        active = _ACTIVE.get()
        if active is None:
            return None
        trace, parent_id = active
        s = Span(trace.trace_id, _new_span_id(), parent_id, self._name,
                 time.monotonic_ns(), self._attributes)
        self._span = s
        self._trace = trace
        self._token = _ACTIVE.set((trace, s.span_id))
        if self._annotate and _ANNOTATE:
            self._ann = _enter_annotation(self._name)
        return s

    def __exit__(self, exc_type, exc, tb) -> bool:
        s = self._span
        if s is None:
            return False
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:
                pass
        _ACTIVE.reset(self._token)
        s.end_ns = time.monotonic_ns()
        if exc_type is not None:
            s.status = "error"
            s.set_attribute("error", repr(exc))
        self._trace.add(s)
        return False


def span(name: str, attributes: Optional[Dict[str, Any]] = None,
         *, annotate: bool = False) -> _SpanCtx:
    """Open a child span under the active trace (no-op outside one).

    ``annotate=True`` additionally opens a
    ``torch.profiler.record_function`` range while an on-demand capture
    is live, so the capture's timeline carries the same phase names."""
    return _SpanCtx(name, attributes, annotate)


def add_span(name: str, start_ns: int, end_ns: int,
             attributes: Optional[Dict[str, Any]] = None) -> None:
    """Record an already-measured interval as a completed child span.

    Used where the interval is known only after the fact (the host
    engine's accumulated retrieve/score layout, the scheduler's wait for
    a workload lock) — the caller supplies the interval; nothing re-reads
    the clock."""
    active = _ACTIVE.get()
    if active is None:
        return
    trace, parent_id = active
    s = Span(trace.trace_id, _new_span_id(), parent_id, name, start_ns,
             attributes)
    s.end_ns = max(start_ns, end_ns)
    trace.add(s)


def add_phase_spans(start_ns: int, retrieve_seconds: float,
                    score_seconds: float) -> None:
    """The host engine's retrieve/score span layout: both phases
    interleave per record (and across its thread pool), so their spans
    carry the ACCUMULATED durations laid out sequentially from the
    matching region's start — the timeline shows where the batch's time
    went, not exact intervals.  The device backends record true
    intervals instead (``scan.dispatch``, ``scan.wait``, ``finalize.dd``,
    ``finalize``)."""
    r_end = start_ns + int(retrieve_seconds * 1e9)
    add_span("retrieve", start_ns, r_end, {"aggregate": True})
    add_span("score", r_end, r_end + int(score_seconds * 1e9),
             {"aggregate": True})


class _RootCtx:
    """``start_trace()``: root span + scratch + tail-latch retention."""

    __slots__ = ("_name", "_attributes", "_traceparent", "_sampled",
                 "_recorder", "_trace", "_root", "_token", "retained")

    def __init__(self, name: str, attributes, traceparent, sampled,
                 recorder):
        self._name = name
        self._attributes = attributes
        self._traceparent = traceparent
        self._sampled = sampled
        self._recorder = recorder
        self._trace = None
        self._root = None
        self._token = None
        self.retained = False

    def __enter__(self) -> Span:
        ctx = parse_traceparent(self._traceparent)
        if ctx is not None:
            trace_id, parent_id, sampled = (
                ctx.trace_id, ctx.parent_id, ctx.sampled)
        else:
            trace_id, parent_id = _new_trace_id(), None
            sampled = _RNG.random() < _sample_rate()
        if self._sampled is not None:
            sampled = bool(self._sampled)
        trace = _Trace(trace_id, sampled)
        root = Span(trace_id, _new_span_id(), parent_id, self._name,
                    trace.started_ns, self._attributes)
        self._trace, self._root = trace, root
        self._token = _ACTIVE.set((trace, root.span_id))
        return root

    def __exit__(self, exc_type, exc, tb) -> bool:
        _ACTIVE.reset(self._token)
        root = self._root
        root.end_ns = time.monotonic_ns()
        if exc_type is not None:
            root.status = "error"
            root.set_attribute("error", repr(exc))
        trace = self._trace
        if trace.dropped:
            root.set_attribute("spans_dropped", trace.dropped)
        # the root bypasses the span cap: a pathological request must
        # still land its tree's anchor (and the digest's duration source)
        trace.spans.append(root)
        recorder = self._recorder if self._recorder is not None else RECORDER
        self.retained = recorder.finish(trace, root)
        return False


def start_trace(name: str, *, traceparent: Optional[str] = None,
                attributes: Optional[Dict[str, Any]] = None,
                sampled: Optional[bool] = None,
                recorder: Optional[FlightRecorder] = None) -> _RootCtx:
    """Open a root span (one per request / bench batch).

    An inbound W3C ``traceparent`` is honored: its trace id continues
    and its sampled flag is inherited, so a mesh of services shares one
    head-sampling decision.  ``sampled`` forces the decision (bench);
    ``recorder`` overrides the process recorder (tests)."""
    return _RootCtx(name, attributes, traceparent, sampled, recorder)


# -- exporters ---------------------------------------------------------------

def propagation_context() -> Optional[Dict[str, Any]]:
    """The active trace context as a small picklable dict, for embedding
    in dispatch op tuples (parallel/dispatch.py).  None outside a trace
    -- callers skip the op-tuple field entirely."""
    active = _ACTIVE.get()
    if active is None:
        return None
    trace, span_id = active
    return {"trace_id": trace.trace_id, "parent_id": span_id,
            "sampled": trace.sampled}


# -- remote (follower) spans -------------------------------------------------

class _RemoteCapture:
    """Follower-side capture of one replay as a remote child span tree.

    Opens a detached trace continuing the leader's ids so nested engine
    spans (the replica's commit path) land in the same tree; ``wire()``
    serializes the collected spans (offsets relative to the capture
    root) for the digest handshake.  With ``ctx=None`` (no active trace
    on the leader) the capture is a no-op and ``wire()`` is empty.

    Ops with no response channel (score, rematch) pass ``recorder``
    instead: the replay tree lands in the follower's LOCAL flight
    recorder under the leader's trace id (same tail-latch rules).
    """

    __slots__ = ("_ctx", "_name", "_attributes", "_trace", "_root",
                 "_token", "_recorder")

    def __init__(self, name: str, ctx: Optional[Dict[str, Any]],
                 attributes: Optional[Dict[str, Any]],
                 recorder: Optional[FlightRecorder] = None):
        self._name = name
        self._ctx = ctx
        self._attributes = attributes
        self._recorder = recorder
        self._trace = None
        self._root = None
        self._token = None

    def __enter__(self) -> "_RemoteCapture":
        if self._ctx is None:
            return self
        trace = _Trace(str(self._ctx["trace_id"]),
                       bool(self._ctx.get("sampled")))
        root = Span(trace.trace_id, _new_span_id(),
                    self._ctx.get("parent_id"), self._name,
                    trace.started_ns, self._attributes)
        self._trace, self._root = trace, root
        self._token = _ACTIVE.set((trace, root.span_id))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._root is None:
            return False
        _ACTIVE.reset(self._token)
        self._root.end_ns = time.monotonic_ns()
        if exc_type is not None:
            self._root.status = "error"
            self._root.set_attribute("error", repr(exc))
        self._trace.spans.append(self._root)  # root bypasses the cap
        if self._recorder is not None:
            self._recorder.finish(self._trace, self._root)
        return False

    def wire(self) -> bytes:
        """Collected spans as compact JSON (raw bytes for the handshake
        frame — never pickle on the response path)."""
        if self._root is None:
            return b""
        base = self._root.start_ns
        rows = []
        for s in self._trace.spans:
            rows.append({
                "trace_id": s.trace_id,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "name": s.name,
                "offset_ns": s.start_ns - base,
                "duration_ns": s.duration_ns,
                "status": s.status,
                "attributes": s.attributes or {},
            })
        return json.dumps(rows, separators=(",", ":")).encode("utf-8")


def capture_remote(name: str, ctx: Optional[Dict[str, Any]],
                   attributes: Optional[Dict[str, Any]] = None,
                   recorder: Optional[FlightRecorder] = None
                   ) -> _RemoteCapture:
    """Wrap a follower replay in a remote child span of the leader's
    trace (see ``_RemoteCapture``)."""
    return _RemoteCapture(name, ctx, attributes, recorder)


def graft_remote(payload: bytes) -> int:
    """Leader side: splice follower replay spans into the active trace.

    Follower monotonic clocks are unrelated to the leader's, so the
    remote tree is re-anchored to end at graft time (the handshake read
    just completed, so that is within socket latency of the truth).
    Returns the number of spans grafted (0 on no payload / no active
    trace / trace-id mismatch)."""
    if not payload:
        return 0
    active = _ACTIVE.get()
    if active is None:
        return 0
    trace, _ = active
    try:
        rows = json.loads(payload.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return 0
    if not isinstance(rows, list) or not rows:
        return 0
    try:
        total_ns = max(int(r["offset_ns"]) + int(r["duration_ns"])
                       for r in rows)
        anchor = time.monotonic_ns() - total_ns
        grafted = 0
        for r in rows:
            if r.get("trace_id", trace.trace_id) != trace.trace_id:
                continue
            s = Span(trace.trace_id, str(r["span_id"]),
                     r.get("parent_id"), str(r["name"]),
                     anchor + int(r["offset_ns"]),
                     dict(r.get("attributes") or {}) or None)
            s.end_ns = s.start_ns + int(r["duration_ns"])
            s.status = str(r.get("status", "ok"))
            s.set_attribute("remote", True)
            trace.add(s)
            grafted += 1
        return grafted
    except (KeyError, TypeError, ValueError):
        return 0


def trace_to_json(record: TraceRecord) -> Dict[str, Any]:
    """Flat JSON tree for ``GET /debug/traces/<id>`` (default format)."""
    out = record.summary()
    out["spans"] = [s.to_dict(record.base_ns) for s in record.spans]
    out["spans_dropped"] = record.dropped
    return out


def chrome_trace(record: TraceRecord) -> Dict[str, Any]:
    """Chrome trace-event JSON (the Perfetto-loadable export target).

    Complete ("X") events with microsecond timestamps relative to the
    root span; remote (follower) spans land on their own tid row so the
    leader/follower split reads directly off the timeline."""
    events: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": f"duke {record.name}"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 0,
         "args": {"name": "leader"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 1,
         "args": {"name": "followers"}},
    ]
    for s in record.spans:
        attrs = s.attributes or {}
        events.append({
            "name": s.name,
            "ph": "X",
            "ts": (s.start_ns - record.base_ns) / 1000.0,
            "dur": max(s.duration_ns, 0) / 1000.0,
            "pid": 0,
            "tid": 1 if attrs.get("remote") else 0,
            "cat": "duke",
            "args": {
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "status": s.status,
                **attrs,
            },
        })
    return {
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": record.trace_id,
            "request_id": record.request_id,
        },
        "traceEvents": events,
    }
