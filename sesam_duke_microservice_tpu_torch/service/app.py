"""The HTTP frontend: the reference REST surface plus the JAX package's
control and read surface, for the port's backends.

Counterpart of the JAX package's ``service/app.py`` on the stdlib
threading HTTP server:

    GET  /                                                homepage
    GET  /config                                          active XML verbatim
    POST /config                                          multipart hot reload
    POST /deduplication/:name/:datasetId                  ingest+match
    POST /deduplication/:name/:datasetId/httptransform    transform
    GET  /deduplication/:name/:datasetId[/httptransform]  405 after validation
    GET  /deduplication/:name?since=N                     incremental feed
    (same shapes under /recordlinkage)
    GET  /health /healthz                                 liveness
    GET  /readyz                                          readiness
    GET  /metrics                                         Prometheus text
    GET  /stats                                           per-workload JSON

A scoring POST goes through the ingest scheduler
(``engine.scheduler.IngestScheduler``, on unless ``DUKE_SCHEDULER=0``):
it queues per workload, coalesces concurrent POSTs into microbatches that
one dispatcher thread runs through ``Workload._run_merged``, and answers a
full queue with 429 and ``Retry-After``.  With the scheduler off the POST
goes through ``Workload.submit_batch`` (the lock-winner merge).
Transforms take the workload lock directly.  A POST body may be a JSON
array or one object (a single-entity transform answers one object);
bodies over ``MAX_REQUEST_BYTES`` answer 413 and close the connection.
Unknown names 404 on entity endpoints and 400 on feeds.

The ``?since=`` feed streams in ``FEED_PAGE_SIZE`` pages over chunked
framing, re-taking the workload lock per page (the reference holds it for
the whole response): the first page's lock waits 1 s and answers the
reference's busy 503 with a ``Retry-After``; later pages retry with
backoff until ``DUKE_FEED_RETRY_DEADLINE``, and an abort truncates the
chunked framing (counted in ``feed_aborts``).  HTTP/1.0 clients get the
same bytes buffered.

``POST /config`` hot-reloads: every old workload's lock is taken, their
corpus snapshots saved, the replacements built (a persistent device
workload restores from that snapshot, then copies the corpus to the card
in the background), both registries swapped and the old workloads closed,
freeing their device tensors; a failed build keeps the old config.
Queued ingest requests retarget the replacement (the scheduler
re-resolves) or fail with 404 when a reload removed their workload.

While a workload's link journal replays after a crash (overlapped
recovery), every response carries ``X-Recovering: 1`` and a scoring POST
to that workload answers 503 with ``Retry-After: 1``; feeds serve the
replayed prefix.  ``install_shutdown_handlers`` turns SIGTERM/SIGINT into
a graceful ``DukeApp.close()``: drain, flush, snapshot.

Every request is counted by route template, method and status, timed,
traced (a root span honoring an inbound W3C ``traceparent``, retained by
the flight recorder when sampled, slow or failed) and answered with an
``X-Request-Id`` and an ``X-Trace-Id``; ``/metrics`` renders the app's
registry with ``telemetry.GLOBAL``.  ``/debug/traces``,
``/debug/requests``, ``/debug/decisions``, ``/debug/profile``,
``/debug/costs``, ``/debug/memory``, ``/debug/slo`` and ``POST
/explain`` are the JAX package's (``service.debug``), as is
``/debug/probes``, the canary prober's read surface; ``/debug/loadmap``
waits for its module.  ``POST /{kind}/{name}/rematch`` re-scores every
live record against the whole corpus through the ring layout
(``engine.rematch``: a link-store backfill, or a re-match after a
threshold change); a datasource named ``rematch`` keeps the route as a
batch POST.

The canary prober (``service.prober``, on unless ``DUKE_PROBE=0``) keeps
one shadow workload per user workload under the reserved ``__probe__``
namespace, which no route resolves: an entity path naming it answers
404 and a feed 400.  A scoring POST whose corpus does not fit the device
budget even after the arena spilled every other tenant answers 503 with
``Retry-After`` (``ops.arena.ArenaAdmissionError``).
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from email.parser import BytesParser
from email.policy import default as email_policy
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .. import telemetry
from ..core.config import (
    ConfigError,
    ServiceConfig,
    load_default_config,
    parse_config,
)
from ..engine.scheduler import (
    DatasetGone,
    IngestScheduler,
    SchedulerClosed,
    SchedulerReject,
    WorkloadGone,
    scheduler_enabled,
)
from ..engine.workload import Workload, build_workload, resolve_device
from ..env import env_flag, env_float, env_str
from ..links import journal as link_journal
from ..ops.arena import ArenaAdmissionError
from ..telemetry import slo, tracing
from ..telemetry.decisions import audit_log
from ..telemetry.logctx import new_request_id, request_id_var
from ..telemetry.probes import is_probe_name, probes_enabled
from ..utils.backoff import full_jitter_delay
from . import debug as debug_api
from .homepage import render_homepage
from .metrics import (
    HttpMetrics,
    backend_info,
    make_app_collector,
    make_process_collector,
)

logger = logging.getLogger("duke-torch-service")

DEFAULT_PORT = 4567  # the reference's Spark default

READ_LOCK_TIMEOUT_SECONDS = 1.0
_BUSY_TEMPLATE = (
    "The {kind} is being written to, so reading is not currently possible. "
    "Please wait a bit and try again later."
)

# Request-body ceiling (bytes): the stdlib server would otherwise read
# Content-Length bytes unconditionally into memory.  64 MiB fits the
# stresstest batch shapes while bounding a hostile POST; MAX_REQUEST_BYTES
# overrides it (<= 0: unlimited).
DEFAULT_MAX_REQUEST_BYTES = 64 * 1024 * 1024


def _max_request_bytes() -> int:
    raw = env_str("MAX_REQUEST_BYTES")
    if not raw:
        return DEFAULT_MAX_REQUEST_BYTES
    try:
        limit = int(raw)
    except ValueError:
        logger.warning(
            "Unparseable MAX_REQUEST_BYTES=%r; using the %d default",
            raw, DEFAULT_MAX_REQUEST_BYTES,
        )
        return DEFAULT_MAX_REQUEST_BYTES
    # <= 0 means unlimited (a literal 0 limit would silently
    # write-disable the service)
    return limit if limit > 0 else (1 << 62)


# Links per feed page: one page's fetch + record resolution is the unit of
# workload-lock hold while streaming GET ?since= responses.
DEFAULT_FEED_PAGE_SIZE = 5000

# Mid-stream feed lock retries: bounded exponential backoff + full jitter
# under a wall-clock deadline, so a wedged writer stops pinning the
# handler thread at a predictable instant.
DEFAULT_FEED_RETRY_DEADLINE_S = 120.0
_FEED_BACKOFF_BASE_S = 0.05
_FEED_BACKOFF_CAP_S = 2.0


def _feed_retry_deadline() -> float:
    return max(1.0, env_float("DUKE_FEED_RETRY_DEADLINE",
                              DEFAULT_FEED_RETRY_DEADLINE_S))


def _feed_page_size() -> int:
    raw = env_str("FEED_PAGE_SIZE")
    try:
        value = int(raw) if raw else DEFAULT_FEED_PAGE_SIZE
    except ValueError:
        value = DEFAULT_FEED_PAGE_SIZE
    return max(1, value)


def write_chunk(wfile, data: bytes) -> int:
    """One HTTP/1.1 chunk.  Zero-length data writes nothing (a zero-length
    chunk would terminate the stream).  Returns the payload bytes
    written."""
    if not data:
        return 0
    wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
    return len(data)


class DukeApp:
    """Application state: the parsed config, its live workloads (hot
    swappable by ``apply_config``), the ingest scheduler and the metrics
    registry.  Each workload scores with ``backend`` (``device`` brute
    force unless the caller asks for ``ann`` or ``host``) on the torch
    ``device`` (``cuda`` unless the caller asks for ``cpu``; the ``host``
    backend runs no device code and leaves ``device`` None).
    ``persistent`` (the default) keeps each workload's state in its data
    folder and restarts from it; ``persistent=False`` keeps everything in
    memory."""

    def __init__(self, config: ServiceConfig, *, backend: str = "device",
                 device="cuda", persistent: bool = True):
        self.device = None if backend == "host" else resolve_device(device)
        self.backend = backend
        self.persistent = persistent
        self._swap_lock = threading.Lock()
        self.config: Optional[ServiceConfig] = None
        self.deduplications: Dict[str, Workload] = {}
        self.record_linkages: Dict[str, Workload] = {}
        self.started_monotonic = time.monotonic()
        # per-app metrics registry: HTTP families are children written by
        # the handler threads; engine/corpus/link state is surfaced by a
        # scrape-time collector over the LIVE workload registries (so hot
        # reloads drop replaced workloads' series automatically).
        # /metrics renders this registry plus telemetry.GLOBAL.
        self.metrics = telemetry.MetricRegistry()
        self.http_metrics = HttpMetrics(self.metrics)
        self.metrics.register_collector(make_app_collector(self))
        self.metrics.register_collector(make_process_collector(self.device))
        # mid-stream feed aborts truncate the chunked framing, which a
        # scrape cannot see: plain counters surfaced by the app collector
        # and /stats, incremented under the lock (rare events)
        self.feed_aborts = {
            "lock_starved": 0, "workload_removed": 0, "deadline": 0,
        }
        self._feed_abort_lock = threading.Lock()
        # close() runs from the signal-driven shutdown thread AND the
        # CLI's finally: one caller drains, every other caller waits for
        # it (the CLI's exit must not cut a drain or snapshot short)
        self._close_lock = threading.Lock()
        self._closed = False  # guarded by: self._close_lock [writes]
        self._close_done = threading.Event()
        # cold start: stamped once by whichever thread serves the first
        # successful scoring batch (a plain GIL-atomic flag; a tied race
        # would set a near-identical value twice, harmlessly)
        self._first_batch_served = False
        self.scheduler: Optional[IngestScheduler] = None
        self.prober = None
        self.apply_config(config)
        # queues are keyed by (kind, name) and dispatch re-resolves from
        # the live registries, so a reload retargets queued requests at
        # the replacement; DUKE_SCHEDULER=0 leaves POSTs to
        # Workload.submit_batch
        if scheduler_enabled():
            self.scheduler = IngestScheduler(self._resolve_workload)
        # the black-box canary prober: one shadow workload per user
        # workload under the reserved __probe__ namespace, cycling the
        # derived canary corpus through the real path (scheduler,
        # scoring, finalize, links, feed) on a background interval.
        # Shadows live only in the prober -- never in the HTTP registries
        # -- and DUKE_PROBE=0 builds no prober, thread or collector
        if probes_enabled():
            from .prober import CanaryProber

            self.prober = CanaryProber(self)
            self.prober.start()

    def _resolve_workload(self, kind: str, name: str) -> Optional[Workload]:
        if is_probe_name(name):
            # the scheduler's dispatch of canary batches: probe names
            # resolve through the prober's shadows, invisible to HTTP
            prober = self.prober
            return prober.resolve(kind, name) if prober is not None else None
        registry = (self.deduplications if kind == "deduplication"
                    else self.record_linkages)
        return registry.get(name)

    def _workloads(self):
        return (list(self.deduplications.values())
                + list(self.record_linkages.values()))

    def count_feed_abort(self, reason: str) -> None:
        with self._feed_abort_lock:
            self.feed_aborts[reason] = self.feed_aborts.get(reason, 0) + 1

    def link_flush_errors(self) -> Dict[str, str]:
        """Latched write-behind flush failures by workload: /readyz goes
        unready and /healthz names the exception.  Lock-free reads of the
        buffers' latched error slots."""
        out: Dict[str, str] = {}
        for kind, registry in (("deduplication", self.deduplications),
                               ("recordlinkage", self.record_linkages)):
            for name, wl in registry.items():
                try:
                    err = wl.link_database.flush_error
                except Exception:
                    continue  # closed/raced workload: not a latch
                if err is not None:
                    out[f"{kind}/{name}"] = repr(err)
        return out

    def recovering(self) -> bool:
        """Whether any of this app's workloads is still replaying its
        link journal.  Runs on every response (the X-Recovering header),
        so the steady state is one process-wide check."""
        if not link_journal.recovery_active(None):
            return False  # nothing recovering anywhere: the common case
        if self.config is None:
            return True
        folders = [
            wc.data_folder
            for wc in (list(self.config.deduplications.values())
                       + list(self.config.record_linkages.values()))
            if wc.data_folder
        ]
        if not folders:
            return link_journal.recovery_active("")
        return any(link_journal.recovery_active(f) for f in folders)

    def note_first_batch(self) -> None:
        """Stamp ``duke_cold_start_seconds`` on the first successfully
        served scoring batch (time-to-first-200)."""
        if not self._first_batch_served:
            self._first_batch_served = True
            telemetry.COLD_START_SECONDS.set(
                time.monotonic() - self.started_monotonic)

    def readiness(self) -> Tuple[bool, Dict[str, bool]]:
        """GET /readyz substance: config parsed, every configured workload
        built and swapped in, (non-host backends) the device backend with
        at least one device, no workload's write-behind link persistence
        latched on a flush failure, and no link-journal replay running.
        During overlapped recovery reads serve while ``write_ready`` stays
        false until the replay completes."""
        checks = {"config_loaded": self.config is not None}
        checks["recovery_complete"] = not self.recovering()
        checks["workloads_built"] = bool(
            self.config is not None
            and set(self.deduplications) == set(self.config.deduplications)
            and set(self.record_linkages) == set(self.config.record_linkages)
        )
        if self.backend == "host":
            checks["device_backend"] = True
        else:
            checks["device_backend"] = backend_info(self.device)[1] > 0
        checks["link_persistence"] = not self.link_flush_errors()
        checks["write_ready"] = (checks["recovery_complete"]
                                 and checks["link_persistence"])
        return all(checks.values()), checks

    @property
    def config_string(self) -> str:
        return self.config.config_string if self.config else ""

    def apply_config(self, sc: ServiceConfig) -> None:
        """Quiesce, rebuild, atomically swap (App.java:543-546), close.

        The reference swaps its registries without taking the workload
        locks, so an in-flight batch can commit records after the new
        workloads read their state.  Here every old workload's lock is
        held while their corpus snapshots are saved and the replacements
        restore from them, so nothing lands between the snapshot and the
        swap; the replaced workloads are then closed, which frees their
        device tensors (the card briefly holds both corpora while the
        replacements upload).  The scheduler's dispatcher never blocks on
        these locks: it requeues and retries, then re-resolves the
        replacement.  A failed build closes what it built and keeps the
        old config."""
        with self._swap_lock:
            old = self._workloads()
            for wl in old:
                wl.lock.acquire()
            try:
                # snapshot the quiesced corpora FIRST: without it a
                # persistent device reload would replay the store through
                # full feature extraction instead of the snapshot route
                for wl in old:
                    wl.save_corpus_snapshot()
                built = []
                try:
                    new_dedups, new_linkages = {}, {}
                    for registry, configs in (
                            (new_dedups, sc.deduplications),
                            (new_linkages, sc.record_linkages)):
                        for name, wc in configs.items():
                            registry[name] = build_workload(
                                wc, sc, backend=self.backend,
                                device=self.device,
                                persistent=self.persistent)
                            built.append(registry[name])
                except Exception:
                    # a failed reload keeps the old config
                    # (App.java:543-546); release whatever the partial
                    # build opened
                    for wl in built:
                        try:
                            wl.close(save_snapshot=False)
                        except Exception:
                            logger.exception(
                                "Error closing partially-built workload")
                    raise
                self.config = sc
                self.deduplications = new_dedups
                self.record_linkages = new_linkages
                for wl in old:
                    try:
                        # the snapshot was written above under the locks
                        # and the corpus is unchanged since
                        wl.close(save_snapshot=False)
                    except Exception:
                        logger.exception("Error closing replaced workload")
            finally:
                for wl in old:
                    wl.lock.release()

    def reload_from_string(self, config_string: str) -> None:
        self.apply_config(parse_config(config_string))

    def close(self) -> None:
        """Graceful shutdown: drain the ingest scheduler, then close every
        workload -- each drains its write-behind link flush (leaving an
        EMPTY journal) and saves its corpus snapshot, so a restart finds
        nothing to recover.  Idempotent; a second caller waits for the
        first one's drain."""
        with self._close_lock:
            already, self._closed = self._closed, True
        if already:
            self._close_done.wait()
            return
        try:
            # stop the canary prober before the scheduler drain: its
            # cycles submit through the scheduler this shuts down
            if self.prober is not None:
                self.prober.stop()
            # drain FIRST: queued requests complete against still-open
            # workloads (none is lost), and the dispatcher must be able to
            # take the workload locks this method is about to hold
            if self.scheduler is not None:
                self.scheduler.shutdown()
            # the swap lock waits out a running reload; the registries
            # keep the closed workloads (their counters stay readable)
            with self._swap_lock:
                workloads = self._workloads()
            for wl in workloads:
                with wl.lock:
                    try:
                        wl.close()
                    except Exception:
                        logger.exception("Error closing workload %s",
                                         wl.name)
        finally:
            self._close_done.set()


class _HttpError(Exception):
    def __init__(self, status: int, message: str,
                 content_type: str = "text/plain",
                 extra_headers: Optional[dict] = None):
        self.status = status
        self.message = message
        self.content_type = content_type
        self.extra_headers = dict(extra_headers or {})


class _BusyError(_HttpError):
    """503 from a workload-lock read timeout (the reference's busy reply,
    App.java:718-725) -- its own type so the busy counter counts exactly
    lock-pressure 503s, never e.g. an unready /readyz.  ``retry_after``
    (seconds, from the workload's recent write-hold EWMA) rides a
    ``Retry-After`` header; the reference reply body is unchanged."""

    def __init__(self, kind_label: str, retry_after: Optional[int] = None):
        headers = ({"Retry-After": str(retry_after)}
                   if retry_after is not None else None)
        super().__init__(503, _BUSY_TEMPLATE.format(kind=kind_label),
                         extra_headers=headers)


_ENTITY_PATH = re.compile(
    r"^/(deduplication|recordlinkage)/([^/]*)/([^/]*?)(/httptransform)?$"
)
_FEED_PATH = re.compile(r"^/(deduplication|recordlinkage)/([^/]*)$")
_REMATCH_PATH = re.compile(r"^/(deduplication|recordlinkage)/([^/]+)/rematch$")
_DEBUG_TRACE_PATH = re.compile(r"^/debug/traces/([0-9a-f]{32})$")
_DEBUG_DECISION_PATH = re.compile(r"^/debug/decisions/(d\d+)$")

# the JAX package's route templates for the routes the port serves, so
# both services label those requests alike
_STATIC_ROUTES = frozenset((
    "/", "/config", "/health", "/healthz", "/readyz", "/metrics", "/stats",
    "/debug/traces", "/debug/requests", "/debug/decisions", "/explain",
    "/debug/profile", "/debug/profile/reset",
    "/debug/costs", "/debug/memory", "/debug/slo", "/debug/probes",
))


def _arena_refusal(e: ArenaAdmissionError) -> _HttpError:
    return _HttpError(503, f"HBM budget exhausted: {e}",
                      extra_headers={"Retry-After": "30"})


def _kind_label(kind: str) -> str:
    """User-facing workload-kind label in error bodies (the reference
    camel-cases recordLinkage — App.java:718)."""
    return "deduplication" if kind == "deduplication" else "recordLinkage"


def _route_template(path: str) -> str:
    """Low-cardinality route label for metrics: path parameters collapse
    to placeholders so a hostile/typo'd URL space cannot mint unbounded
    label values."""
    if path in _STATIC_ROUTES:
        return path
    if _DEBUG_TRACE_PATH.match(path):
        return "/debug/traces/:id"
    if _DEBUG_DECISION_PATH.match(path):
        return "/debug/decisions/:id"
    if m := _REMATCH_PATH.match(path):
        return f"/{m.group(1)}/:name/rematch"
    if m := _ENTITY_PATH.match(path):
        suffix = "/httptransform" if m.group(4) else ""
        return f"/{m.group(1)}/:name/:datasetId{suffix}"
    if m := _FEED_PATH.match(path):
        return f"/{m.group(1)}/:name"
    return "(unmatched)"


class DukeRequestHandler(BaseHTTPRequestHandler):
    app: DukeApp = None  # set by serve()
    protocol_version = "HTTP/1.1"

    # per-request instrumentation state (class-level defaults keep _reply
    # safe for any direct caller outside _handle_request)
    _resp_status: Optional[int] = None
    _resp_bytes: int = 0
    request_id: str = "-"
    trace_id: str = "-"

    def log_message(self, fmt, *args):
        logger.info("%s %s", self.address_string(), fmt % args)

    def _handle_request(self, method: str, route_fn) -> None:
        """One instrumented request: request id, root trace span
        (honoring an inbound W3C ``traceparent``), in-flight gauge,
        route/status counters, latency histogram, byte counters, busy-503
        counter.  The registry children lock for nanoseconds per request
        on the handler threads, never on the scoring path.  The root
        span's exit applies the flight recorder's tail latch, so a slow
        request is retained even when head sampling skipped it."""
        parsed = urlparse(self.path)
        route = _route_template(parsed.path)
        self.request_id = new_request_id()
        request_id_var.set(self.request_id)
        self._resp_status = None
        self._resp_bytes = 0
        busy = False
        hm = self.app.http_metrics
        hm.in_flight.inc()
        t0 = time.monotonic()
        with tracing.start_trace(
            f"{method} {route}",
            traceparent=self.headers.get("traceparent"),
            attributes={
                "http.method": method,
                "http.route": route,
                "http.target": parsed.path,
                "request_id": self.request_id,
            },
        ) as root:
            self.trace_id = root.trace_id
            try:
                try:
                    route_fn(parsed)
                except _HttpError as e:
                    busy = isinstance(e, _BusyError)
                    self._reply(e.status, e.message.encode("utf-8"),
                                e.content_type, e.extra_headers or None)
                except Exception:
                    logger.exception("Error serving %s %s", method,
                                     self.path)
                    self._reply(500, b"Internal server error",
                                "text/plain")
            finally:
                status_code = self._resp_status or 0
                root.set_attribute("http.status", status_code)
                if status_code >= 500:
                    root.status = "error"
                hm.in_flight.dec()
                elapsed = time.monotonic() - t0
                status = str(status_code)
                hm.requests.labels(route=route, method=method,
                                   status=status).inc()
                hm.latency.labels(route=route, method=method).observe(
                    elapsed)
                try:
                    req_bytes = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    req_bytes = 0
                if req_bytes > 0:
                    hm.request_bytes.labels(route=route).inc(req_bytes)
                if self._resp_bytes:
                    hm.response_bytes.labels(route=route).inc(
                        self._resp_bytes)
                if busy:
                    hm.busy.labels(route=route).inc()
                request_id_var.set("-")

    def _reply(self, status: int, body: bytes,
               content_type: str = "application/json",
               extra_headers: Optional[dict] = None) -> None:
        self._resp_status = status
        self._resp_bytes += len(body)
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Request-Id", self.request_id)
        self.send_header("X-Trace-Id", self.trace_id)
        # staleness contract during overlapped recovery: every response
        # carries the header while this app's journal replay runs
        if self.app is not None and self.app.recovering():
            self.send_header("X-Recovering", "1")
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            logger.info("Ignoring client disconnect on %s", self.path)

    def send_error(self, code, message=None, explain=None):
        """Stdlib error paths (malformed request line, unsupported method)
        bypass ``_reply``; route them through it so they carry the
        ``X-Request-Id`` / ``X-Trace-Id`` headers too (a fresh request id
        and no trace id: on a keep-alive connection the handler still
        holds the previous request's)."""
        self.request_id = new_request_id()
        self.trace_id = "-"
        try:
            short = message or BaseHTTPRequestHandler.responses.get(
                code, ("Error",))[0]
        except Exception:
            short = "Error"
        self.close_connection = True
        self._reply(code, short.encode("utf-8", errors="replace"),
                    "text/plain", {"Connection": "close"})

    def _read_body(self) -> bytes:
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            # unread body bytes would desync the next keep-alive request
            self.close_connection = True
            raise _HttpError(400, "Invalid Content-Length header")
        if length < 0:
            self.close_connection = True
            raise _HttpError(400, "Invalid Content-Length header")
        limit = _max_request_bytes()
        if length > limit:
            # the unread body would be parsed as the next keep-alive
            # request, so the connection closes with the 413
            self.close_connection = True
            raise _HttpError(
                413,
                f"Request body of {length} bytes exceeds the "
                f"{limit}-byte limit (MAX_REQUEST_BYTES)",
            )
        return self.rfile.read(length) if length else b""

    # -- routing ------------------------------------------------------------

    def do_GET(self):
        self._handle_request("GET", self._route_get)

    def do_POST(self):
        self._handle_request("POST", self._route_post)

    def _route_get(self, parsed) -> None:
        self._read_body()  # drain; unread bytes would corrupt keep-alive
        path = parsed.path
        if path == "/":
            self._reply(200, render_homepage(self.app).encode("utf-8"),
                        "text/html")
        elif path == "/config":
            self._reply(200, self.app.config_string.encode("utf-8"),
                        "application/xml")
        elif path in ("/health", "/healthz"):
            # liveness: still 200 with a latched flush failure (the
            # process IS alive; /readyz is what goes unready), but the
            # exception is reported here
            health = {"status": "ok"}
            flush_errors = self.app.link_flush_errors()
            if flush_errors:
                health["link_flush_errors"] = flush_errors
            # canary verdict mismatches are a correctness incident: the
            # status turns degraded (still 200 -- the process is alive)
            # and names the offending workloads
            prober = self.app.prober
            probe_detail = (prober.health_detail()
                            if prober is not None else None)
            if probe_detail is not None:
                health["status"] = "degraded"
                health["probe_verdict_mismatches"] = probe_detail
            self._reply(200, json.dumps(health).encode("utf-8"))
        elif path == "/readyz":
            self._handle_readyz()
        elif path == "/metrics":
            body = telemetry.render(self.app.metrics, telemetry.GLOBAL)
            self._reply(200, body.encode("utf-8"), telemetry.CONTENT_TYPE)
        elif path == "/stats":
            self._handle_stats()
        elif path == "/debug/traces":
            self._reply(*debug_api.handle_traces())
        elif m := _DEBUG_TRACE_PATH.match(path):
            fmt = (parse_qs(parsed.query).get("format") or ["json"])[0]
            self._reply(*debug_api.handle_trace(m.group(1), fmt))
        elif path == "/debug/requests":
            self._reply(*debug_api.handle_requests())
        elif path == "/debug/decisions":
            self._reply(*debug_api.handle_decisions(self.app))
        elif m := _DEBUG_DECISION_PATH.match(path):
            self._reply(*debug_api.handle_decision(self.app, m.group(1)))
        elif path == "/debug/profile":
            self._reply(*debug_api.handle_profile_status())
        elif path == "/debug/costs":
            self._reply(*debug_api.handle_costs(
                debug_api._app_workloads(self.app)))
        elif path == "/debug/memory":
            self._reply(*debug_api.handle_memory())
        elif path == "/debug/slo":
            self._reply(*debug_api.handle_slo())
        elif path == "/debug/probes":
            self._reply(*debug_api.handle_probes(self.app.prober))
        elif m := _ENTITY_PATH.match(path):
            self._validate_entity_path(m)
            raise _HttpError(405, "This endpoint only supports POST requests.")
        elif m := _FEED_PATH.match(path):
            self._handle_feed(m, parse_qs(parsed.query))
        else:
            raise _HttpError(404, "Not found")

    def _route_post(self, parsed) -> None:
        # read the body up front: replying with it unread would leave its
        # bytes to be parsed as the next keep-alive request
        body = self._read_body()
        path = parsed.path
        if path == "/config":
            self._handle_config_upload(body)
        elif path == "/explain":
            self._reply(*debug_api.handle_explain(self.app, body))
        elif path == "/debug/profile":
            self._reply(*debug_api.handle_profile_start(
                parse_qs(parsed.query)))
        elif path == "/debug/profile/reset":
            self._reply(*debug_api.handle_profile_reset())
        elif m := _REMATCH_PATH.match(path):
            self._handle_rematch(m, body)
        elif m := _ENTITY_PATH.match(path):
            self._handle_post_batch(m, body)
        else:
            raise _HttpError(404, "Not found")

    # -- handlers -----------------------------------------------------------

    def _handle_readyz(self) -> None:
        ready, checks = self.app.readiness()
        http_status = 200 if ready else 503
        if ready:
            status = "ready"
        elif not checks.get("recovery_complete", True):
            # journal replay still running: reads already serve the
            # replayed prefix, so when the replay is the ONLY thing
            # unready /readyz answers 200 (writes 503 per request until
            # write_ready flips); DUKE_RECOVERY_OVERLAP=0 keeps the
            # whole-app 503
            status = "recovering"
            read_ready = all(v for k, v in checks.items()
                             if k not in ("recovery_complete",
                                          "write_ready"))
            if read_ready and env_flag("DUKE_RECOVERY_OVERLAP", True):
                http_status = 200
        else:
            status = "unready"
        body = json.dumps({"status": status, "checks": checks})
        self._reply(http_status, body.encode("utf-8"))

    def _handle_stats(self) -> None:
        """Per-workload counters and corpus sizes, plus the scheduler and
        feed-abort blocks, the audit log's and each workload's decision
        block: lock-free reads of the same single-writer state the
        /metrics collector scrapes."""
        platform, device_count = backend_info(self.app.device)
        out = {
            "backend": self.app.backend,
            "platform": platform,
            "device_count": device_count,
            "uptime_seconds": round(
                time.monotonic() - self.app.started_monotonic, 3),
            "workloads": [],
        }
        from ..ops import feature_cache as FC

        hits, misses, evicted, cache_bytes = FC.stats()
        looked_up = hits + misses
        out["feature_cache"] = {
            "hits": hits,
            "misses": misses,
            "evicted": evicted,
            "bytes": cache_bytes,
            "hit_rate": round(hits / looked_up, 4) if looked_up else None,
        }
        if self.app.scheduler is not None:
            out["scheduler"] = self.app.scheduler.stats_snapshot()
        with self.app._feed_abort_lock:
            out["feed_aborts"] = dict(self.app.feed_aborts)
        # audit-loss visibility: drop-on-overflow is by design, but an
        # operator treating the JSONL as evidence needs to see the loss
        audit = audit_log()
        if audit is not None:
            out["audit_log"] = {
                "path": audit.path,
                "entries": audit.entries,
                "dropped_batches": audit.dropped,
                "disabled": audit.disabled,
            }
        for kind, registry in (
            ("deduplication", self.app.deduplications),
            ("recordlinkage", self.app.record_linkages),
        ):
            for name, wl in list(registry.items()):
                stats = wl.processor.stats
                # live (non-dukeDeleted) indexed records through the O(1)
                # counters the backends keep (device/ann: live_records;
                # host: len(index)) -- lock-free, so ingest never stalls
                # /stats and /stats never stalls ingest
                live = getattr(wl.index, "live_records", None)
                row = {
                    "kind": kind,
                    "name": name,
                    "records_indexed": (
                        live if live is not None else len(wl.index)),
                }
                try:
                    row["links_rows"] = wl.link_database.count()
                except Exception:
                    pass  # closed/raced link DB: omit rather than 500
                row.update(
                    batches=stats.batches,
                    records_processed=stats.records_processed,
                    candidates_retrieved=stats.candidates_retrieved,
                    pairs_compared=stats.pairs_compared,
                    retrieval_seconds=round(stats.retrieval_seconds, 3),
                    compare_seconds=round(stats.compare_seconds, 3),
                )
                if getattr(wl.processor, "finalizer", None) is not None:
                    finalized = stats.pairs_rescored + stats.pairs_skipped
                    row["finalize"] = {
                        "rescored": stats.pairs_rescored,
                        "skipped": stats.pairs_skipped,
                        "skip_rate": (
                            round(stats.pairs_skipped / finalized, 4)
                            if finalized else None),
                    }
                recorder = getattr(wl.processor, "decisions", None)
                if recorder is not None and recorder.enabled:
                    row["decisions"] = {
                        "outcomes": dict(recorder.outcomes),
                        "disagreements": recorder.disagreements,
                        "ring": len(recorder.ring),
                        "latched": recorder.latched,
                    }
                row["phase_seconds"] = {
                    k: round(v, 3)
                    for k, v in wl.processor.phases.phase_seconds().items()
                }
                out["workloads"].append(row)
        self._reply(200, json.dumps(out).encode("utf-8"))

    def _workloads(self, kind: str) -> Dict[str, Workload]:
        return (self.app.deduplications if kind == "deduplication"
                else self.app.record_linkages)

    def _unknown(self, status: int, kind: str, name: str) -> _HttpError:
        label = _kind_label(kind)
        return _HttpError(
            status,
            f"Unknown {label} '{name}'! (All {label}s must be specified in "
            f"the configuration)",
        )

    def _validate_entity_path(self, m) -> Tuple[str, Workload, str, bool]:
        kind, name, dataset_id = m.group(1), m.group(2), m.group(3)
        transform = bool(m.group(4))
        label = _kind_label(kind)
        if not name:
            raise _HttpError(404, f"The {label}Name cannot be an empty string!")
        if not dataset_id:
            raise _HttpError(404, "The datasetId cannot be an empty string!")
        if is_probe_name(name) or is_probe_name(dataset_id):
            # the namespace exclusion: probe shadows are never
            # HTTP-addressable, even by their real names
            raise _HttpError(
                404, "The '__probe__' namespace is reserved for the "
                     "synthetic canary prober.")
        workload = self._workloads(kind).get(name)
        if workload is None:
            raise self._unknown(404, kind, name)
        if dataset_id not in workload.datasources:
            raise _HttpError(
                404, f"Unknown dataset-id '{dataset_id}' for the {label} '{name}'!"
            )
        return kind, workload, dataset_id, transform

    def _handle_post_batch(self, m, body: bytes) -> None:
        try:
            payload = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            raise _HttpError(400, "Request body must be a JSON array or object")
        if isinstance(payload, dict):
            batch, single = [payload], True
        elif isinstance(payload, list):
            batch, single = payload, False
        else:
            raise _HttpError(400, "Request body must be a JSON array or object")
        for entity in batch:
            if not isinstance(entity, dict):
                raise _HttpError(400, "Batch elements must be JSON objects")
        kind, workload, dataset_id, transform = self._validate_entity_path(m)
        if not transform:
            self._check_write_fence(kind, m.group(2), workload)
        sched = self.app.scheduler
        if sched is not None and not transform:
            name, label = m.group(2), _kind_label(kind)
            try:
                sched.submit(kind, name, dataset_id, batch)
            except SchedulerReject as e:
                raise _HttpError(
                    429,
                    f"The {label} '{name}' ingest queue is full "
                    f"({e.depth} requests pending). Please retry after "
                    f"{e.retry_after}s.",
                    extra_headers={"Retry-After": str(e.retry_after)},
                )
            except WorkloadGone:
                raise self._unknown(404, kind, name)
            except DatasetGone as e:
                # a reload replaced the workload with one lacking the
                # dataset after admission validated it
                raise _HttpError(
                    404,
                    f"Unknown dataset-id '{e.dataset_id}' for the "
                    f"{label} '{name}'!",
                )
            except SchedulerClosed:
                raise _HttpError(503, "The service is shutting down.")
            except ArenaAdmissionError as e:
                # the corpus does not fit the device budget even after
                # spilling every other tenant: a loud, actionable 503 --
                # never an allocator OOM
                raise _arena_refusal(e)
            except Exception as e:
                logger.exception("Batch processing failed")
                raise _HttpError(500, f"Batch processing failed: {e}")
            rows = []
        else:
            while True:
                # re-resolve until a live workload accepts the batch: a
                # reload can replace the registry entry between lookup
                # and lock (submit_batch returns None for a closed one)
                try:
                    rows = workload.submit_batch(dataset_id, batch,
                                                 http_transform=transform)
                except ArenaAdmissionError as e:
                    raise _arena_refusal(e)
                except Exception as e:
                    logger.exception("Batch processing failed")
                    raise _HttpError(500, f"Batch processing failed: {e}")
                if rows is not None:
                    break
                if self._shutting_down(kind, m.group(2), workload):
                    raise _HttpError(503, "The service is shutting down.")
                kind, workload, dataset_id, transform = \
                    self._validate_entity_path(m)
        if transform:
            out = rows[0] if single and len(rows) == 1 else rows
            self._reply(200, json.dumps(out).encode("utf-8"))
        else:
            self.app.note_first_batch()
            self._reply(200, b'{"success": true}')

    def _shutting_down(self, kind: str, name: str, workload) -> bool:
        """True when the closed ``workload`` will not be replaced.  A
        reload swaps the registry before it closes the old workload, so a
        closed workload that is still registered means the app is shutting
        down (``close()`` keeps the closed workloads registered)."""
        return (self.app._closed
                or self._workloads(kind).get(name) is workload)

    def _check_write_fence(self, kind: str, name: str, workload) -> None:
        """503 a scoring POST while this workload's link journal replays:
        the write-behind wrapper would fence the write anyway, blocking
        the handler for the whole replay, so the HTTP layer answers fast
        with Retry-After instead.  Reads are unaffected."""
        if getattr(workload.link_database, "recovering", False):
            raise _HttpError(
                503,
                f"The {_kind_label(kind)} '{name}' is replaying its link "
                "journal; writes resume when recovery completes.",
                extra_headers={"Retry-After": "1"},
            )

    def _parse_feed(self, m, query) -> Tuple[str, str, str, int]:
        kind, name = m.group(1), m.group(2)
        label = _kind_label(kind)
        if not name:
            raise _HttpError(400, f"The {label}Name cannot be an empty string!")
        if is_probe_name(name):
            # the feed half of the namespace exclusion: no probe shadow's
            # links are ever served to a ?since= poller
            raise _HttpError(
                400, "The '__probe__' namespace is reserved for the "
                     "synthetic canary prober.")
        since = 0
        since_params = query.get("since")
        if since_params and since_params[0]:
            try:
                since = int(since_params[0])
            except ValueError:
                raise _HttpError(400, f"Invalid since value '{since_params[0]}'")
        return kind, name, label, since

    def _handle_feed(self, m, query) -> None:
        """Stream the incremental link feed in bounded pages.

        Each page (FEED_PAGE_SIZE links) takes the workload lock only for
        the link fetch + record resolution; JSON serialization and the
        socket write happen outside it, and the response is chunked so no
        full materialization exists.  The bytes are the reference's single
        array.  Once the headers are out there is no in-band error
        channel: a removed workload, a lock unavailable past the retry
        deadline or a failure truncates the chunked framing, so the client
        sees a protocol error, never a silently partial feed."""
        kind, name, label, since = self._parse_feed(m, query)
        if self.request_version == "HTTP/1.0":
            # HTTP/1.0 clients don't decode chunked framing: the same
            # bytes, buffered with a Content-Length
            self._handle_feed_buffered(kind, name, label, since)
            return
        page_size = _feed_page_size()
        cursor = since
        t0 = time.monotonic()
        started = False   # headers sent (no error reply possible after)
        first_row = True
        lock_attempts = 0
        lock_deadline: Optional[float] = None
        try:
            while True:
                workload = self._workloads(kind).get(name)
                if workload is None:
                    if started:
                        logger.warning(
                            "Aborting %s feed stream: workload removed "
                            "by config reload mid-stream", name)
                        self.app.count_feed_abort("workload_removed")
                        self.close_connection = True
                        return
                    raise self._unknown(400, kind, name)
                if not workload.lock.acquire(
                        timeout=READ_LOCK_TIMEOUT_SECONDS):
                    if not started:
                        # pre-stream: the reference's 1 s try-then-503
                        raise _BusyError(label, workload.busy_retry_after())
                    # mid-stream contention: retry with exponential
                    # backoff + jitter under a wall-clock deadline
                    now = time.monotonic()
                    if lock_deadline is None:
                        lock_deadline = now + _feed_retry_deadline()
                    lock_attempts += 1
                    if now >= lock_deadline:
                        logger.warning(
                            "Aborting %s feed stream: workload lock "
                            "unavailable past the %.0f s deadline "
                            "(%d attempts)", name, _feed_retry_deadline(),
                            lock_attempts)
                        self.app.count_feed_abort("deadline")
                        self.close_connection = True
                        return
                    time.sleep(min(
                        full_jitter_delay(lock_attempts, _FEED_BACKOFF_BASE_S,
                                          _FEED_BACKOFF_CAP_S),
                        max(0.0, lock_deadline - now)))
                    continue
                lock_attempts = 0
                lock_deadline = None
                try:
                    closed = workload.closed
                    if not closed:
                        rows, cursor = workload.links_page(cursor, page_size)
                finally:
                    workload.lock.release()
                if closed:
                    if not self._shutting_down(kind, name, workload):
                        continue  # replaced by a reload: re-resolve
                    if not started:
                        raise _HttpError(503, "The service is shutting down.")
                    logger.warning("Aborting %s feed stream: the service is "
                                   "shutting down", name)
                    self.app.count_feed_abort("workload_removed")
                    self.close_connection = True
                    return
                if not started:
                    self._resp_status = 200
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.send_header("X-Request-Id", self.request_id)
                    self.send_header("X-Trace-Id", self.trace_id)
                    # staleness signal: the stream is a monotonic PREFIX
                    # of the recovered feed while replay runs
                    if self.app.recovering():
                        self.send_header("X-Recovering", "1")
                    self.end_headers()
                    self._write_chunk(b"[")
                    started = True
                if rows:
                    payload = ",\n".join(json.dumps(r) for r in rows)
                    if not first_row:
                        payload = ",\n" + payload
                    first_row = False
                    self._write_chunk(payload.encode("utf-8"))
                if len(rows) < page_size:
                    break
            # feed SLO signal: backlog walk wall time against
            # DUKE_SLO_FEED_MS; reaching the short page means the feed is
            # caught up, so the lag meter stops aging
            slo.tracker("feed", kind, name).record(time.monotonic() - t0)
            slo.feed_meter(kind, name).note_drain()
            self._write_chunk(b"]")
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            logger.info("Ignoring client disconnect on %s", self.path)
            self.close_connection = True
        except Exception:
            if not started:
                raise  # pre-headers: the generic 500 path still works
            logger.exception("Error mid-stream on %s", self.path)
            self.close_connection = True

    def _write_chunk(self, data: bytes) -> None:
        self._resp_bytes += write_chunk(self.wfile, data)

    def _handle_feed_buffered(self, kind: str, name: str, label: str,
                              since: int) -> None:
        """The feed for HTTP/1.0 clients: one buffered array with a
        Content-Length, holding the lock for the full fetch (the
        reference's behaviour)."""
        t0 = time.monotonic()
        while True:
            workload = self._workloads(kind).get(name)
            if workload is None:
                raise self._unknown(400, kind, name)
            if not workload.lock.acquire(timeout=READ_LOCK_TIMEOUT_SECONDS):
                raise _BusyError(label, workload.busy_retry_after())
            try:
                closed = workload.closed
                if not closed:
                    rows = workload.links_since(since)
            finally:
                workload.lock.release()
            if not closed:
                break
            if self._shutting_down(kind, name, workload):
                raise _HttpError(503, "The service is shutting down.")
        slo.tracker("feed", kind, name).record(time.monotonic() - t0)
        slo.feed_meter(kind, name).note_drain()
        body = "[" + ",\n".join(json.dumps(r) for r in rows) + "]"
        self._reply(200, body.encode("utf-8"))

    def _handle_rematch(self, m, body: bytes) -> None:
        """Bulk corpus-vs-corpus re-match through the ring layout
        (engine.rematch): a link-store backfill or re-population.  A
        dataset literally named 'rematch' still wins the route (ingest
        takes precedence, with the posted batch intact)."""
        kind, name = m.group(1), m.group(2)
        workload = self._workloads(kind).get(name)
        if workload is not None and "rematch" in workload.datasources:
            self._handle_post_batch(
                _ENTITY_PATH.match(f"/{kind}/{name}/rematch"), body)
            return
        label = _kind_label(kind)
        if workload is None:
            raise self._unknown(404, kind, name)
        from ..engine.rematch import ring_rematch

        # bulk re-match writes the link database: the ingest's recovery
        # fence, then the workload lock for the whole pass
        self._check_write_fence(kind, name, workload)
        with workload.lock:
            if workload.closed:
                raise _BusyError(label)
            try:
                stats = ring_rematch(workload)
            except ValueError as e:
                raise _HttpError(400, str(e))
            except ArenaAdmissionError as e:
                # the pass reads the corpus's resident tensors, leased
                # like a scoring POST's: the same 503
                raise _arena_refusal(e)
            except Exception as e:
                logger.exception("ring re-match failed")
                raise _HttpError(500, f"Re-match failed: {e}")
        self._reply(200, json.dumps(stats).encode("utf-8"))

    def _handle_config_upload(self, body: bytes) -> None:
        content_type = self.headers.get("Content-Type", "")
        if content_type.startswith("multipart/form-data"):
            config_string = _extract_multipart_field(content_type, body,
                                                     "configfile")
            if config_string is None:
                raise _HttpError(400, "Missing multipart field 'configfile'")
        else:
            # convenience divergence: accept the raw XML as the body
            config_string = body.decode("utf-8", errors="replace")
        try:
            self.app.reload_from_string(config_string)
        except ConfigError as e:
            raise _HttpError(400, f"Invalid configuration: {e}")
        except Exception as e:
            logger.exception("Config reload failed")
            raise _HttpError(500, f"Config reload failed: {e}")
        # success: redirect to the homepage (App.java:682)
        self._reply(302, b"ok", "text/plain", {"Location": "/"})


def _extract_multipart_field(content_type: str, body: bytes,
                             field: str) -> Optional[str]:
    """Minimal multipart/form-data parsing via the stdlib email parser."""
    message = BytesParser(policy=email_policy).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1") + b"\r\n\r\n" + body
    )
    if not message.is_multipart():
        return None
    for part in message.iter_parts():
        if part.get_param("name", header="content-disposition") == field:
            payload = part.get_payload(decode=True)
            return payload.decode("utf-8", errors="replace")
    return None


def install_shutdown_handlers(app: DukeApp, server) -> None:
    """SIGTERM/SIGINT graceful shutdown: stop accepting, flush the
    write-behind link batches, save corpus snapshots, close -- so a
    restart finds an empty journal and a warm snapshot.  The handler only
    spawns the shutdown thread (signal context must not block on workload
    locks); a second signal is a no-op (``close`` is idempotent), not an
    escalation -- a hard kill is what the journal exists for."""
    import signal

    def _shutdown(signum, frame):
        logger.info("signal %d: graceful shutdown (drain -> flush -> "
                    "snapshot -> close)", signum)

        def _run():
            server.shutdown()  # stop accepting; in-flight requests finish
            app.close()

        threading.Thread(target=_run, daemon=True,
                         name="graceful-shutdown").start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)


def create_app(config: Optional[ServiceConfig] = None, *,
               backend: str = "device", device="cuda",
               persistent: bool = True) -> DukeApp:
    """The app for ``config`` (default: ``CONFIG_STRING`` from the
    environment, else the bundled demo config)."""
    if config is None:
        config = load_default_config()
    return DukeApp(config, backend=backend, device=device,
                   persistent=persistent)


def serve(app: DukeApp, port: int = DEFAULT_PORT,
          host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Bind an HTTP server for ``app``; the caller runs ``serve_forever``."""
    handler = type("BoundHandler", (DukeRequestHandler,), {"app": app})
    return ThreadingHTTPServer((host, port), handler)
