"""The HTTP frontend: the reference REST surface for the port's backends.

Counterpart of the JAX package's ``service/app.py`` reduced to the
matching routes (App.java:649-887) on the stdlib threading HTTP server:

    POST /deduplication/:name/:datasetId                  ingest+match
    POST /deduplication/:name/:datasetId/httptransform    transform
    GET  /deduplication/:name/:datasetId[/httptransform]  405 after validation
    GET  /deduplication/:name?since=N                     incremental feed
    (same shapes under /recordlinkage)

A scoring POST goes through the ingest scheduler
(``engine.scheduler.IngestScheduler``, on unless ``DUKE_SCHEDULER=0``):
it queues per workload, coalesces concurrent POSTs into microbatches that
one dispatcher thread runs through ``Workload._run_merged``, and answers a
full queue with 429 and ``Retry-After``.  With the scheduler off the POST
goes through ``Workload.submit_batch`` (the lock-winner merge).
Transforms take the workload lock directly.  Feed readers try for 1 s and
answer 503 with the reference's message and a ``Retry-After`` from the
recent write holds.  A POST body may be a JSON array or one object (a
single-entity transform answers one object).  Unknown names 404 on entity
endpoints and 400 on feeds.

While a workload's link journal replays after a crash (overlapped
recovery), every response carries ``X-Recovering: 1`` and a scoring POST
to that workload answers 503 with ``Retry-After: 1``; feeds serve the
replayed prefix.  ``install_shutdown_handlers`` turns SIGTERM/SIGINT into
a graceful ``DukeApp.close()``: drain, flush, snapshot.
"""

from __future__ import annotations

import json
import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..core.config import ServiceConfig, load_default_config
from ..engine.scheduler import (
    DatasetGone,
    IngestScheduler,
    SchedulerClosed,
    SchedulerReject,
    WorkloadGone,
    scheduler_enabled,
)
from ..engine.workload import Workload, build_workload, resolve_device
from ..links import journal as link_journal

logger = logging.getLogger("duke-torch-service")

DEFAULT_PORT = 4567  # the reference's Spark default

READ_LOCK_TIMEOUT_SECONDS = 1.0
_BUSY_TEMPLATE = (
    "The {kind} is being written to, so reading is not currently possible. "
    "Please wait a bit and try again later."
)

_ENTITY_PATH = re.compile(
    r"^/(deduplication|recordlinkage)/([^/]*)/([^/]*?)(/httptransform)?$"
)
_FEED_PATH = re.compile(r"^/(deduplication|recordlinkage)/([^/]*)$")


class DukeApp:
    """Application state: the parsed config, its live workloads and the
    ingest scheduler.  Each workload scores with ``backend`` (``device``
    brute force unless the caller asks for ``ann`` or ``host``) on the
    torch ``device`` (``cuda`` unless the caller asks for ``cpu``; the
    ``host`` backend runs no device code and leaves ``device`` None).
    ``persistent`` (the default) keeps each workload's state in its data
    folder and restarts from it; ``persistent=False`` keeps everything in
    memory."""

    def __init__(self, config: ServiceConfig, *, backend: str = "device",
                 device="cuda", persistent: bool = True):
        self.device = None if backend == "host" else resolve_device(device)
        self.backend = backend
        self.persistent = persistent
        self.config = config
        # close() runs from the signal-driven shutdown thread AND the
        # CLI's finally: one caller drains, every other caller waits for
        # it (the CLI's exit must not cut a drain or snapshot short)
        self._close_lock = threading.Lock()
        self._closed = False  # guarded by: self._close_lock [writes]
        self._close_done = threading.Event()
        self.deduplications: Dict[str, Workload] = {}
        self.record_linkages: Dict[str, Workload] = {}
        self.scheduler: Optional[IngestScheduler] = None
        try:
            for name, wc in config.deduplications.items():
                self.deduplications[name] = build_workload(
                    wc, config, backend=backend, device=self.device,
                    persistent=persistent)
            for name, wc in config.record_linkages.items():
                self.record_linkages[name] = build_workload(
                    wc, config, backend=backend, device=self.device,
                    persistent=persistent)
            # queues are keyed by (kind, name) and dispatch re-resolves
            # from the registries; DUKE_SCHEDULER=0 leaves POSTs to
            # Workload.submit_batch
            if scheduler_enabled():
                self.scheduler = IngestScheduler(self._resolve_workload)
        except BaseException:
            self.close()
            raise

    def _resolve_workload(self, kind: str, name: str) -> Optional[Workload]:
        registry = (self.deduplications if kind == "deduplication"
                    else self.record_linkages)
        return registry.get(name)

    def _workloads(self):
        return (list(self.deduplications.values())
                + list(self.record_linkages.values()))

    def recovering(self) -> bool:
        """Whether any of this app's workloads is still replaying its
        link journal (one process-wide check while nothing replays)."""
        if not link_journal.recovery_active(None):
            return False
        folders = [wl.config.data_folder for wl in self._workloads()
                   if wl.config.data_folder]
        if not folders:
            return link_journal.recovery_active("")
        return any(link_journal.recovery_active(f) for f in folders)

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
            # drain FIRST: queued requests complete against still-open
            # workloads (none is lost), and the dispatcher must be able to
            # take the workload locks this method is about to hold
            if self.scheduler is not None:
                self.scheduler.shutdown()
            for wl in self._workloads():
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
                 extra_headers: Optional[dict] = None):
        self.status = status
        self.message = message
        self.extra_headers = dict(extra_headers or {})


def _kind_label(kind: str) -> str:
    """User-facing workload-kind label in error bodies (the reference
    camel-cases recordLinkage — App.java:718)."""
    return "deduplication" if kind == "deduplication" else "recordLinkage"


class DukeRequestHandler(BaseHTTPRequestHandler):
    app: DukeApp = None  # set by serve()
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        logger.info("%s %s", self.address_string(), fmt % args)

    def _reply(self, status: int, body: bytes,
               content_type: str = "application/json",
               extra_headers: Optional[dict] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
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

    def _handle(self, route_fn) -> None:
        try:
            route_fn(urlparse(self.path))
        except _HttpError as e:
            self._reply(e.status, e.message.encode("utf-8"), "text/plain",
                        e.extra_headers)
        except Exception as e:  # noqa: BLE001 - surfaced as a 500
            logger.exception("Request failed")
            self._reply(500, f"Internal error: {e}".encode("utf-8"),
                        "text/plain")

    def _read_body(self) -> bytes:
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            self.close_connection = True
            raise _HttpError(400, "Invalid Content-Length header")
        if length < 0:
            self.close_connection = True
            raise _HttpError(400, "Invalid Content-Length header")
        return self.rfile.read(length) if length else b""

    def do_GET(self):
        self._handle(self._route_get)

    def do_POST(self):
        self._handle(self._route_post)

    def _route_get(self, parsed) -> None:
        self._read_body()  # drain; unread bytes would corrupt keep-alive
        if m := _ENTITY_PATH.match(parsed.path):
            self._validate_entity_path(m)
            raise _HttpError(405, "This endpoint only supports POST requests.")
        if m := _FEED_PATH.match(parsed.path):
            self._handle_feed(m, parse_qs(parsed.query))
            return
        raise _HttpError(404, "Not found")

    def _route_post(self, parsed) -> None:
        body = self._read_body()
        if m := _ENTITY_PATH.match(parsed.path):
            self._handle_post_batch(m, body)
            return
        raise _HttpError(404, "Not found")

    def _workloads(self, kind: str) -> Dict[str, Workload]:
        return (self.app.deduplications if kind == "deduplication"
                else self.app.record_linkages)

    def _validate_entity_path(self, m) -> Tuple[str, Workload, str, bool]:
        kind, name, dataset_id = m.group(1), m.group(2), m.group(3)
        transform = bool(m.group(4))
        label = _kind_label(kind)
        if not name:
            raise _HttpError(404, f"The {label}Name cannot be an empty string!")
        if not dataset_id:
            raise _HttpError(404, "The datasetId cannot be an empty string!")
        workload = self._workloads(kind).get(name)
        if workload is None:
            raise _HttpError(
                404,
                f"Unknown {label} '{name}'! (All {label}s must be specified in "
                f"the configuration)",
            )
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
                raise _HttpError(
                    404,
                    f"Unknown {label} '{name}'! (All {label}s must be "
                    f"specified in the configuration)",
                )
            except DatasetGone as e:
                raise _HttpError(
                    404,
                    f"Unknown dataset-id '{e.dataset_id}' for the "
                    f"{label} '{name}'!",
                )
            except SchedulerClosed:
                raise _HttpError(503, "The service is shutting down.")
            except Exception as e:
                logger.exception("Batch processing failed")
                raise _HttpError(500, f"Batch processing failed: {e}")
            rows = []
        else:
            try:
                rows = workload.submit_batch(dataset_id, batch,
                                             http_transform=transform)
            except Exception as e:
                logger.exception("Batch processing failed")
                raise _HttpError(500, f"Batch processing failed: {e}")
            if rows is None:
                # the port replaces no workload while serving: a closed
                # one means the app is shutting down
                raise _HttpError(503, "The service is shutting down.")
        if transform:
            out = rows[0] if single and len(rows) == 1 else rows
            self._reply(200, json.dumps(out).encode("utf-8"))
        else:
            self._reply(200, b'{"success": true}')

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

    def _handle_feed(self, m, query) -> None:
        kind, name = m.group(1), m.group(2)
        label = _kind_label(kind)
        if not name:
            raise _HttpError(400, f"The {label}Name cannot be an empty string!")
        since = 0
        since_params = query.get("since")
        if since_params and since_params[0]:
            try:
                since = int(since_params[0])
            except ValueError:
                raise _HttpError(400, f"Invalid since value '{since_params[0]}'")
        workload = self._workloads(kind).get(name)
        if workload is None:
            raise _HttpError(
                400,
                f"Unknown {label} '{name}'! (All {label}s must be specified in "
                f"the configuration)",
            )
        if not workload.lock.acquire(timeout=READ_LOCK_TIMEOUT_SECONDS):
            raise _HttpError(
                503, _BUSY_TEMPLATE.format(kind=label),
                extra_headers={
                    "Retry-After": str(workload.busy_retry_after())})
        try:
            rows = workload.links_since(since)
        finally:
            workload.lock.release()
        body = "[" + ",\n".join(json.dumps(r) for r in rows) + "]"
        self._reply(200, body.encode("utf-8"))


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
