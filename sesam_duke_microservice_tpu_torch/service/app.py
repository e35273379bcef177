"""The HTTP frontend: the reference REST surface for the device backend.

Counterpart of the JAX package's ``service/app.py`` reduced to the
matching routes (App.java:649-887) on the stdlib threading HTTP server:

    POST /deduplication/:name/:datasetId                  ingest+match
    POST /deduplication/:name/:datasetId/httptransform    transform
    GET  /deduplication/:name/:datasetId[/httptransform]  405 after validation
    GET  /deduplication/:name?since=N                     incremental feed
    (same shapes under /recordlinkage)

Writers take the workload lock unconditionally; feed readers try for 1 s
and answer 503 with the reference's message.  A POST body may be a JSON
array or one object (a single-entity transform answers one object).
Unknown names 404 on entity endpoints and 400 on feeds.
"""

from __future__ import annotations

import json
import logging
import re
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..core.config import ServiceConfig, load_default_config
from ..engine.workload import Workload, build_workload, resolve_device

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
    """Application state: the parsed config and its live workloads, each
    scoring on the torch ``device`` (``cuda`` unless the caller asks for
    ``cpu``)."""

    def __init__(self, config: ServiceConfig, *, device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.deduplications: Dict[str, Workload] = {
            name: build_workload(wc, config, device=self.device)
            for name, wc in config.deduplications.items()
        }
        self.record_linkages: Dict[str, Workload] = {
            name: build_workload(wc, config, device=self.device)
            for name, wc in config.record_linkages.items()
        }

    def close(self) -> None:
        for wl in (list(self.deduplications.values())
                   + list(self.record_linkages.values())):
            with wl.lock:
                wl.close()


class _HttpError(Exception):
    def __init__(self, status: int, message: str):
        self.status = status
        self.message = message


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
               content_type: str = "application/json") -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            logger.info("Ignoring client disconnect on %s", self.path)

    def _handle(self, route_fn) -> None:
        try:
            route_fn(urlparse(self.path))
        except _HttpError as e:
            self._reply(e.status, e.message.encode("utf-8"), "text/plain")
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
        _, workload, dataset_id, transform = self._validate_entity_path(m)
        try:
            with workload.lock:
                rows = workload.process_batch(dataset_id, batch,
                                              http_transform=transform)
        except Exception as e:
            logger.exception("Batch processing failed")
            raise _HttpError(500, f"Batch processing failed: {e}")
        if transform:
            out = rows[0] if single and len(rows) == 1 else rows
            self._reply(200, json.dumps(out).encode("utf-8"))
        else:
            self._reply(200, b'{"success": true}')

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
            raise _HttpError(503, _BUSY_TEMPLATE.format(kind=label))
        try:
            rows = workload.links_since(since)
        finally:
            workload.lock.release()
        body = "[" + ",\n".join(json.dumps(r) for r in rows) + "]"
        self._reply(200, body.encode("utf-8"))


def create_app(config: Optional[ServiceConfig] = None, *,
               device="cuda") -> DukeApp:
    """The app for ``config`` (default: ``CONFIG_STRING`` from the
    environment, else the bundled demo config)."""
    if config is None:
        config = load_default_config()
    return DukeApp(config, device=device)


def serve(app: DukeApp, port: int = DEFAULT_PORT,
          host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Bind an HTTP server for ``app``; the caller runs ``serve_forever``."""
    handler = type("BoundHandler", (DukeRequestHandler,), {"app": app})
    return ThreadingHTTPServer((host, port), handler)
