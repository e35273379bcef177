"""Follower-side HTTP read plane of a serving group.

Counterpart of the JAX package's ``service/replica_plane.py``.  The
reference funnels every ``?since=`` poll through the one process that
owns the link DB (App.java:742,843); a serving group's followers
(``parallel/dispatch.py``) serve the read-dominant surface from their
REPLICA state instead:

  * ``GET /{kind}/{name}?since=N`` -- the incremental link feed, from the
    replica link DB with link endpoints resolved through the replica
    corpus mirror.  Rows materialize through the SAME
    ``links.replica.feed_row`` the leader uses, so a replica page is
    bit-identical to the leader's at the same watermark.  **No leader
    lock is ever taken.**
  * ``GET /healthz`` / ``/readyz`` -- liveness and readiness
    (bootstrapped replicas present), both reporting replication lag.
  * ``GET /stats`` -- per-workload watermark, lag and row counts.
  * ``GET /metrics`` -- the process-global telemetry registry, with the
    ``duke_replica_lag_ops`` gauge refreshed at scrape time from the
    replica watermarks (the replay path never writes a registry child).
  * the process-level ``/debug`` reads (traces, requests, profile,
    costs, memory, slo) and ``POST /debug/profile``.

Staleness contract: reads are **bounded-staleness** -- a replica serves
whatever its applied watermark covers and stamps every feed response with
``X-Replica-Lag: <ops>`` (link-stream batches seen but not yet applied),
so a consumer that needs read-your-writes polls the leader instead.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .. import telemetry
from ..links.replica import links_feed_page
from ..telemetry import tracing
from . import debug as debug_api
from .app import (
    _DEBUG_TRACE_PATH,
    _FEED_PATH,
    _feed_page_size,
    _kind_label,
    write_chunk,
)

logger = logging.getLogger("replica-plane")


class ReplicaReadHandler(BaseHTTPRequestHandler):
    session = None  # the follower's _FollowerSession; set by serve()
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        logger.info("%s %s", self.address_string(), fmt % args)

    def _reply(self, status: int, body: bytes,
               content_type: str = "application/json",
               extra_headers=None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            logger.info("Ignoring client disconnect on %s", self.path)

    def _reply_json(self, status: int, obj, extra_headers=None) -> None:
        self._reply(status, json.dumps(obj).encode("utf-8"),
                    extra_headers=extra_headers)

    # -- lag bookkeeping -----------------------------------------------------

    def _lag_snapshot(self):
        """{(kind, name): lag_ops} plus the scrape-time gauge refresh."""
        out = {}
        for key, db in list(self.session.link_replicas.items()):
            lag = db.lag_ops()
            out[key] = lag
            telemetry.REPLICA_LAG.labels(kind=key[0], workload=key[1]).set(lag)
        # the follower's adopted epoch (the leader sets this gauge from
        # Dispatcher.start/promotion; on a follower the session is the
        # authority)
        telemetry.DISPATCH_EPOCH.set(self.session.epoch)
        return out

    # -- routes --------------------------------------------------------------

    def do_GET(self):
        try:
            parsed = urlparse(self.path)
            # root span per request: the leader's W3C propagation, so
            # /debug/requests and /debug/traces work on a replica too
            with tracing.start_trace(
                f"GET {parsed.path}",
                traceparent=self.headers.get("traceparent"),
                attributes={"http.method": "GET",
                            "http.target": parsed.path},
            ):
                self._route(parsed)
        except Exception:
            logger.exception("replica plane: error serving %s", self.path)
            self._reply(500, b"Internal server error", "text/plain")

    def _route(self, parsed) -> None:
        path = parsed.path
        if path in ("/health", "/healthz"):
            lags = self._lag_snapshot()
            self._reply_json(200, {
                "status": "ok",
                "role": "replica",
                "epoch": self.session.epoch,
                "replication_lag_ops": sum(lags.values()),
                "stale_ops_rejected": self.session.stale_rejected,
            })
        elif path == "/readyz":
            ready = bool(self.session.replicas)
            self._reply_json(200 if ready else 503, {
                "status": "ready" if ready else "unready",
                "checks": {"replicas_bootstrapped": ready},
            })
        elif path == "/metrics":
            self._lag_snapshot()  # refresh the lag gauge children
            body = telemetry.render(telemetry.GLOBAL).encode("utf-8")
            self._reply(200, body, telemetry.CONTENT_TYPE)
        elif path == "/stats":
            self._handle_stats()
        elif path == "/debug/traces":
            self._reply(*debug_api.handle_traces())
        elif m := _DEBUG_TRACE_PATH.match(path):
            fmt = (parse_qs(parsed.query).get("format") or ["json"])[0]
            self._reply(*debug_api.handle_trace(m.group(1), fmt))
        elif path == "/debug/requests":
            self._reply(*debug_api.handle_requests())
        elif path == "/debug/profile":
            self._reply(*debug_api.handle_profile_status())
        elif path == "/debug/costs":
            # a replica runs no workload processors of its own: the
            # process-level ledger with zero attributed seconds
            self._reply(*debug_api.handle_costs())
        elif path == "/debug/memory":
            self._reply(*debug_api.handle_memory())
        elif path == "/debug/slo":
            self._reply(*debug_api.handle_slo())
        elif m := _FEED_PATH.match(path):
            self._handle_feed(m, parse_qs(parsed.query))
        else:
            self._reply(404, b"Not found (replica read plane serves "
                        b"feeds, /stats, /metrics, /debug/traces, "
                        b"/debug/requests, /debug/profile, /debug/costs, "
                        b"/debug/memory, /debug/slo and health probes)",
                        "text/plain")

    def do_POST(self):
        try:
            parsed = urlparse(self.path)
            with tracing.start_trace(
                f"POST {parsed.path}",
                traceparent=self.headers.get("traceparent"),
                attributes={"http.method": "POST",
                            "http.target": parsed.path},
            ):
                self._route_post(parsed)
        except Exception:
            logger.exception("replica plane: error serving %s", self.path)
            self._reply(500, b"Internal server error", "text/plain")

    def _route_post(self, parsed) -> None:
        # drain any body so keep-alive framing survives the reply
        length = int(self.headers.get("Content-Length") or 0)
        if length:
            self.rfile.read(length)
        path = parsed.path
        if path == "/debug/profile":
            # a replicated deployment can capture a device trace through
            # any plane's front door; the owner tag makes a cross-plane
            # 409 say who holds the profiler
            self._reply(*debug_api.handle_profile_start(
                parse_qs(parsed.query), owner="replica"))
        elif path == "/debug/profile/reset":
            self._reply(*debug_api.handle_profile_reset())
        else:
            self._reply(404, b"Not found (replica read plane accepts "
                        b"POST /debug/profile and "
                        b"POST /debug/profile/reset)", "text/plain")

    def _handle_stats(self) -> None:
        lags = self._lag_snapshot()
        workloads = []
        for key, replica in list(self.session.replicas.items()):
            kind, name = key
            db = self.session.link_replicas.get(key)
            row = {
                "kind": kind,
                "name": name,
                "records_indexed": replica.index.corpus.size
                if getattr(replica.index, "corpus", None) is not None
                else len(replica.index),
            }
            if db is not None:
                row.update(
                    links_rows=db.count(),
                    applied_seq=db.applied_seq,
                    head_seq=db.head_seq,
                    lag_ops=lags.get(key, 0),
                )
            workloads.append(row)
        self._reply_json(200, {
            "role": "replica",
            "epoch": self.session.epoch,
            "follower_idx": self.session.follower_idx,
            "stale_ops_rejected": self.session.stale_rejected,
            "workloads": workloads,
        })

    def _handle_feed(self, m, query) -> None:
        kind, name = m.group(1), m.group(2)
        label = _kind_label(kind)
        if not name:
            self._reply(400, f"The {label}Name cannot be an empty string!"
                        .encode(), "text/plain")
            return
        key = (kind, name)
        replica = self.session.replicas.get(key)
        db = self.session.link_replicas.get(key)
        if replica is None or db is None:
            self._reply(
                400,
                (f"Unknown {label} '{name}'! (All {label}s must be "
                 f"specified in the configuration)").encode(),
                "text/plain",
            )
            return
        since = 0
        since_params = query.get("since")
        if since_params and since_params[0]:
            try:
                since = int(since_params[0])
            except ValueError:
                self._reply(400, f"Invalid since value '{since_params[0]}'"
                            .encode(), "text/plain")
                return
        # bounded-staleness read, STREAMED in bounded pages (the leader's
        # own discipline, same FEED_PAGE_SIZE knob): a multi-million-row
        # backlog never materializes in replica memory either.  Lag is
        # computed once at response start — the header describes the
        # watermark the page walk began at.  No registry write here: the
        # feed path stays metric-free (the lag gauge refreshes at scrape
        # time, _lag_snapshot).
        lag = db.lag_ops()
        page_size = _feed_page_size()
        if self.request_version == "HTTP/1.0":
            # no chunked framing pre-1.1: buffered single array
            rows, cursor = [], since
            while True:
                page, cursor = links_feed_page(db, replica.index, cursor,
                                               page_size)
                rows.extend(page)
                if len(page) < page_size:
                    break
            body = "[" + ",\n".join(json.dumps(r) for r in rows) + "]"
            self._reply(200, body.encode("utf-8"),
                        extra_headers={"X-Replica-Lag": str(lag)})
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("X-Replica-Lag", str(lag))
        self.end_headers()
        try:
            self._write_chunk(b"[")
            first = True
            cursor = since
            while True:
                page, cursor = links_feed_page(db, replica.index, cursor,
                                               page_size)
                if page:
                    payload = ",\n".join(json.dumps(r) for r in page)
                    if not first:
                        payload = ",\n" + payload
                    first = False
                    self._write_chunk(payload.encode("utf-8"))
                if len(page) < page_size:
                    break
            self._write_chunk(b"]")
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            logger.info("Ignoring client disconnect on %s", self.path)
            self.close_connection = True
        except Exception:
            # headers + chunks are on the wire: a second status line
            # (the do_GET 500 path) would land mid-chunked-body as
            # garbage framing.  Truncate instead — the client sees a
            # protocol error, never silent partial success (the leader
            # feed's own mid-stream stance).
            logger.exception("replica feed failed mid-stream on %s",
                             self.path)
            self.close_connection = True

    def _write_chunk(self, data: bytes) -> None:
        write_chunk(self.wfile, data)


def serve_replica_plane(session, port: int,
                        host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Bind the replica read plane for ``session`` and serve it on a
    daemon thread; returns the server (caller owns ``shutdown()``)."""
    handler = type("BoundReplicaHandler", (ReplicaReadHandler,),
                   {"session": session})
    server = ThreadingHTTPServer((host, port), handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="replica-read-plane", daemon=True)
    thread.start()
    logger.info("replica read plane serving on %s:%d", host,
                server.server_address[1])
    return server
