"""Federation HTTP frontend (the JAX package's ``service/federation_plane.py``
on torch).

The single-group service (``service/app.py``) serves one workload stack;
this plane serves a ``federation.Federation`` -- N serving groups behind
the digest-range partition router:

  * ``POST /{kind}/{name}/{datasetId}`` -- federated ingest: the batch
    partitions by owner group and fans out.  Frozen ranges (a live
    migration) answer 429 + Retry-After for the whole batch; a scatter
    partial failure answers 503 with the degraded-range list in the
    error body and Retry-After = the max across contacted groups
    (backpressure propagates through the router).
  * ``GET /{kind}/{name}?since=<token>`` -- the merged federated feed.
    ``since`` is the OPAQUE composite cursor (``federation.ranges``
    encode/decode; a bare integer is accepted as the legacy pre-
    federation cursor).  One bounded page per request: the next token
    rides ``X-Fed-Next-Since`` and ``X-Fed-Drained: true`` marks the
    end of the backlog -- clients poll, they do not stream.  With a dead
    group, live ranges' rows still flow; the dead ranges are listed in
    ``X-Fed-Degraded-Ranges`` with a Retry-After hint, and their
    cursors in the returned token are untouched, so the client resumes
    them loss-free once the group returns.
  * ``POST /federation/migrate`` (``{"range": id, "target": group}``) --
    live range rebalancing (federation/migrate.py); ``GET
    /federation/map`` and ``GET /federation/migration`` expose the
    partition map and migration status.
  * ``/healthz`` / ``/readyz`` / ``/stats`` / ``/metrics`` -- health with
    per-group detail; ``/readyz`` answers ``recovering`` while ANY
    group's journal replay runs (scoped: other processes' groups do not
    leak in) and ``degraded`` when a group is down.

``duke_fed_*`` metric families (scrape-time snapshots -- the router hot
path writes plain counters under its own lock, never a registry child):
``duke_fed_groups``, ``duke_fed_group_up``,
``duke_fed_group_seconds_since_contact``, ``duke_fed_degraded_ranges``,
``duke_fed_migration_phase``, ``duke_fed_migrations_total``,
``duke_fed_requests_total``, and per-range scatter series
``duke_fed_range_requests_total`` / ``duke_fed_range_latency_seconds``.

Observability plane: every request opens a W3C-propagating
root span (inbound ``traceparent`` honored, ``X-Request-Id`` /
``X-Trace-Id`` reply headers), ``/debug/traces`` + ``/debug/requests``
serve the plane's flight recorder -- a retained federated ingest shows
the plane root, the router's partition/fan-out/merge spans AND each
group's re-anchored engine subtree as one causal tree --
``/debug/migrations`` returns the migrator's retained phase-timeline
ring, and ``/metrics`` additionally renders the fleet rollup: every
group's registry merged through ``telemetry.rollup.GroupRollup``
(counters/histograms summed, gauges relabeled ``group=``).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .. import telemetry
from ..federation import Federation
from ..federation.migrate import PHASE_CODES
from ..federation.ranges import BadCursor, StaleRouterEpoch
from ..federation.router import (
    FrozenRange,
    PartialIngestFailure,
    UnknownFederatedWorkload,
)
from ..telemetry import FamilySnapshot, MetricRegistry, heat, slo, tracing
from ..telemetry.logctx import new_request_id, request_id_var
from ..telemetry.probes import probes_enabled
from ..telemetry.registry import DEFAULT_LATENCY_BUCKETS, histogram_snapshot
from ..telemetry.rollup import GroupRollup
from . import debug as debug_api
from .app import (
    _DEBUG_TRACE_PATH,
    _ENTITY_PATH,
    _FEED_PATH,
    _feed_page_size,
    _kind_label,
)
from .metrics import make_group_collector

logger = logging.getLogger("federation-plane")


def make_federation_collector(fed: Federation):
    """Scrape-time ``duke_fed_*`` families off the router's and
    migrator's plain single-writer counters."""

    def collect():
        router = fed.router
        health = router.group_health()
        degraded = router.degraded_range_ids()
        now = time.monotonic()
        up_samples = []
        contact_samples = []
        for row in health:
            labels = (("group", str(row["group"])),)
            up_samples.append(("", labels, 1.0 if row["up"] else 0.0))
            last = router.last_contact(row["group"])
            contact_samples.append(
                ("", labels, round(now - last, 3) if last else -1.0))
        outcomes = router.outcomes_snapshot()
        range_req_samples = []
        range_lat_samples = []
        for rid, (by_outcome, hist) in sorted(
                router.range_stats_snapshot().items()):
            for outcome, n in sorted(by_outcome.items()):
                range_req_samples.append(
                    ("", (("range", rid), ("outcome", outcome)), float(n)))
            counts, total, count = hist
            range_lat_samples.extend(histogram_snapshot(
                DEFAULT_LATENCY_BUCKETS, counts, total, count,
                (("range", rid),)))
        return [
            FamilySnapshot(
                "duke_fed_groups", "gauge",
                "Serving groups in the federation",
                [("", (), float(len(fed.groups)))]),
            FamilySnapshot(
                "duke_fed_group_up", "gauge",
                "1 while the group's last scatter contact succeeded "
                "(0 = its ranges are degraded)", up_samples),
            FamilySnapshot(
                "duke_fed_group_seconds_since_contact", "gauge",
                "Seconds since the router last reached the group "
                "(-1 = never contacted): replication-style lag for the "
                "scatter plane", contact_samples),
            FamilySnapshot(
                "duke_fed_degraded_ranges", "gauge",
                "Digest ranges currently owned by an unreachable group "
                "(their queries 503 with Retry-After; the rest serve)",
                [("", (), float(len(degraded)))]),
            FamilySnapshot(
                "duke_fed_migration_phase", "gauge",
                "Live range-migration phase (0 idle, 1 frozen, 2 "
                "copied, 3 cutover, 4 drain)",
                [("", (), float(fed.migrator.phase_code()))]),
            FamilySnapshot(
                "duke_fed_migrations_total", "counter",
                "Range migrations by outcome (completed, resumed after "
                "a crash, failed)",
                [("", (("outcome", k),), float(v))
                 for k, v in sorted(fed.migrator.outcomes.items())]),
            FamilySnapshot(
                "duke_fed_requests_total", "counter",
                "Federated router requests by outcome (ok, degraded = "
                "scatter partial failure, frozen = 429 on a migrating "
                "range)",
                [("", (("outcome", k),), float(v))
                 for k, v in sorted(outcomes.items())]),
            FamilySnapshot(
                "duke_fed_range_requests_total", "counter",
                "Scatter calls that touched the range, by per-group "
                "outcome (ok, retried = ok after transient retries, "
                "degraded = group unreachable, stale-epoch = fenced by "
                "a concurrent cutover)", range_req_samples),
            FamilySnapshot(
                "duke_fed_range_latency_seconds", "histogram",
                "Per-range scatter-call latency (group call including "
                "router-side retries)", range_lat_samples),
            # sub-range heat rollup: 256-bucket load
            # histogram per owned range, non-zero buckets only
            heat.collect_family(router.heat),
        ]

    return collect


_FED_STATIC_ROUTES = frozenset((
    "/health", "/healthz", "/readyz", "/stats", "/metrics",
    "/federation/map", "/federation/migration", "/federation/migrate",
    "/debug/traces", "/debug/requests", "/debug/migrations",
    "/debug/profile", "/debug/profile/reset",
    "/debug/costs", "/debug/memory", "/debug/loadmap", "/debug/slo",
    "/debug/probes",
))


def _fed_route_template(path: str) -> str:
    """Low-cardinality route label for span names (same collapse rules
    as the group plane's ``_route_template``)."""
    if path in _FED_STATIC_ROUTES:
        return path
    if _DEBUG_TRACE_PATH.match(path):
        return "/debug/traces/:id"
    if m := _ENTITY_PATH.match(path):
        suffix = "/httptransform" if m.group(4) else ""
        return f"/{m.group(1)}:name/:datasetId{suffix}"
    if m := _FEED_PATH.match(path):
        return f"/{m.group(1)}:name"
    return "<unmatched>"


class FederationHandler(BaseHTTPRequestHandler):
    fed: Federation = None  # set by serve_federation()
    registry: MetricRegistry = None
    rollup: GroupRollup = None
    range_prober = None  # set by serve_federation() when DUKE_PROBE=1
    protocol_version = "HTTP/1.1"

    # class-level defaults keep _reply safe for direct/test callers that
    # bypass _handle_request
    request_id: str = "-"
    trace_id: str = "-"

    def log_message(self, fmt, *args):
        logger.info("%s %s", self.address_string(), fmt % args)

    # -- plumbing -------------------------------------------------------------

    def _handle_request(self, method: str, route_fn) -> None:
        """Root-span wrapper: every plane request opens a
        trace that honors an inbound W3C ``traceparent`` -- the router's
        partition/fan-out/merge spans and each group's re-anchored
        subtree parent under it, so ``/debug/traces`` shows one causal
        tree per federated request.  ``POST /federation/migrate`` forces
        retention (``sampled=True``): migrations are rare, operator-
        initiated, and their phase timeline must survive sampling."""
        parsed = urlparse(self.path)
        route = _fed_route_template(parsed.path)
        self.request_id = new_request_id()
        request_id_var.set(self.request_id)
        with tracing.start_trace(
            f"{method} {route}",
            traceparent=self.headers.get("traceparent"),
            sampled=True if route == "/federation/migrate" else None,
            attributes={
                "http.method": method,
                "http.route": route,
                "http.target": parsed.path,
                "request_id": self.request_id,
            },
        ) as root:
            self.trace_id = root.trace_id
            try:
                route_fn(parsed)
            finally:
                request_id_var.set("-")

    def _reply(self, status: int, body: bytes,
               content_type: str = "application/json",
               extra_headers: Optional[dict] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Request-Id", self.request_id)
        self.send_header("X-Trace-Id", self.trace_id)
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

    def _read_body(self) -> bytes:
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = 0
        return self.rfile.read(length) if length > 0 else b""

    # -- routing --------------------------------------------------------------

    def do_GET(self):
        try:
            self._handle_request("GET", self._route_get)
        except Exception:
            logger.exception("federation plane: error serving %s", self.path)
            self._reply(500, b"Internal server error", "text/plain")

    def do_POST(self):
        body = self._read_body()
        try:
            self._handle_request(
                "POST", lambda parsed: self._route_post(parsed, body))
        except Exception:
            logger.exception("federation plane: error serving %s", self.path)
            self._reply(500, b"Internal server error", "text/plain")

    def _route_get(self, parsed) -> None:
        path = parsed.path
        if path in ("/health", "/healthz"):
            self._handle_healthz()
        elif path == "/readyz":
            self._handle_readyz()
        elif path == "/stats":
            self._handle_stats()
        elif path == "/metrics":
            # plane families + process-wide GLOBAL + the fleet rollup
            # (each group's registry collected sequentially, merged
            # sum/relabel -- see telemetry/rollup.py)
            body = telemetry.render(self.registry, telemetry.GLOBAL,
                                    self.rollup).encode("utf-8")
            self._reply(200, body, telemetry.CONTENT_TYPE)
        elif path == "/federation/map":
            self._reply_json(200, self.fed.map.to_json())
        elif path == "/federation/migration":
            self._reply_json(200, self.fed.migration_status())
        elif path == "/debug/traces":
            self._reply(*debug_api.handle_traces())
        elif m := _DEBUG_TRACE_PATH.match(path):
            fmt = (parse_qs(parsed.query).get("format") or ["json"])[0]
            self._reply(*debug_api.handle_trace(m.group(1), fmt))
        elif path == "/debug/requests":
            self._reply(*debug_api.handle_requests())
        elif path == "/debug/migrations":
            self._reply_json(200, {
                "migrations": self.fed.migrator.timelines_snapshot()})
        elif path == "/debug/profile":
            self._reply(*debug_api.handle_profile_status())
        elif path == "/debug/costs":
            # reconcile against every group's workloads: the federation
            # process runs them all, so the plane-wide attribution must
            # cover them all to balance the process-wide busy ledger
            self._reply(*debug_api.handle_costs(
                (kind, name, wl)
                for g in self.fed.groups
                for (kind, name), wl in list(g.workloads.items())))
        elif path == "/debug/memory":
            self._reply(*debug_api.handle_memory())
        elif path == "/debug/loadmap":
            self._reply(*debug_api.handle_loadmap(self.fed.router.heat))
        elif path == "/debug/slo":
            self._reply(*debug_api.handle_slo())
        elif path == "/debug/probes":
            if self.range_prober is None:
                self._reply_json(200, {"enabled": False})
            else:
                self._reply_json(200, self.range_prober.snapshot())
        elif m := _FEED_PATH.match(path):
            self._handle_feed(m, parse_qs(parsed.query))
        else:
            self._reply(404, b"Not found", "text/plain")

    def _route_post(self, parsed, body: bytes) -> None:
        path = parsed.path
        if path == "/federation/migrate":
            self._handle_migrate(body)
        elif path == "/debug/profile":
            # device captures through the federated front door; the
            # owner tag makes a cross-plane conflict 409 carry who holds
            # the profiler and its deadline
            self._reply(*debug_api.handle_profile_start(
                parse_qs(parsed.query), owner="federation"))
        elif path == "/debug/profile/reset":
            self._reply(*debug_api.handle_profile_reset())
        elif m := _ENTITY_PATH.match(path):
            self._handle_ingest(m, body)
        else:
            self._reply(404, b"Not found", "text/plain")

    # -- health ---------------------------------------------------------------

    def _recovering_scopes(self):
        from ..links import journal as link_journal

        return [f for f in self.fed.group_folders()
                if link_journal.recovery_active(f)]

    def _handle_healthz(self) -> None:
        degraded = self.fed.router.degraded_range_ids()
        health = {
            "status": "ok" if not degraded else "degraded",
            "role": "federation-router",
            "groups": len(self.fed.groups),
            "epoch": self.fed.map.epoch,
            "degraded_ranges": degraded,
        }
        # black-box overlay: a range whose reachability probe failed is
        # degraded even when the router hasn't contacted it yet
        if self.range_prober is not None:
            failing = self.range_prober.failing_ranges()
            if failing:
                health["status"] = "degraded"
                health["probe_failing_ranges"] = failing
        self._reply_json(200, health)

    def _handle_readyz(self) -> None:
        recovering = self._recovering_scopes()
        degraded = self.fed.router.degraded_range_ids()
        checks = {
            "recovery_complete": not recovering,
            "groups_reachable": not degraded,
            "migration_idle": not self.fed.migration_status()["active"],
        }
        if recovering:
            status = "recovering"
        elif degraded:
            status = "degraded"
        elif not checks["migration_idle"]:
            # still 200: the federation serves during a migration (only
            # the moving range's writes 429) -- the status string is the
            # operator signal, not a readiness failure
            status = "migrating"
        else:
            status = "ready"
        ready = checks["recovery_complete"] and checks["groups_reachable"]
        self._reply_json(200 if ready else 503, {
            "status": status,
            "checks": checks,
            "recovering_scopes": recovering,
            "degraded_ranges": degraded,
        })

    def _handle_stats(self) -> None:
        fed = self.fed
        groups = []
        for g, health in zip(fed.groups, fed.router.group_health()):
            row = dict(health)
            row["workloads"] = []
            for (kind, name), wl in g.workloads.items():
                live = getattr(wl.index, "live_records", None)
                wrow = {
                    "kind": kind,
                    "name": name,
                    "records_indexed": (live if live is not None
                                        else len(wl.index)),
                }
                try:
                    wrow["links_rows"] = wl.link_database.count()
                except Exception:
                    pass
                row["workloads"].append(wrow)
            groups.append(row)
        self._reply_json(200, {
            "role": "federation-router",
            "map": fed.map.to_json(),
            "migration": fed.migration_status(),
            "requests": fed.router.outcomes_snapshot(),
            "groups": groups,
        })

    # -- ingest ---------------------------------------------------------------

    def _handle_ingest(self, m, body: bytes) -> None:
        kind, name, dataset_id, transform = (
            m.group(1), m.group(2), m.group(3), bool(m.group(4)))
        label = _kind_label(kind)
        if transform:
            self._reply(400, b"httptransform is not federated; POST it "
                        b"to a group plane directly", "text/plain")
            return
        try:
            payload = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            self._reply(400, b"Request body must be a JSON array or "
                        b"object", "text/plain")
            return
        batch = [payload] if isinstance(payload, dict) else payload
        if (not isinstance(batch, list)
                or any(not isinstance(e, dict) for e in batch)):
            self._reply(400, b"Request body must be a JSON array or "
                        b"object", "text/plain")
            return
        from ..service.datasource import IngestError

        try:
            result = self.fed.router.submit(kind, name, dataset_id, batch)
        except IngestError as e:
            # routing needs each entity's record id, so a missing/empty
            # _id surfaces here rather than inside a group
            self._reply(400, str(e).encode(), "text/plain")
        except UnknownFederatedWorkload:
            self._reply(404, (f"Unknown {label} '{name}' or dataset "
                              f"'{dataset_id}'!").encode(), "text/plain")
        except FrozenRange as e:
            self._reply_json(429, {
                "error": str(e),
                "frozen_ranges": e.range_ids,
                "retry_after": e.retry_after,
            }, extra_headers={"Retry-After": str(e.retry_after)})
        except StaleRouterEpoch as e:
            # refreshed once and still stale: topology is moving faster
            # than this router; the client retries shortly
            self._reply_json(503, {"error": str(e)},
                            extra_headers={"Retry-After": "1"})
        except PartialIngestFailure as e:
            self._reply_json(503, {
                "error": str(e),
                "degraded_ranges": e.degraded_ranges,
                "group_errors": e.errors,
                "retry_after": e.retry_after,
            }, extra_headers={"Retry-After": str(e.retry_after)})
        except Exception as e:
            logger.exception("federated ingest failed")
            self._reply(500, f"Batch processing failed: {e}".encode(),
                        "text/plain")
        else:
            self._reply_json(200, result)

    # -- federated feed -------------------------------------------------------

    def _handle_feed(self, m, query) -> None:
        kind, name = m.group(1), m.group(2)
        label = _kind_label(kind)
        if not name:
            self._reply(400, f"The {label}Name cannot be an empty "
                        f"string!".encode(), "text/plain")
            return
        token = (query.get("since") or [""])[0]
        t0 = time.monotonic()
        try:
            page = self.fed.router.feed_page(kind, name, token,
                                             _feed_page_size())
        except BadCursor as e:
            self._reply(400, f"Invalid since value: {e}".encode(),
                        "text/plain")
            return
        except UnknownFederatedWorkload:
            self._reply(400, (f"Unknown {label} '{name}'! (All {label}s "
                              f"must be specified in the "
                              f"configuration)").encode(), "text/plain")
            return
        # always-on feed SLO signal + lag meter: page latency
        # against DUKE_SLO_FEED_MS; a fully-drained page marks the feed
        # caught up, so duke_feed_lag_seconds stops aging
        slo.tracker("feed", kind, name).record(time.monotonic() - t0)
        if page["drained"]:
            slo.feed_meter(kind, name).note_drain()
        headers = {
            "X-Fed-Next-Since": page["next_since"],
            "X-Fed-Drained": "true" if page["drained"] else "false",
        }
        if page["degraded_ranges"]:
            headers["X-Fed-Degraded-Ranges"] = ",".join(
                page["degraded_ranges"])
            headers["Retry-After"] = str(page["retry_after"]
                                         or 1)
        body = ("[" + ",\n".join(json.dumps(r) for r in page["rows"])
                + "]").encode("utf-8")
        self._reply(200, body, extra_headers=headers)

    # -- admin: migration -----------------------------------------------------

    def _handle_migrate(self, body: bytes) -> None:
        try:
            req = json.loads(body.decode("utf-8"))
            range_id = str(req["range"])
            target = int(req["target"])
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            self._reply(400, b'Body must be {"range": "<id>", '
                        b'"target": <group>}', "text/plain")
            return
        try:
            result = self.fed.migrate_range(range_id, target)
        except KeyError:
            self._reply(404, f"Unknown range '{range_id}'".encode(),
                        "text/plain")
        except (ValueError, RuntimeError) as e:
            self._reply(409, str(e).encode(), "text/plain")
        except Exception as e:
            logger.exception("migration failed")
            self._reply(500, f"Migration failed: {e}".encode(),
                        "text/plain")
        else:
            self._reply_json(200, result)


def serve_federation(fed: Federation, port: int = 0,
                     host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Bind the federation plane and serve it on a daemon thread;
    returns the server (caller owns ``shutdown()``)."""
    registry = MetricRegistry()
    registry.register_collector(make_federation_collector(fed))
    # fleet rollup: one registry per group, each carrying a
    # lock-free workload-walking collector; GroupRollup snapshots them
    # sequentially at scrape, so no group lock is ever held across
    # another group's collection
    # black-box range reachability probing: per-range probes
    # through the group read path; each group's registry carries the
    # collector for ITS ranges so the rollup merges the fleet view
    prober = None
    if probes_enabled():
        from .prober import RangeProber

        prober = RangeProber(fed)
    group_regs = []
    for g in fed.groups:
        reg = MetricRegistry()
        reg.register_collector(make_group_collector(g))
        if prober is not None:
            reg.register_collector(prober.collector_for(g.idx))
        group_regs.append((str(g.idx), reg))
    rollup = GroupRollup(group_regs)
    handler = type("BoundFederationHandler", (FederationHandler,),
                   {"fed": fed, "registry": registry, "rollup": rollup,
                    "range_prober": prober})
    server = ThreadingHTTPServer((host, port), handler)
    if prober is not None:
        prober.start()
        # stop the probe thread with the plane: shutdown() is the
        # caller-owned teardown seam
        orig_shutdown = server.shutdown

        def _shutdown():
            prober.stop()
            orig_shutdown()

        server.shutdown = _shutdown
    thread = threading.Thread(target=server.serve_forever,
                              name="federation-plane", daemon=True)
    thread.start()
    logger.info("federation plane serving %d group(s) on %s:%d",
                len(fed.groups), host, server.server_address[1])
    return server


__all__ = ["FederationHandler", "make_federation_collector",
           "serve_federation", "PHASE_CODES"]
