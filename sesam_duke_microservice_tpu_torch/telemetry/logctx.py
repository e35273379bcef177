"""Structured logging context: per-request ids + trace correlation (a copy
of the JAX package's ``telemetry/logctx.py``).

The HTTP handler stamps each request with a short id
(``new_request_id``) and sets it in a ``contextvars.ContextVar``.  The
handler thread runs the whole request — parse, workload lock, engine
batch, response — so every log line the request produces (including
engine lines like the escalation logs) can carry the id with
zero plumbing: ``RequestIdFilter`` injects ``record.request_id`` from
the context var into every record passing a handler.  The filter also
injects ``record.trace_id`` from the tracer's active context
(telemetry.tracing), so a probe-failure or SLO-violation log line joins
directly against ``/debug/traces/<id>`` — logs↔traces forensics without
any call-site plumbing.

``install()`` attaches the filter to the root logger's handlers and is
idempotent; the service CLI calls it with a format that includes
``%(request_id)s``.  Library users who never install it see no change
(the filter only adds attributes; no format references them).  With
``DUKE_LOG_JSON=1`` the installed formatter emits one JSON object per
line (ts/level/logger/message/request_id/trace_id) for log pipelines
that ingest structured streams.

Caveat (documented, deliberate): ingest microbatching means the thread
that wins the workload lock processes every queued request's batch as
one merged device batch — engine lines for a merged batch carry the
LEADER request's id.  The HTTP-layer lines (one per request) always
carry their own.
"""

from __future__ import annotations

import contextvars
import json
import logging
import secrets
import time

# "-" (not empty) so %(request_id)s renders something greppable for
# lines produced outside any request (startup, background threads)
request_id_var: contextvars.ContextVar = contextvars.ContextVar(
    "duke_request_id", default="-"
)


def new_request_id() -> str:
    return secrets.token_hex(6)


def current_request_id() -> str:
    return request_id_var.get()


class RequestIdFilter(logging.Filter):
    """Injects ``record.request_id`` and ``record.trace_id`` from the
    ambient contexts (always passes)."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.request_id = request_id_var.get()
        # lazy import: tracing imports this module for its request-id
        # join; the filter closes the other direction of the loop
        from . import tracing

        record.trace_id = tracing.current_trace_id() or "-"
        return True


_FILTER = RequestIdFilter()

DEFAULT_FORMAT = (
    "%(asctime)s %(levelname)s %(name)s [%(request_id)s %(trace_id)s] "
    "%(message)s"
)


class JsonFormatter(logging.Formatter):
    """One JSON object per line, carrying the correlation ids the filter
    injected.  Opt-in via ``DUKE_LOG_JSON=1`` (see ``install``)."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "time": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
            "request_id": getattr(record, "request_id", "-"),
            "trace_id": getattr(record, "trace_id", "-"),
        }
        if record.exc_info:
            out["exc_info"] = self.formatException(record.exc_info)
        return json.dumps(out, separators=(",", ":"))


def _json_enabled() -> bool:
    from .env import env_flag

    return env_flag("DUKE_LOG_JSON", False)


def install(fmt: str = DEFAULT_FORMAT) -> None:
    """Attach the correlation filter (and format) to the root handlers.

    Idempotent.  Call AFTER logging.basicConfig — with no handlers yet
    this configures one, so the CLI can call just ``install()``.  With
    ``DUKE_LOG_JSON=1`` a ``JsonFormatter`` replaces the line format.
    """
    root = logging.getLogger()
    if not root.handlers:
        logging.basicConfig(level=logging.INFO, format=fmt)
    formatter: logging.Formatter
    if _json_enabled():
        formatter = JsonFormatter()
    else:
        formatter = logging.Formatter(fmt)
    for handler in root.handlers:
        if _FILTER not in handler.filters:
            handler.addFilter(_FILTER)
        if fmt is not None:
            handler.setFormatter(formatter)
