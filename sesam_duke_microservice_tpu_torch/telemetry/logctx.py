"""Per-request ids (the part of the JAX package's ``telemetry/logctx.py``
the port's HTTP layer uses).

The HTTP handler stamps each request with a short id
(``new_request_id``), answers it in the ``X-Request-Id`` header and sets
it in a ``contextvars.ContextVar`` for the request's duration, so any code
the handler thread runs can read it (``current_request_id``).  The log
filter and the trace-id join of the JAX module wait for the port's
tracer.
"""

from __future__ import annotations

import contextvars
import secrets

# "-" (not empty) so a reader outside any request sees something greppable
request_id_var: contextvars.ContextVar = contextvars.ContextVar(
    "duke_request_id", default="-"
)


def new_request_id() -> str:
    return secrets.token_hex(6)


def current_request_id() -> str:
    return request_id_var.get()
