"""``/debug`` surface: flight recorders, decisions, explain, profiling,
probes, load map (the JAX package's ``service/debug.py`` on torch).

Rendering helpers for the debug/explainability endpoints:

    GET  /debug/traces              recent retained-trace summaries
    GET  /debug/traces/<id>         one tree, ?format=json|chrome
    GET  /debug/requests            always-on last-N request digests
    GET  /debug/decisions           decision flight-recorder ring
    GET  /debug/decisions/<id>      one full decision record
    POST /explain                   replay a pair in explain mode
    POST /debug/profile?seconds=N   on-demand torch.profiler capture
    POST /debug/profile/reset       re-arm the PROFILE_TRACE_DIR budget
    GET  /debug/costs               device-time ledger + reconciliation
    GET  /debug/memory              device-memory ledger + headroom
    GET  /debug/loadmap             federation sub-range heat map
    GET  /debug/slo                 SLO violations w/ exemplar traces
    GET  /debug/probes              canary prober history + mismatches

Each helper returns ``(status, body_bytes, content_type)`` so the HTTP
layer stays a thin switch (service/app.py) and the logic is unit-testable
without a socket.  Everything here reads recorder snapshots under the
recorders' own short locks — never engine state, never the workload locks
— EXCEPT ``handle_explain``, which replays the pipeline under the target
workload's lock with the feed endpoints' 1 s read-timeout semantics, so
``/debug`` still cannot stall ingest.
"""

from __future__ import annotations

import json
from typing import Tuple

from ..telemetry import tracing
from ..utils import profiling

_JSON = "application/json"

Reply = Tuple[int, bytes, str]


def _reply_json(status: int, payload) -> Reply:
    return status, json.dumps(payload).encode("utf-8"), _JSON


def handle_traces(recorder: tracing.FlightRecorder = None) -> Reply:
    recorder = recorder if recorder is not None else tracing.RECORDER
    return _reply_json(200, {"traces": recorder.summaries()})


def handle_trace(trace_id: str, fmt: str = "json",
                 recorder: tracing.FlightRecorder = None) -> Reply:
    recorder = recorder if recorder is not None else tracing.RECORDER
    if fmt not in ("json", "chrome"):
        return _reply_json(
            400, {"error": f"unknown format {fmt!r} (json|chrome)"})
    record = recorder.get(trace_id)
    if record is None:
        return _reply_json(404, {
            "error": f"trace {trace_id!r} is not in the flight recorder "
                     "(unretained, evicted, or never existed)"})
    if fmt == "chrome":
        return _reply_json(200, tracing.chrome_trace(record))
    return _reply_json(200, tracing.trace_to_json(record))


def handle_requests(recorder: tracing.FlightRecorder = None) -> Reply:
    recorder = recorder if recorder is not None else tracing.RECORDER
    return _reply_json(200, {"requests": recorder.digests()})


def _decision_workloads(app):
    for kind, registry in (("deduplication", app.deduplications),
                           ("recordlinkage", app.record_linkages)):
        for name, wl in list(registry.items()):
            recorder = getattr(wl.processor, "decisions", None)
            if recorder is not None:
                yield kind, name, wl, recorder


def handle_decisions(app) -> Reply:
    """``GET /debug/decisions``: the decision flight-recorder ring across
    every live workload, most recent first.  Full per-property payloads
    stay behind ``/debug/decisions/<id>`` — the listing is a summary."""
    rows = []
    for kind, name, _wl, recorder in _decision_workloads(app):
        for record in recorder.records():
            rows.append({
                "id": record["id"],
                "kind": kind,
                "workload": name,
                "time_unix": record.get("time_unix"),
                "query": record.get("query"),
                "candidate": record.get("candidate"),
                "outcome": record.get("outcome"),
                "probability": record.get("probability"),
                "device_logit": record.get("device_logit"),
                "latched": record.get("latched"),
                "sampled": record.get("sampled"),
                "trace_id": record.get("trace_id"),
            })
    # numeric sort on the sequence part: the zero-padding runs out at
    # 10^8 decisions and lexicographic order would put newest last
    rows.sort(key=lambda r: int(r["id"][1:]), reverse=True)
    return _reply_json(200, {"decisions": rows})


def handle_decision(app, decision_id: str) -> Reply:
    """``GET /debug/decisions/<id>``: one full decision record."""
    for kind, name, _wl, recorder in _decision_workloads(app):
        record = recorder.get(decision_id)
        if record is not None:
            out = dict(record)
            out["kind"] = kind
            out["workload"] = name
            return _reply_json(200, out)
    return _reply_json(404, {
        "error": f"decision {decision_id!r} is not in the ring "
                 "(evicted, unsampled, or never existed)"})


def handle_explain(app, body: bytes) -> Reply:
    """``POST /explain``: replay one pair through the pipeline in explain
    mode (engine.explain).  Body selects the workload (``kind``/``name``,
    optional when exactly one workload exists) and the two records
    (``id1``/``id2`` or raw ``record1``/``record2``)."""
    from ..engine import explain as X

    try:
        payload = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return _reply_json(400, {"error": "Request body must be JSON"})
    if not isinstance(payload, dict):
        return _reply_json(400, {"error": "Request body must be a JSON object"})

    registries = {"deduplication": app.deduplications,
                  "recordlinkage": app.record_linkages}
    kind = payload.get("kind")
    name = payload.get("name") or payload.get("workload")
    candidates = []
    for k, registry in registries.items():
        if kind is not None and k != str(kind):
            continue
        for n, wl in registry.items():
            if name is None or n == str(name):
                candidates.append((k, n, wl))
    if not candidates:
        return _reply_json(404, {
            "error": f"no workload matches kind={kind!r} name={name!r}"})
    if len(candidates) > 1:
        return _reply_json(400, {
            "error": "ambiguous workload — pass \"kind\" and \"name\"",
            "workloads": [{"kind": k, "name": n} for k, n, _ in candidates],
        })
    _, _, workload = candidates[0]
    try:
        return _reply_json(200, X.explain_request(workload, payload))
    except X.ExplainBusy:
        return (503,
                b"The workload is being written to, so explaining is not "
                b"currently possible. Please wait a bit and try again "
                b"later.", "text/plain")
    except X.ExplainError as e:
        return _reply_json(e.status, {"error": str(e)})


def handle_profile_status() -> Reply:
    """``GET /debug/profile``: the live capture's dir/deadline, or
    ``{"capturing": null}`` when idle — so an operator can see (and wait
    out) a running capture instead of probing with 409s."""
    return _reply_json(200, {"capturing": profiling.capture_status()})


def handle_profile_start(query: dict, owner: str = "app") -> Reply:
    """``POST /debug/profile?seconds=N``: the process's one profiler;
    ``owner`` names the requesting plane so a conflict 409 says who holds
    the capture and until when."""
    raw = (query.get("seconds") or ["5"])[0]
    try:
        seconds = float(raw)
    except ValueError:
        return _reply_json(400, {"error": f"unparseable seconds {raw!r}"})
    try:
        info = profiling.start_capture(seconds, owner=owner)
    except profiling.CaptureActiveError as e:
        return _reply_json(409, {
            "error": str(e),
            "owner": e.owner,
            "deadline_unix": e.deadline_unix,
            "remaining_seconds": e.remaining_seconds,
        })
    except ValueError as e:
        return _reply_json(400, {"error": str(e)})
    return _reply_json(200, {"capturing": info})


def handle_profile_reset() -> Reply:
    return _reply_json(200, {
        "trace_budget_reset": True,
        "budget_batches": profiling.reset_trace_budget(),
    })


# -- cost & capacity attribution ---------------------------------------------


def _app_workloads(app):
    """(kind, name, workload) across both registries — the cost/memory
    debug surfaces' workload iterator for the main plane."""
    for kind, registry in (("deduplication", app.deduplications),
                           ("recordlinkage", app.record_linkages)):
        for name, wl in list(registry.items()):
            yield kind, name, wl


def handle_costs(workload_iter=()) -> Reply:
    """``GET /debug/costs``: the host busy ledger reconciled against
    per-workload phase attribution (its ``utilization`` is the CUDA-event
    device time's, ``telemetry.costs.utilization``).
    ``attributed_seconds`` sums every live PhaseRecorder; the residual
    vs the busy ledger is reported as
    ``unattributed_seconds`` (PhaseRecorders die with reloaded-away
    workloads, the ledger survives) and ``reconciles`` asserts the two
    agree within max(50 ms, 1%) — the tested invariant."""
    from ..telemetry import costs

    snap = costs.snapshot()
    workloads = []
    attributed = 0.0
    for kind, name, wl in workload_iter:
        phases = wl.processor.phases.phase_seconds()
        total = sum(phases.values())
        attributed += total
        workloads.append({
            "kind": kind,
            "workload": name,
            "phase_seconds": {p: round(s, 6)
                              for p, s in sorted(phases.items())},
            "device_seconds": round(total, 6),
        })
    busy = snap["busy_seconds_total"]
    residual = busy - attributed
    tolerance = max(0.05, 0.01 * busy)
    snap.update({
        "attributed_seconds": round(attributed, 6),
        "unattributed_seconds": round(residual, 6),
        "reconciles": abs(residual) <= tolerance,
        "tolerance_seconds": round(tolerance, 6),
        "workloads": workloads,
    })
    return _reply_json(200, snap)


def handle_memory() -> Reply:
    """``GET /debug/memory``: the device-memory ledger (per-workload
    components, process components, headroom and overflow forecast)."""
    from ..telemetry import memory

    return _reply_json(200, memory.debug_snapshot())


def handle_loadmap(heatmap) -> Reply:
    """``GET /debug/loadmap``: sub-range heat per owned range with the
    suggested split point (``heatmap`` may be None -- single-group
    deployments route nothing through a federation router)."""
    from ..telemetry import heat

    return _reply_json(200, heat.loadmap(heatmap))


def handle_slo() -> Reply:
    """``GET /debug/slo``: per-tracker burn-rate state plus recent
    violations with exemplar trace links."""
    from ..telemetry import slo

    return _reply_json(200, slo.debug_snapshot())


def handle_probes(prober) -> Reply:
    """``GET /debug/probes``: per-workload canary probe history with
    links into /debug/traces and /debug/decisions (``prober`` is None
    when DUKE_PROBE=0 -- report disabled instead of 404 so dashboards
    can tell "off" from "missing")."""
    if prober is None:
        return _reply_json(200, {"enabled": False})
    return _reply_json(200, prober.debug_snapshot())
