"""The port's ``/debug`` surface held against the JAX app's, route by
route: status and JSON keys (at every level of the payload that holds
stable keys), on the same traffic over real HTTP.

Both apps serve the config of tests/test_torch_service_surface.py and
take the same seeded POSTs with a sampled ``traceparent``; then
``/debug/traces`` (list, one tree as JSON and as Chrome trace events, an
unknown id, an unknown format), ``/debug/requests``,
``/debug/decisions`` (list, one record, an unknown id),
``/debug/profile`` (status, a capture with the profiler seams patched,
a 409, a 400, the reset), ``/debug/costs``, ``/debug/memory`` and
``/debug/slo`` answer the same statuses with the same keys, and
``/metrics`` labels every one of these requests with the JAX package's
route template; ``/debug/memory`` carries the ``arena`` block and
``/debug/probes`` the canary prober's history, as in the JAX package, and
``/debug/loadmap`` the JAX app's empty heat map (a single group routes
nothing through a federation router).  The deliberate differences,
asserted: ``/debug/memory`` has no ``aot_executables`` component in the
port (the XLA executable store is not ported), and a trace tree's spans
compare over the names both packages record (the port's scoring pass is
true intervals, the JAX package's aggregate retrieve and score).  Keys
compare exactly; values are not compared here (the tracing, explain and
service-surface tests hold them).
"""

import json
import time

import pytest

from sesam_duke_microservice_tpu.engine import device_matcher as JDM
from sesam_duke_microservice_tpu.telemetry import tracing as jtracing
from sesam_duke_microservice_tpu.utils import profiling as jprofiling
from sesam_duke_microservice_tpu_torch.engine import device_matcher as TDM
from sesam_duke_microservice_tpu_torch.service import app as tapp_module
from sesam_duke_microservice_tpu_torch.utils import profiling as tprofiling
from test_torch_tracing import AGGREGATE, PORT_PASS_SPANS
from test_torch_service_surface import (
    config_xml,
    drive_traffic,
    entities,
    jax_app,
    parse_metrics,
    port_app,
    post_json,
    request,
    served,
)

TID = "5a" * 16


def shape(value):
    """The key structure of a JSON value: dicts by sorted keys (values
    recursed), lists by the shape of their first element."""
    if isinstance(value, dict):
        return {k: shape(v) for k, v in sorted(value.items())}
    if isinstance(value, list):
        return [shape(value[0])] if value else []
    return type(value).__name__ if value is not None else None


def loose(value):
    """``shape`` with leaf types erased (a count may be int on one side
    and float on the other, a field None until first written)."""
    if isinstance(value, dict):
        return {k: loose(v) for k, v in value.items()}
    if isinstance(value, list):
        return [loose(v) for v in value]
    return "leaf"


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    mp.setenv("DUKE_FEATURE_CACHE_MB", "0")
    mp.setenv("DUKE_DECISION_SAMPLE", "1.0")
    mp.setenv("TRACE_SLOW_MS", "60000")
    mp.setattr(JDM, "_UPDATE_SLICE", 8)
    mp.setattr(TDM, "_UPDATE_SLICE", 8)
    xml = config_xml()
    apps = (jax_app(xml), port_app(xml))
    try:
        with served(*apps) as urls:
            drive_traffic(urls)
            tp = jtracing.format_traceparent(TID, "77" * 8, True)
            for url in urls:
                status, _, body = request(
                    url + "/deduplication/people/crm", "POST",
                    json.dumps(entities(20, 9, "z")).encode(),
                    {"Content-Type": "application/json",
                     "traceparent": tp})
                assert status == 200, body
                # the tree lands when the root span exits, after the reply
                for _ in range(50):
                    if request(url + f"/debug/traces/{TID}")[0] == 200:
                        break
                    time.sleep(0.02)
            yield apps, urls
    finally:
        mp.undo()


def both(urls, path, method="GET", body=None):
    out = []
    for url in urls:
        status, headers, raw = request(url + path, method, body)
        assert headers.get("X-Trace-Id") not in (None, "-")
        out.append((status, json.loads(raw) if raw.startswith(b"{")
                    else raw))
    return out


@pytest.mark.parametrize("path", [
    "/debug/traces",
    f"/debug/traces/{TID}",
    f"/debug/traces/{TID}?format=chrome",
    f"/debug/traces/{TID}?format=xml",
    "/debug/traces/" + "ab" * 16,
    "/debug/requests",
    "/debug/decisions",
    "/debug/decisions/d99999999",
    "/debug/profile",
    "/debug/costs",
])
def test_debug_route_status_and_keys_equal_jax(pair, path):
    _, urls = pair
    (jstatus, jbody), (tstatus, tbody) = both(urls, path)
    assert tstatus == jstatus
    if isinstance(tbody, dict) and "spans" in tbody:
        # a trace tree: the port records its scoring pass in true
        # intervals where the JAX package lays out aggregate retrieve and
        # score spans (tests/test_torch_tracing.py); the spans both name
        tbody["spans"] = [s for s in tbody["spans"]
                          if s["name"] not in PORT_PASS_SPANS]
        jbody["spans"] = [s for s in jbody["spans"]
                          if s["name"] not in AGGREGATE]
    assert loose(shape(tbody)) == loose(shape(jbody))
    if jstatus == 200:
        assert isinstance(tbody, dict) and tbody


def test_debug_slo_keys_equal_jax(pair):
    """``/debug/slo``: one violation with an exemplar trace id recorded on
    a tracker of its own in each package (the trackers are process-wide,
    so other tests' trackers and violations differ between the two):
    that tracker's entry has the same keys at every level."""
    from sesam_duke_microservice_tpu.telemetry import slo as jslo
    from sesam_duke_microservice_tpu_torch.telemetry import slo as tslo

    _, urls = pair
    for slo in (jslo, tslo):
        slo.tracker("ingest", "deduplication", "debug-slo-keys").record(
            3600.0, trace_id="ab" * 16)
    entries = []
    for url in urls:
        status, _, raw = request(url + "/debug/slo")
        assert status == 200
        (mine,) = [t for t in json.loads(raw)["trackers"]
                   if t["workload"] == "debug-slo-keys"]
        assert mine["recent_violations"][0]["trace_id"] == "ab" * 16
        entries.append(loose(shape(mine)))
    assert entries[1] == entries[0]


def test_debug_memory_keys_equal_jax_but_the_arena(pair):
    """The keys equal the JAX package's, the ``arena`` block and the
    rows' ``logical`` marks of arena views included (the name predates
    the port's arena); only the AOT store's process row is the JAX
    package's alone."""
    _, urls = pair
    (jstatus, jbody), (tstatus, tbody) = both(urls, "/debug/memory")
    assert tstatus == jstatus == 200
    assert tbody["arena"]["enabled"] is jbody["arena"]["enabled"] is True
    # arena views carry the ``logical`` mark, and only they; which row
    # comes first in the process-wide ledger depends on the tests that
    # ran before in this process, so the mark is held here and dropped
    # from the shape comparison below
    from sesam_duke_microservice_tpu_torch.telemetry import memory

    marked = [row for row in tbody["workloads"] if row.get("logical")]
    assert marked and all(row["component"] in memory._ARENA_VIEW_COMPONENTS
                          for row in marked)
    for body in (tbody, jbody):
        for row in body["workloads"]:
            row.pop("logical", None)
    # no AOT executable store (XLA executables: not ported by design)
    assert "aot_executables" not in tbody["process"]
    jbody["process"].pop("aot_executables", None)
    assert loose(shape(tbody)) == loose(shape(jbody))


def test_debug_decision_record_keys_equal_jax(pair):
    _, urls = pair
    records = []
    for url in urls:
        listing = json.loads(request(url + "/debug/decisions")[2])
        assert listing["decisions"]
        # the newest record of one outcome on both sides
        row = listing["decisions"][0]
        status, _, raw = request(url + f"/debug/decisions/{row['id']}")
        assert status == 200
        full = json.loads(raw)
        assert full["outcome"] == row["outcome"]
        records.append(set(full) - {"device_logit", "decisive_prune_logit",
                                    "certified_margin", "margin_slack",
                                    "probability", "pair_logit",
                                    "properties", "host_pair_logit"})
    assert records[1] == records[0]


def test_debug_profile_cycle_and_reset_keys_equal_jax(pair, monkeypatch):
    _, urls = pair
    monkeypatch.setattr(jprofiling, "profiler_start", lambda d: None)
    monkeypatch.setattr(jprofiling, "profiler_stop", lambda: None)
    monkeypatch.setattr(tprofiling, "profiler_start", lambda d, s: None)
    monkeypatch.setattr(tprofiling, "profiler_stop", lambda: "t.json")
    seen = []
    for url, profiling in ((urls[0], jprofiling), (urls[1], tprofiling)):
        answers = []
        try:
            for path in ("/debug/profile?seconds=30",
                         "/debug/profile?seconds=1",
                         "/debug/profile?seconds=nan-ish"):
                status, _, raw = request(url + path, "POST", b"")
                answers.append((status, loose(shape(json.loads(raw)))))
            status, _, raw = request(url + "/debug/profile")
            answers.append((status, loose(shape(json.loads(raw)))))
        finally:
            profiling.stop_capture()
        status, _, raw = request(url + "/debug/profile/reset", "POST", b"")
        answers.append((status, sorted(json.loads(raw))))
        seen.append(answers)
    assert seen[1] == seen[0]
    assert [a[0] for a in seen[1]] == [200, 409, 400, 200, 200]


def test_every_jax_debug_route_is_served(pair):
    """No ``/debug`` route of the JAX app answers 404 on the port any
    more: ``/debug/loadmap`` serves the JAX app's payload (the federation
    heat map, empty on a single group), and the canary prober's
    ``/debug/probes`` is served with the JAX keys."""
    _, urls = pair
    (jstatus, jbody), (tstatus, tbody) = both(urls, "/debug/loadmap")
    assert tstatus == jstatus == 200
    assert tbody == jbody == {"n_buckets": 256, "ranges": []}
    (jstatus, jbody), (tstatus, tbody) = both(urls, "/debug/probes")
    assert tstatus == jstatus == 200
    assert loose(shape(tbody)) == loose(shape(jbody))
    assert tbody["enabled"] is jbody["enabled"] is True


def test_debug_route_templates_equal_jax(pair):
    """Every served ``/debug`` and ``/explain`` request lands under the
    JAX package's route template in ``duke_http_requests_total``."""
    _, urls = pair
    for url in urls:
        for path in ("/debug/traces", f"/debug/traces/{TID}",
                     "/debug/decisions", "/debug/decisions/d00000001",
                     "/debug/loadmap"):
            request(url + path)
        post_json(url + "/explain", {"name": "people", "id1": "crm__c0",
                                     "id2": "crm__c1"})
    routes = []
    for url in urls:
        _, _, values = parse_metrics(request(url + "/metrics")[2].decode())
        routes.append({dict(k[1])["route"] for k in values
                       if k[0] == "duke_http_requests_total"
                       and dict(k[1])["route"].startswith(("/debug",
                                                           "/explain"))})
    assert routes[1] <= routes[0]
    assert {"/debug/traces/:id", "/debug/decisions/:id", "/explain",
            "/debug/traces", "/debug/decisions",
            "/debug/loadmap"} <= routes[1]
    assert tapp_module._route_template("/debug/loadmap") == "/debug/loadmap"
