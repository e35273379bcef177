"""The port's federation plane against the JAX package's over real HTTP
(the counterpart of tests/test_federation.py::TestFederationPlane and the
federation parts of tests/test_observability.py, tests/test_capacity.py
and tests/test_probes.py).

Both planes serve a federation of the same config and take the same
requests: statuses, the ``X-Fed-*`` and ``Retry-After`` headers and the
bodies are equal -- the ingest, each feed page with its token, the
partition map, a migration and its status and timeline, the frozen-range
429, the degraded 503 and ``/readyz``, ``/stats``, ``/debug/loadmap``,
the range prober's ``/healthz`` and ``/debug/probes``, and the bad
inputs.  ``/metrics`` compares the ``duke_fed_*`` families' samples
(latencies by count), the fleet rollup's families (names, types, label
names), and the port's rollup against the sum of its groups' own
collectors.  Link clocks are pinned per scatter thread as in
tests/test_torch_federation.py.
"""

import json
import re
import urllib.error
import urllib.request

import pytest

import sesam_duke_microservice_tpu.links.journal as jjournal
import sesam_duke_microservice_tpu.service.federation_plane as jplane
import sesam_duke_microservice_tpu.service.metrics as jmetrics
import sesam_duke_microservice_tpu_torch.links.journal as tjournal
import sesam_duke_microservice_tpu_torch.service.federation_plane as tplane
import sesam_duke_microservice_tpu_torch.service.metrics as tmetrics

from test_federation import duplicate_batch
from test_torch_federation import (  # noqa: F401
    JAX, PKGS, PORT, _no_env_faults, _timeline_shape, group_clocks,
    make_fed)
from test_torch_service_surface import (  # noqa: F401
    every_decision_sampled, fresh_slo_trackers)
from torch_jax_cache import jax_cache_off  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

PLANE = {"jax": jplane, "port": tplane}
METRICS = {"jax": jmetrics, "port": tmetrics}
JOURNAL = {"jax": jjournal, "port": tjournal}
INGEST = "/deduplication/people/crm"
FEED = "/deduplication/people"
_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
_LABEL = re.compile(r'([a-zA-Z_]\w*)="((?:\\.|[^"\\])*)"')


def call(base, path, body=None, method=None):
    """(status, headers, raw body) of one request (errors included)."""
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(
        base + path, data=data, method=method or (
            "GET" if data is None else "POST"),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


FED_HEADERS = ("X-Fed-Next-Since", "X-Fed-Drained", "X-Fed-Degraded-Ranges",
               "Retry-After", "Content-Type")


def answer(reply):
    status, headers, raw = reply
    return (status, {h: headers.get(h) for h in FED_HEADERS}, raw)


@pytest.fixture()
def planes(tmp_path, request):
    """{package name: (federation, base URL, server)}; ``backend`` by
    indirect parametrization (default ``host``)."""
    backend = getattr(request, "param", "host")
    out, servers = {}, []
    try:
        for pkg in PKGS:
            fed = make_fed(pkg, tmp_path / pkg.name, n_groups=2,
                           backend=backend)
            server = PLANE[pkg.name].serve_federation(fed)
            servers.append((pkg, server, fed))
            out[pkg.name] = (fed, f"http://127.0.0.1:"
                                  f"{server.server_address[1]}", server)
        yield out
    finally:
        for pkg, server, fed in servers:
            pkg.faults.configure("")
            server.shutdown()
            server.server_close()
            fed.close()


def both(planes, path, body=None, method=None):
    got = {name: answer(call(base, path, body, method))
           for name, (_fed, base, _srv) in planes.items()}
    assert got["port"] == got["jax"], (path, got)
    return got["port"]


def drain_flushers(planes):
    for fed, _base, _srv in planes.values():
        for g in fed.groups:
            for wl in g.workloads.values():
                wl.link_database.drain()


def test_ingest_feed_migrate_equal(planes, monkeypatch):
    monkeypatch.setenv("FEED_PAGE_SIZE", "7")
    assert both(planes, INGEST, duplicate_batch(24))[0] == 200
    assert both(planes, INGEST, duplicate_batch(24, start=24))[0] == 200
    token, pages = "", 0
    while True:
        status, headers, raw = both(planes, f"{FEED}?since={token}")
        assert status == 200 and len(json.loads(raw)) <= 7
        token = headers["X-Fed-Next-Since"]
        pages += 1
        if headers["X-Fed-Drained"] == "true" and raw == b"[]":
            break
    assert pages > 3
    _, _, raw = both(planes, "/federation/map")
    moved = next(r for r in json.loads(raw)["ranges"] if r["group"] == 0)
    # the snapshot reads the durable link store: settle the flushers so
    # the moved links / replayed slices split is the same on both sides
    drain_flushers(planes)
    status, _, raw = both(planes, "/federation/migrate",
                          {"range": moved["id"], "target": 1})
    assert status == 200 and json.loads(raw)["moved_records"] > 0
    both(planes, "/federation/map")
    both(planes, "/federation/migration")
    both(planes, f"{FEED}?since=")
    assert both(planes, f"{FEED}?since={token}")[2] == b"[]"
    timelines = {}
    for name, (_fed, base, _srv) in planes.items():
        status, _, raw = call(base, "/debug/migrations")
        assert status == 200
        timelines[name] = _timeline_shape(json.loads(raw)["migrations"])
    assert timelines["port"] == timelines["jax"]
    assert [p["phase"] for p in timelines["port"][0]["phases"]] == [
        "freeze", "snapshot", "replay", "cutover", "drain"]


def test_frozen_429_degraded_503_and_readyz_equal(planes):
    assert both(planes, INGEST, duplicate_batch(24))[0] == 200
    drain_flushers(planes)
    both(planes, "/readyz")
    both(planes, "/healthz")
    for fed, _base, _srv in planes.values():
        frozen = next(r for r in fed.map.ranges() if r.group == 0)
        fed.map.freeze(frozen.range_id)
    status, headers, _ = both(planes, INGEST, duplicate_batch(24))
    assert status == 429 and int(headers["Retry-After"]) >= 1
    for fed, _base, _srv in planes.values():
        fed.map.assign(frozen.range_id, 0)
        for g in fed.groups:
            g.fence(fed.map.epoch)
    for pkg in PKGS:
        pkg.faults.configure("fed_down=1")
    status, headers, raw = both(planes, INGEST,
                                duplicate_batch(24, start=100))
    assert status == 503 and json.loads(raw)["degraded_ranges"]
    status, headers, raw = both(planes, f"{FEED}?since=")
    assert headers["X-Fed-Degraded-Ranges"] and json.loads(raw)
    assert both(planes, "/readyz")[0] == 503
    both(planes, "/healthz")
    for pkg in PKGS:
        pkg.faults.configure("")
    assert both(planes, INGEST, duplicate_batch(24, start=100))[0] == 200
    assert both(planes, "/readyz")[0] == 200
    both(planes, "/stats")


def test_readyz_recovering_is_scoped_to_the_group_folders(planes):
    for name, (fed, base, _srv) in planes.items():
        scope = fed.group_folders()[0]
        with JOURNAL[name].recovery_in_progress(scope):
            status, _, raw = call(base, "/readyz")
            assert status == 503
            body = json.loads(raw)
            assert body["status"] == "recovering"
            assert body["recovering_scopes"] == [scope]
        with JOURNAL[name].recovery_in_progress("/another/process"):
            assert call(base, "/readyz")[0] == 200


def test_bad_inputs_equal(planes):
    for path, body in (
            (f"{FEED}?since=@@@bad@@@", None),
            ("/deduplication/nope?since=", None),
            ("/deduplication/?since=", None),
            ("/deduplication/nope/crm", [{"_id": "1"}]),
            ("/deduplication/people/nope", [{"_id": "1"}]),
            (INGEST, [{"name": "no id"}]),
            (INGEST, b"not json"),
            (INGEST, [1, 2]),
            (INGEST + "/httptransform", [{"_id": "1"}]),
            ("/federation/migrate", {"range": "ffffffffffffffff",
                                     "target": 1}),
            ("/federation/migrate", {"nope": 1}),
            ("/federation/migrate", {"range": "0000000000000000",
                                     "target": 9}),
            ("/no/such/route", None),
            ("/no/such/route", [])):
        status, _, raw = both(planes, path, body)
        assert status in (400, 404, 409), (path, status, raw)


@pytest.mark.parametrize("planes", ["device"], indirect=True)
def test_metrics_and_fleet_rollup(planes, every_decision_sampled,
                                  fresh_slo_trackers):
    """The ``duke_fed_*`` samples are equal (latencies by count); the
    rollup's families have the JAX plane's names, types and label names;
    and the port's rollup is the key-wise sum of its groups' own
    collectors (gauges relabeled ``group=``), its device bytes above
    0."""
    assert both(planes, INGEST, duplicate_batch(24))[0] == 200
    drain_flushers(planes)
    scraped, families, expected = {}, {}, {}
    for name, (fed, base, _srv) in planes.items():
        status, _, raw = call(base, "/metrics")
        assert status == 200
        samples, types, labelnames = {}, {}, {}
        for line in raw.decode().splitlines():
            if line.startswith("# TYPE "):
                _, _, fam, mtype = line.split(" ", 3)
                types[fam] = mtype
                continue
            if not line or line.startswith("#"):
                continue
            fam, labels, value = _SAMPLE.match(line).groups()
            pairs = tuple(sorted(_LABEL.findall(labels or "")))
            samples[(fam, pairs)] = float(value)
            base_name = re.sub(r"_(bucket|sum|count)$", "", fam)
            labelnames.setdefault(base_name, set()).update(
                k for k, _ in pairs if k != "le")
        scraped[name] = samples
        families[name] = {fam: (types[fam], sorted(labelnames.get(fam, ())))
                          for fam in types}
        sums, gauges = {}, {}
        for g in fed.groups:
            for fam in METRICS[name].make_group_collector(g)():
                for suffix, labels, value in fam.samples:
                    if fam.mtype == "gauge":
                        gauges[(fam.name + suffix, tuple(sorted(
                            labels + (("group", str(g.idx)),))))] = value
                    else:
                        key = (fam.name + suffix, tuple(sorted(labels)))
                        sums[key] = sums.get(key, 0.0) + value
        expected[name] = (sums, gauges)
    fed_fams = {name: {k: v for k, v in s.items()
                       if k[0].startswith("duke_fed_")
                       and k[0] != "duke_fed_group_seconds_since_contact"
                       and not k[0].startswith(
                           ("duke_fed_range_latency_seconds_bucket",
                            "duke_fed_range_latency_seconds_sum"))}
                for name, s in scraped.items()}
    assert fed_fams["port"] == fed_fams["jax"]
    assert any(k[0] == "duke_fed_subrange_records_total"
               for k in fed_fams["port"])
    # the fleet rollup: every family the port's groups emit is one of the
    # JAX plane's, with its type and label names
    group_fams = {f.name for f in tmetrics.make_group_collector(
        planes["port"][0].groups[0])()}
    for fam in group_fams:
        assert families["port"][fam] == families["jax"][fam], fam
    sums, gauges = expected["port"]
    for key, value in list(sums.items()) + list(gauges.items()):
        assert scraped["port"][key] == pytest.approx(value), key
    for fam in ("duke_engine_records_processed_total",
                "duke_engine_batches_total", "duke_links_rows",
                "duke_corpus_rows"):
        want = {k: v for k, v in scraped["jax"].items() if k[0] == fam}
        assert {k: v for k, v in scraped["port"].items()
                if k[0] == fam} == want, fam
    device = {dict(k[1])["group"]: v for k, v in scraped["port"].items()
              if k[0] == "duke_device_bytes" and "group" in dict(k[1])}
    assert sorted(device) == ["0", "1"] and min(device.values()) > 0


def test_debug_surfaces_equal(planes):
    assert both(planes, INGEST, duplicate_batch(24))[0] == 200
    status, _, raw = both(planes, "/debug/loadmap")
    payload = json.loads(raw)
    assert status == 200 and len(payload["ranges"]) == 4
    assert sum(r["records_total"] for r in payload["ranges"]) == 24
    both(planes, "/debug/probes")
    for path in ("/debug/traces", "/debug/requests", "/debug/costs",
                 "/debug/memory", "/debug/slo", "/debug/profile"):
        keys = {}
        for name, (_fed, base, _srv) in planes.items():
            status, _, raw = call(base, path)
            assert status == 200, (name, path)
            keys[name] = sorted(json.loads(raw))
        assert keys["port"] == keys["jax"], path


def test_retained_federated_trace_equal(planes, monkeypatch):
    """One retained tree spans the plane's root, the router's partition,
    fan-out and merge, and each group's re-anchored ingest."""
    monkeypatch.setenv("TRACE_SAMPLE_RATE", "1.0")
    trees = {}
    for name, (_fed, base, _srv) in planes.items():
        status, headers, _ = call(base, INGEST, duplicate_batch(24))
        assert status == 200
        tid = headers["X-Trace-Id"]
        status, _, raw = call(base, f"/debug/traces/{tid}")
        assert status == 200
        tree = json.loads(raw)
        spans = tree["spans"]
        fanout = next(s for s in spans if s["name"] == "fed.fanout")
        remote = [s for s in spans if s["name"] == "group.ingest"]
        assert {s["attributes"]["group"] for s in remote} == {0, 1}
        assert all(s["parent_id"] == fanout["span_id"] for s in remote)
        trees[name] = (tree["name"],
                       sorted({s["name"] for s in spans
                               if s["name"].startswith(("fed.", "group."))}))
    assert trees["port"] == trees["jax"]


def test_range_prober_on_the_plane_equal(planes):
    """``fed_down`` fails that group's ranges' probes: ``/healthz`` turns
    degraded with them, the rollup counts them, ``/debug/probes`` lists
    them -- as on the JAX plane."""
    for pkg in PKGS:
        prober = planes[pkg.name][2].RequestHandlerClass.range_prober
        assert prober is not None
        prober.run_cycle()
        pkg.faults.configure("fed_down=1")
        prober.run_cycle()
        pkg.faults.configure("")
    status, _, raw = both(planes, "/healthz")
    health = json.loads(raw)
    assert health["status"] == "degraded" and health["probe_failing_ranges"]
    both(planes, "/debug/probes")
    checks = {}
    for name, (_fed, base, _srv) in planes.items():
        text = call(base, "/metrics")[2].decode()
        checks[name] = sorted(line for line in text.splitlines()
                              if line.startswith(
                                  "duke_probe_range_checks_total"))
    assert checks["port"] == checks["jax"] and checks["port"]
