"""The port's canary prober against the JAX package's, on the CPU.

* ``derive_canaries`` (keys, column values, oracle probabilities and
  verdicts) equal to the JAX package's on the probe, stresstest and mixed
  schemas;
* ``run_cycle`` summaries equal to the JAX package's bar the trace ids
  and times, on the ``host`` backend (the JAX package's default) and the
  ``device`` backend (the port's);
* the invisibility differential: the user feed and link rows with the
  prober on (cycles around the user ingest) are byte-identical to
  ``DUKE_PROBE=0``;
* the HTTP surface over both services: the ``__probe__`` refusals, the
  ``/healthz`` detail and ``/debug/probes`` after a ``probe_flip`` drill,
  and the ``duke_probe_*`` families a subset of the JAX package's with
  equal values (the latency histograms by count: their buckets are
  timings);
* a shadow build on the device backend runs no nvcc or g++ build.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest

from sesam_duke_microservice_tpu.core.config import parse_config as jparse
from sesam_duke_microservice_tpu.service.app import DukeApp as JApp
from sesam_duke_microservice_tpu.service.app import serve as jserve
from sesam_duke_microservice_tpu.telemetry import probes as jprobes
from sesam_duke_microservice_tpu.telemetry import slo as jslo
from sesam_duke_microservice_tpu.telemetry import tracing as jtracing
from sesam_duke_microservice_tpu.utils import faults as jfaults
from sesam_duke_microservice_tpu_torch.core.config import (
    parse_config as tparse,
)
from sesam_duke_microservice_tpu_torch.service.app import DukeApp as TApp
from sesam_duke_microservice_tpu_torch.service.app import serve as tserve
from sesam_duke_microservice_tpu_torch.telemetry import costs as tcosts
from sesam_duke_microservice_tpu_torch.telemetry import probes as tprobes
from sesam_duke_microservice_tpu_torch.telemetry import slo as tslo
from sesam_duke_microservice_tpu_torch.telemetry import tracing as ttracing
from sesam_duke_microservice_tpu_torch.utils import faults as tfaults

from test_observability import parse_exposition
from test_probes import CONFIG_XML, DEDUP_ONLY_XML, USER_BATCH, user_feed
from test_probes import user_links
from test_torch_finalize import _config as mixed_config
from test_torch_slice import CONFIG_XML as STRESS_XML
from torch_jax_cache import jax_cache_off  # noqa: F401

SCHEMAS = {"probe": CONFIG_XML, "stresstest": STRESS_XML,
           "mixed": mixed_config("mixed")}


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    monkeypatch.setenv("DUKE_PROBE", "1")
    monkeypatch.setenv("DUKE_PROBE_INTERVAL_S", "3600")
    monkeypatch.setenv("MIN_RELEVANCE", "0.05")
    for faults, slo in ((jfaults, jslo), (tfaults, tslo)):
        faults.configure("")
        slo._reset_for_tests()
    yield
    for faults, slo, tracing in ((jfaults, jslo, jtracing),
                                 (tfaults, tslo, ttracing)):
        faults.configure(None)
        slo._reset_for_tests()
        tracing.RECORDER.clear()


def make_apps(xml, backend="host"):
    """(JAX app, port app) on ``xml``, both in memory."""
    japp = JApp(jparse(xml), backend=backend, persistent=False)
    tapp = TApp(tparse(xml), backend=backend, device="cpu",
                persistent=False)
    return japp, tapp


def canary_rows(app):
    return {key: [(c.key, c.values_a, c.values_b, c.expected_prob,
                   c.expected_verdict) for c in entry.corpus]
            for key, entry in app.prober._shadows.items()}


def strip_summary(summary):
    """A cycle summary without what differs run to run: its trace id and
    its times."""
    return {k: v for k, v in summary.items()
            if k not in ("trace_id", "seconds", "time_unix")}


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_derive_canaries_equal_jax(schema):
    apps = make_apps(SCHEMAS[schema])
    try:
        results = [app.prober.run_cycle() for app in apps]
        rows = [canary_rows(app) for app in apps]
    finally:
        for app in apps:
            app.close()
    assert rows[1] == rows[0]
    assert all(rows[1].values())
    for corpus in rows[1].values():
        verdicts = {key: verdict for key, *_, verdict in corpus}
        assert verdicts["identical"] == "match"
        assert verdicts["disjoint"] == "reject"
    assert all(r["ok"] for r in results[1].values())


def test_token_and_perturbations_equal_jax():
    for parts in (("pair", "NAME", "ab"), ("identical", "SSN", "ab"),
                  ("disjoint", "GIVEN", "a"), ("far-NAME", "NAME", "b")):
        value = tprobes._token(*parts)
        assert value == jprobes._token(*parts)
        assert tprobes._perturb_light(value) == jprobes._perturb_light(value)
        assert tprobes._perturb_heavy(value) == jprobes._perturb_heavy(value)
        head = value.split(" ")[0]
        assert tprobes._perturb_light(value).split(" ")[0] == head
        assert tprobes._perturb_heavy(value).split(" ")[0] == head


@pytest.mark.parametrize("backend,xml", [("host", CONFIG_XML),
                                         ("device", DEDUP_ONLY_XML)],
                         ids=["host", "device"])
def test_run_cycle_summaries_equal_jax(backend, xml):
    apps = make_apps(xml, backend)
    try:
        first = [app.prober.run_cycle() for app in apps]
        for app in apps:
            app.scheduler.submit("deduplication", "people", "crm",
                                 list(USER_BATCH))
        second = [app.prober.run_cycle() for app in apps]
        snaps = [app.prober.debug_snapshot() for app in apps]
    finally:
        for app in apps:
            app.close()
    for (jres, tres) in (first, second):
        assert set(tres) == set(jres)
        for key in jres:
            assert strip_summary(tres[key]) == strip_summary(jres[key]), key
            assert tres[key]["ok"] and tres[key]["trace_id"]
    # "compiles": XLA compiles on the JAX side, nvcc / g++ builds on the
    # port's -- none, the kernels build once per process
    assert all(row.pop("probe_compiles") == 0
               for row in snaps[1]["workloads"])
    for snap in snaps:
        for row in snap["workloads"]:
            for field in ("freshness_seconds", "last", "history",
                          "probe_compiles"):
                row.pop(field, None)
    assert snaps[1] == snaps[0]


def test_user_feed_and_links_identical_prober_on_off(monkeypatch):
    """Probe cycles around the user ingest change nothing the user sees
    (the port's default device backend)."""
    _, app_on = make_apps(CONFIG_XML, "device")
    try:
        assert app_on.prober is not None
        app_on.prober.run_cycle()
        app_on.scheduler.submit("deduplication", "people", "crm",
                                list(USER_BATCH))
        app_on.prober.run_cycle()
        wl = app_on.deduplications["people"]
        on = (user_feed(wl), user_links(wl))
        assert len(app_on.prober._shadows) == 2
        assert app_on._resolve_workload(
            "deduplication", tprobes.probe_name("people")) is not None
        assert app_on._resolve_workload(
            "deduplication", tprobes.probe_name("nope")) is None
    finally:
        app_on.close()
    monkeypatch.setenv("DUKE_PROBE", "0")
    app_off = TApp(tparse(CONFIG_XML), device="cpu", persistent=False)
    try:
        assert app_off.prober is None
        app_off.scheduler.submit("deduplication", "people", "crm",
                                 list(USER_BATCH))
        wl = app_off.deduplications["people"]
        off = (user_feed(wl), user_links(wl))
    finally:
        app_off.close()
    assert on == off
    assert on[0]
    assert not any(tprobes.PROBE_PREFIX in row for row in on[0])
    assert not any(tprobes.is_probe_name(n) for n in app_on.deduplications)
    assert not any(tprobes.is_probe_name(n) for n in app_on.record_linkages)


def _request(url, method="GET", body=None):
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture()
def served():
    apps = make_apps(CONFIG_XML)
    servers = [(jserve if i == 0 else tserve)(app, port=0, host="127.0.0.1")
               for i, app in enumerate(apps)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    yield apps, [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
    for s in servers:
        s.shutdown()
        s.server_close()
    for t in threads:
        t.join(timeout=10)
    for app in apps:
        app.close()


def test_probe_namespace_refusals_equal_jax(served):
    apps, urls = served
    for app in apps:
        app.prober.run_cycle()  # the shadows exist, and stay unreachable
    body = json.dumps(USER_BATCH).encode()
    p = jprobes.PROBE_PREFIX
    replies = [[
        _request(f"{url}/deduplication/{p}people/{p}crm", "POST", body),
        _request(f"{url}/deduplication/people/{p}crm", "POST", body),
        _request(f"{url}/deduplication/{p}people"),
        _request(f"{url}/recordlinkage/{p}pairing?since=0"),
    ] for url in urls]
    assert replies[1] == replies[0]
    assert [status for status, _ in replies[1]] == [404, 404, 400, 400]
    assert b"reserved" in replies[1][2][1]


def _probe_metrics(url):
    scraped = parse_exposition(_request(url + "/metrics")[1].decode())
    return {k: v for k, v in scraped.items()
            if k[0].startswith("duke_probe_")}


def test_green_cycle_then_flip_drill_equal_jax(served):
    apps, urls = served
    results = [app.prober.run_cycle() for app in apps]
    assert all(r["ok"] for res in results for r in res.values())
    healths = [json.loads(_request(u + "/healthz")[1]) for u in urls]
    assert healths[1] == healths[0] == {"status": "ok"}
    metrics = [_probe_metrics(u) for u in urls]
    for key, value in metrics[1].items():
        assert key in metrics[0], key
        if key[0] in ("duke_probe_e2e_seconds_bucket",
                      "duke_probe_e2e_seconds_sum",
                      "duke_probe_freshness_seconds"):
            continue  # timings
        assert value == metrics[0][key], key
    assert {k[0] for k in metrics[1]} == {k[0] for k in metrics[0]}

    # the drill: one corrupted verdict, caught within the cycle
    for faults in (jfaults, tfaults):
        faults.configure("probe_flip=1")
    for app in apps:
        app.prober.run_cycle()
    healths = [json.loads(_request(u + "/healthz")[1]) for u in urls]
    assert healths[1] == healths[0]
    assert healths[1]["status"] == "degraded"
    assert healths[1]["probe_verdict_mismatches"]["verdict_mismatches"] == 1
    dbg = [json.loads(_request(u + "/debug/probes")[1]) for u in urls]
    for d in dbg:
        for row in d["mismatches"]:
            for field in ("id", "time_unix", "trace_id", "trace",
                          "decision_ids", "decisions"):
                row.pop(field)
        for row in d["workloads"]:
            for field in ("freshness_seconds", "last", "history"):
                row.pop(field)
    assert dbg[1] == dbg[0]
    assert len(dbg[1]["mismatches"]) == 1
    metrics = [_probe_metrics(u) for u in urls]
    mism = [{k: v for k, v in m.items()
             if k[0] == "duke_probe_verdict_mismatches_total"}
            for m in metrics]
    assert mism[1] == mism[0] and sum(mism[1].values()) == 1
    # latched: a clean cycle heals the feed, not the incident
    for faults in (jfaults, tfaults):
        faults.configure("")
    for app in apps:
        app.prober.run_cycle()
    healths = [json.loads(_request(u + "/healthz")[1]) for u in urls]
    assert healths[1] == healths[0]
    assert healths[1]["status"] == "degraded"


def test_probe_disabled_answers_like_jax(monkeypatch):
    monkeypatch.setenv("DUKE_PROBE", "0")
    apps = make_apps(DEDUP_ONLY_XML)
    try:
        assert apps[0].prober is None and apps[1].prober is None
        from sesam_duke_microservice_tpu.service import debug as jdebug
        from sesam_duke_microservice_tpu_torch.service import debug as tdebug

        assert tdebug.handle_probes(None) == jdebug.handle_probes(None)
    finally:
        for app in apps:
            app.close()


def test_shadow_build_runs_no_native_build():
    """The kernels and the host library build once per process: a probe
    cycle on the device backend adds no nvcc or g++ build."""
    app = TApp(tparse(DEDUP_ONLY_XML), device="cpu", persistent=False)
    try:
        app.scheduler.submit("deduplication", "people", "crm",
                             list(USER_BATCH))
        before = tcosts.compile_count()
        results = app.prober.run_cycle()
        assert results[("deduplication", "people")]["ok"]
        assert tcosts.compile_count() == before
        state = app.prober._shadows[("deduplication", "people")].state
        assert state.probe_compiles == 0
        # the shadow runs on the app's device and never in its registries
        shadow = app.prober._shadows[("deduplication", "people")].workload
        assert shadow.index.device == app.device
    finally:
        app.close()
