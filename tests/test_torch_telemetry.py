"""The port's telemetry against the JAX package's: the registry and its
Prometheus exposition, the phase recorder, the SLO tracker and feed-lag
meter, the device-byte ledger's once-per-scrape pass, and the live
``/healthz`` / ``/readyz`` / ``/metrics`` surface of a port ``DukeApp``
on the CPU.

Ported from tests/test_telemetry.py (render / merge, phase recorder,
probes, request id, metrics end to end, the lock-free scrape, component
functions once per scrape) and tests/test_observability.py
(``TestSloTracker``, ``TestFeedLagMeter``); where a case is pure
bookkeeping, the same inputs also go through the JAX package's module
and the two renders or snapshots must be equal.
"""

import json
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

from sesam_duke_microservice_tpu.telemetry import registry as jreg
from sesam_duke_microservice_tpu.telemetry import slo as jslo
from sesam_duke_microservice_tpu_torch import telemetry
from sesam_duke_microservice_tpu_torch.core.config import parse_config
from sesam_duke_microservice_tpu_torch.telemetry import costs, memory, slo
from sesam_duke_microservice_tpu_torch.telemetry.registry import (
    FamilySnapshot,
    MetricRegistry,
    PhaseRecorder,
    render,
)

from test_telemetry import _assert_valid_exposition
from torch_jax_cache import jax_cache_off  # noqa: F401

CONFIG_XML = """
<DukeMicroService>
  <Deduplication name="people" link-database-type="in-memory">
    <duke>
      <schema>
        <threshold>0.8</threshold>
        <property><name>NAME</name>
          <comparator>levenshtein</comparator><low>0.1</low><high>0.95</high>
        </property>
      </schema>
      <data-source class="io.sesam.dukemicroservice.IncrementalDeduplicationDataSource">
        <param name="dataset-id" value="crm"/>
        <column name="name" property="NAME"/>
      </data-source>
    </duke>
  </Deduplication>
</DukeMicroService>
"""


# -- registry and exposition ---------------------------------------------------


def _fill_registry(mod):
    """The same families and events through one package's registry."""
    reg = mod.MetricRegistry()
    c = reg.counter("esc_total", "with \"quotes\"\nand newline", ("v",))
    c.labels(v='a"b\\c\nd').inc()
    c.labels(v="plain").inc(2.5)
    g = reg.gauge("g_rows", "a gauge")
    g.set(5)
    g.dec(2)
    h = reg.histogram("lat_seconds", "latency", ("route",),
                      buckets=(0.1, 1.0))
    for v in (0.01, 0.1, 0.5, 50.0):
        h.labels(route="/a").observe(v)
    return reg


def test_render_valid_escaped_and_equal_to_jax():
    text = render(_fill_registry(telemetry))
    types = _assert_valid_exposition(text)
    assert types["esc_total"] == "counter"
    assert types["lat_seconds"] == "histogram"
    assert 'v="a\\"b\\\\c\\nd"' in text
    assert text == jreg.render(_fill_registry(jreg))


def test_render_merges_registries_one_type_block():
    a, b = MetricRegistry(), MetricRegistry()
    a.counter("shared_total", "help", ("side",)).labels(side="a").inc()
    b.counter("shared_total", "help", ("side",)).labels(side="b").inc(2)
    text = render(a, b)
    assert text.count("# TYPE shared_total counter") == 1
    assert 'shared_total{side="a"} 1' in text
    assert 'shared_total{side="b"} 2' in text


def test_registry_semantics():
    reg = MetricRegistry()
    c = reg.counter("req_total", "help", ("route",))
    assert c.labels(route="/a") is c.labels(route="/a")
    with pytest.raises(ValueError):
        c.inc()  # labeled family has no implicit child
    with pytest.raises(ValueError):
        c.labels(route="/a").inc(-1)
    assert reg.counter("req_total", "other help", ("route",)) is c
    with pytest.raises(ValueError):
        reg.gauge("req_total", "help")
    with pytest.raises(ValueError):
        reg.counter("bad-name", "help")


def test_phase_recorder_matches_jax():
    recs = [PhaseRecorder(bounds=(0.1, 1.0)),
            jreg.PhaseRecorder(bounds=(0.1, 1.0))]
    for rec in recs:
        rec.observe("encode", 0.05)
        rec.observe("encode", 0.5)
        rec.observe("score", 2.0)
    rec = recs[0]
    assert rec.phase_seconds() == {"encode": 0.55, "score": 2.0}
    samples = rec.collect_samples((("workload", "w"),))
    # per phase: 3 buckets (0.1, 1.0, +Inf) + _sum + _count
    assert len(samples) == 2 * 5
    encode_count = [v for suffix, labels, v in samples
                    if suffix == "_count" and dict(labels)["phase"] == "encode"]
    assert encode_count == [2]
    assert samples == recs[1].collect_samples((("workload", "w"),))


# -- SLO tracker and feed-lag meter -------------------------------------------


@pytest.fixture()
def _clean_slo():
    slo._reset_for_tests()
    yield
    slo._reset_for_tests()


class TestSloTracker:
    def test_violation_counting_and_histogram(self):
        t = slo.SloTracker(objective_s=0.1, target=0.99)
        now = 1_000_000.0
        t.record_batch([0.05, 0.2, 0.3, 0.01], now)
        (counts, total, count), v_total, windows = t.scrape(now)
        assert count == 4 and v_total == 2
        assert total == pytest.approx(0.56)
        assert sum(counts) == 4
        assert windows["5m"] == (4, 2, pytest.approx((2 / 4) / 0.01))
        assert windows["1h"] == (4, 2, pytest.approx((2 / 4) / 0.01))

    def test_windows_age_out_independently(self):
        """A violation 400 s old burns the 1h window but not the 5m one."""
        t = slo.SloTracker(objective_s=0.1, target=0.99)
        now = 1_000_000.0
        t.record_batch([0.5], now - 400)   # outside 5m, inside 1h
        t.record_batch([0.01], now)        # fresh, within objective
        _, v_total, windows = t.scrape(now)
        assert v_total == 1
        assert windows["5m"][1] == 0
        assert windows["1h"][1] == 1
        assert windows["5m"][2] == 0.0
        assert windows["1h"][2] > 0.0

    def test_burn_rate_one_spends_exactly_the_budget(self):
        """100 requests, 1 violation, target 0.99 -> burn rate 1.0."""
        t = slo.SloTracker(objective_s=0.1, target=0.99)
        now = 1_000_000.0
        t.record_batch([0.01] * 99 + [0.5], now)
        _, _, windows = t.scrape(now)
        assert windows["5m"][2] == pytest.approx(1.0)

    def test_scrape_equals_jax(self):
        port = slo.SloTracker(objective_s=0.1, target=0.99)
        jax_side = jslo.SloTracker(objective_s=0.1, target=0.99)
        now = 1_000_000.0
        for t in (port, jax_side):
            t.record_batch([0.05, 0.2, 0.3, 0.01], now - 500)
            t.record_batch([0.001, 2.0], now - 10)
        assert port.scrape(now) == jax_side.scrape(now)

    def test_tracker_registry_and_objective_env(self, monkeypatch,
                                                _clean_slo):
        monkeypatch.setenv("DUKE_SLO_FEED_MS", "250")
        slo._reset_for_tests()
        t = slo.tracker("feed", "deduplication", "people")
        assert t.objective_s == pytest.approx(0.25)
        assert slo.tracker("feed", "deduplication", "people") is t

    def test_families_always_render_on_global(self, _clean_slo):
        slo.tracker("ingest", "deduplication", "people").record(0.001)
        slo.feed_meter("deduplication", "people").note_write(100.0)
        text = telemetry.render(telemetry.GLOBAL)
        _assert_valid_exposition(text)
        for fam in ("duke_slo_ingest_latency_seconds",
                    "duke_slo_feed_latency_seconds",
                    "duke_slo_violations_total", "duke_slo_burn_rate",
                    "duke_slo_objective_seconds", "duke_feed_lag_seconds",
                    "duke_recovery_replay_remaining_batches",
                    "duke_recovery_replay_applied_total"):
            assert fam in text, fam
        assert 'window="5m"' in text and 'window="1h"' in text


class TestFeedLagMeter:
    def test_lag_ages_from_oldest_pending_write(self):
        m = slo.FeedLagMeter()
        assert m.lag_seconds() == 0.0
        m.note_write(100.0)
        m.note_write(150.0)  # oldest pending stays at 100
        assert m.lag_seconds(160.0) == pytest.approx(60.0)

    def test_drain_resets_to_caught_up(self):
        m = slo.FeedLagMeter()
        m.note_write(100.0)
        m.note_drain()
        assert m.lag_seconds(1000.0) == 0.0
        m.note_write(200.0)
        assert m.lag_seconds(205.0) == pytest.approx(5.0)


# -- cost and device-byte ledgers ---------------------------------------------


def test_cost_ledger_busy_and_utilization():
    costs._reset_for_tests()
    try:
        now = time.monotonic()
        costs.note_busy(0.5, now)
        costs.note_busy(0.25, now)
        costs.note_compile(1.5)
        assert costs.busy_seconds_total() == pytest.approx(0.75)
        assert costs.compile_seconds_total() == pytest.approx(1.5)
        assert 0.0 < costs.utilization(now) <= 1.0
        fams = {f.name: f for f in costs.collect()}
        assert fams["duke_cost_busy_seconds_total"].samples == [
            ("", (), pytest.approx(0.75))]
    finally:
        costs._reset_for_tests()


def test_hbm_component_fns_evaluate_once_per_scrape_pass():
    """However many collectors read ``components_for`` during one
    exposition, each registered fn runs exactly once, and the pass cache
    dies with the render (no staleness outside it)."""
    memory._reset_for_tests()

    class _Owner:
        pass

    n = 200
    calls = [0] * n
    owners = []
    for i in range(n):
        owner = _Owner()
        owners.append(owner)

        def fn(i=i):
            calls[i] += 1
            return {"corpus_tensors": 1024}

        memory.register(owner, "deduplication", f"wl{i}", fn)

    def collector():
        # reads every owner TWICE, like two collectors scanning the same
        # registrations inside one scrape
        samples = []
        for _kind, name, owner, _fn, _logical in memory._iter_live():
            first = memory.components_for(owner)
            assert memory.components_for(owner) == first
            samples.append(
                ("", (("workload", name),), float(sum(first.values()))))
        return [FamilySnapshot("duke_hbm_test_bytes", "gauge", "per-"
                               "tenant test bytes", samples)]

    registry = MetricRegistry()
    registry.register_collector(collector)
    try:
        t0 = time.perf_counter()
        text = render(registry, telemetry.GLOBAL)
        elapsed = time.perf_counter() - t0
        assert text.count("duke_hbm_test_bytes{") == n
        # the GLOBAL collector's totals pass shares the render's snapshot:
        # one evaluation each across every reader of the render
        assert calls == [1] * n, \
            "each component fn must run exactly once per scrape pass"
        headroom = re.search(r"^duke_device_headroom_bytes (\S+)$", text,
                             re.M)
        budget, _ = memory.budget_bytes()
        assert float(headroom.group(1)) == budget - n * 1024
        assert elapsed < 2.0
        # outside a render, reads evaluate fresh every time
        memory.components_for(owners[0])
        assert calls[0] == 2
    finally:
        memory._reset_for_tests()


def test_budget_env_and_cpu_default(monkeypatch):
    monkeypatch.setenv("DUKE_HBM_BUDGET_MB", "3")
    assert memory.budget_bytes() == (3.0 * 1024 * 1024, "env")
    monkeypatch.delenv("DUKE_HBM_BUDGET_MB")
    monkeypatch.setattr(memory, "_cuda_device", None)
    assert memory.budget_bytes() == (float(memory.DEFAULT_BUDGET_BYTES),
                                     "default")
    assert memory.live_arrays_bytes() is None


# -- live service ------------------------------------------------------------


@pytest.fixture()
def live_app():
    import sesam_duke_microservice_tpu_torch.service.app as app_module

    sc = parse_config(CONFIG_XML, env={})
    app = app_module.DukeApp(sc, device="cpu", persistent=False)
    server = app_module.serve(app, port=0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    yield app, url
    server.shutdown()
    server.server_close()
    app.close()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post_json(url, payload):
    req = urllib.request.Request(
        url, json.dumps(payload).encode("utf-8"),
        {"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


def test_health_probes(live_app):
    app, url = live_app
    status, _, body = _get(url + "/healthz")
    assert status == 200 and json.loads(body)["status"] == "ok"
    status, _, _ = _get(url + "/health")  # compat alias
    assert status == 200
    status, _, body = _get(url + "/readyz")
    assert status == 200
    ready = json.loads(body)
    assert ready["status"] == "ready"
    assert ready["checks"] == {
        "config_loaded": True, "recovery_complete": True,
        "workloads_built": True, "device_backend": True,
        "link_persistence": True, "write_ready": True,
    }


def test_request_id_header(live_app):
    app, url = live_app
    _, headers, _ = _get(url + "/healthz")
    rid = headers.get("X-Request-Id")
    assert rid and rid != "-" and len(rid) == 12
    _, headers2, _ = _get(url + "/healthz")
    assert headers2.get("X-Request-Id") != rid


def test_metrics_end_to_end(live_app):
    app, url = live_app
    status, _ = _post_json(url + "/deduplication/people/crm", [
        {"_id": "m1", "name": "ole hansen"},
        {"_id": "m2", "name": "ole hansen"},
    ])
    assert status == 200
    status, headers, body = _get(url + "/metrics")
    assert status == 200
    assert headers["Content-Type"].startswith("text/plain")
    text = body.decode("utf-8")
    types = _assert_valid_exposition(text)
    assert types["duke_http_requests_total"] == "counter"
    assert re.search(
        r'duke_http_requests_total\{route="/deduplication/:name/'
        r':datasetId",method="POST",status="200"\} 1', text)
    assert types["duke_http_request_seconds"] == "histogram"
    assert ('duke_http_request_seconds_bucket{route="/deduplication/:name/'
            ':datasetId",method="POST",le="+Inf"}') in text
    assert types["duke_engine_phase_seconds"] == "histogram"
    for phase in ("encode", "retrieve", "score", "persist"):
        assert re.search(
            r'duke_engine_phase_seconds_count\{kind="deduplication",'
            rf'workload="people",phase="{phase}"\}} 1', text)
    assert types["duke_corpus_rows"] == "gauge"
    assert re.search(
        r'duke_corpus_rows\{kind="deduplication",workload="people",'
        r'state="live"\} 2', text)
    assert re.search(
        r'duke_links_rows\{kind="deduplication",workload="people"\} 1', text)
    assert re.search(r'duke_query_blocks_total\{bucket="\d+"\} \d+', text)
    assert re.search(
        r'duke_device_bytes\{kind="deduplication",workload="people",'
        r'component="corpus_tensors"\} [1-9]', text)
    assert 'duke_build_info{version="0.1.0",torch="' in text
    for fam in ("duke_http_requests_in_flight",
                "duke_http_request_bytes_total",
                "duke_http_response_bytes_total", "duke_uptime_seconds",
                "duke_backend_info", "duke_sched_microbatch_records",
                "duke_cost_busy_seconds_total", "duke_cold_start_seconds"):
        assert fam in text, fam
    # the cost ledger reconciles: this app's per-phase seconds are a part
    # of the process-wide busy total
    phase_sum = sum(float(v) for v in re.findall(
        r'^duke_cost_device_seconds_total\{[^}]*\} (\S+)$', text, re.M))
    busy = float(re.search(r"^duke_cost_busy_seconds_total (\S+)$", text,
                           re.M).group(1))
    assert 0.0 < phase_sum <= busy + 1e-9


def test_busy_503_counter(live_app):
    import sesam_duke_microservice_tpu_torch.service.app as app_module

    app, url = live_app
    wl = app.deduplications["people"]
    old_timeout = app_module.READ_LOCK_TIMEOUT_SECONDS
    app_module.READ_LOCK_TIMEOUT_SECONDS = 0.05
    try:
        with wl.lock:
            status, headers, body = _get(url + "/deduplication/people")
            assert status == 503 and b"being written to" in body
            assert headers.get("Retry-After") == "1"
            # /readyz still answers while a workload is write-locked and
            # its answers never count as busy
            status, _, _ = _get(url + "/readyz")
            assert status == 200
    finally:
        app_module.READ_LOCK_TIMEOUT_SECONDS = old_timeout
    _, _, body = _get(url + "/metrics")
    text = body.decode("utf-8")
    assert re.search(
        r'duke_http_busy_total\{route="/deduplication/:name"\} 1', text)
    assert re.search(
        r'duke_http_requests_total\{route="/deduplication/:name",'
        r'method="GET",status="503"\} 1', text)


def test_metrics_scrape_is_lock_free_under_held_workload_lock(live_app):
    """A scrape must complete while a writer holds the workload lock."""
    app, url = live_app
    wl = app.deduplications["people"]
    result = {}

    def scrape():
        result["metrics"] = _get(url + "/metrics")
        result["stats"] = _get(url + "/stats")

    with wl.lock:
        t = threading.Thread(target=scrape, daemon=True)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive(), "/metrics blocked on the workload lock"
    assert result["metrics"][0] == 200 and result["stats"][0] == 200
