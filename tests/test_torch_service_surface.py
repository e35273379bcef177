"""The port's control and read surface against the JAX package's, over
real HTTP on ephemeral ports.

JAX ``DukeApp(backend="device")`` (JAX on the CPU) and the port's
``DukeApp(device="cpu")`` take the same config and the same seeded
traffic; then:

  * ``GET /`` and ``GET /config`` answer the same bytes, a multipart
    ``POST /config`` swaps the config (302 to ``/``) and a malformed one
    answers 400 and keeps the old config;
  * ``/health``, ``/healthz`` and ``/readyz`` answer the same JSON, a
    body over ``MAX_REQUEST_BYTES`` the same 413;
  * ``/stats`` is equal except ``platform``, ``device_count``,
    ``uptime_seconds`` and the clocks (the ``*_seconds`` fields and the
    scheduler's two timing estimates, ``sec_per_record_ewma`` and
    ``avg_wait_ms``); both apps record decisions at the JAX default, and
    each workload's ``decisions`` block compares on its stable fields
    (``outcomes``, ``disagreements``, ``latched``), not ``ring``, which
    holds the randomly sampled records too;
  * the port's ``/metrics`` families are a subset of the JAX app's with
    equal types and label names -- the names each registry declares, or
    for a collector's family the label keys of its samples
    (``duke_build_info`` carries ``torch`` where the JAX package carries
    ``jax``) -- and the deterministic counters are equal;
  * the chunked ``?since=`` feed is byte-identical at ``FEED_PAGE_SIZE``
    1, 7 and 5000, chunk framing included, and so is the HTTP/1.0
    buffered feed;
  * a reload sequence (POST, ``POST /config`` with a changed threshold
    and an added workload, POST to both, feeds) gives equal event tapes
    and feeds, the persistent device workloads restoring through the
    corpus snapshot.

Ported from tests/test_service.py: the homepage, ``/config`` verbatim,
multipart upload and rollback, health, stats and stats lock-free under
ingest, the device reload through the corpus snapshot, the 413, feed
pages with a bounded lock hold, no skipped or duplicated ties, and the
abort on mid-stream workload removal; plus concurrent POSTs across
reloads (every request answers, none deadlocks, every acked record
survives) and a queued request whose workload a reload removed (404).
Link clocks are fixed counters (one per package), so feeds compare with
their timestamps.
"""

import contextlib
import http.client
import itertools
import json
import os
import re
import socket
import statistics
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from sesam_duke_microservice_tpu import telemetry as jtelemetry
from sesam_duke_microservice_tpu.core.config import parse_config as jparse
from sesam_duke_microservice_tpu.links import base as jlinkbase
from sesam_duke_microservice_tpu.service.app import DukeApp as JApp
from sesam_duke_microservice_tpu.service.app import serve as jserve
from sesam_duke_microservice_tpu_torch import telemetry as ttelemetry
from sesam_duke_microservice_tpu_torch.core.config import (
    parse_config as tparse,
)
from sesam_duke_microservice_tpu_torch.engine.device_matcher import (
    DeviceIndex,
)
from sesam_duke_microservice_tpu_torch.engine.scheduler import (
    IngestScheduler,
)
from sesam_duke_microservice_tpu_torch.links import base as tlinkbase
from sesam_duke_microservice_tpu_torch.links.base import (
    Link,
    LinkKind,
    LinkStatus,
)
from sesam_duke_microservice_tpu_torch.service import app as tapp_module
from sesam_duke_microservice_tpu_torch.service.app import DukeApp as TApp
from sesam_duke_microservice_tpu_torch.service.app import serve as tserve

from test_torch_slice import _Tape
from torch_jax_cache import jax_cache_off  # noqa: F401

CONFIG_XML = """
<DukeMicroService{folder}>
  <Deduplication name="people"{linkdb}>
    <duke>
      <schema>
        <threshold>{threshold}</threshold>
        <property><name>NAME</name>
          <comparator>levenshtein</comparator><low>0.1</low><high>0.95</high>
        </property>
        <property><name>EMAIL</name>
          <comparator>exact</comparator><low>0.2</low><high>0.95</high>
        </property>
      </schema>
      <data-source class="io.sesam.dukemicroservice.IncrementalDeduplicationDataSource">
        <param name="dataset-id" value="crm"/>
        <column name="name" property="NAME"
                cleaner="no.priv.garshol.duke.cleaners.LowerCaseNormalizeCleaner"/>
        <column name="email" property="EMAIL"/>
      </data-source>
      <data-source class="io.sesam.dukemicroservice.IncrementalDeduplicationDataSource">
        <param name="dataset-id" value="web"/>
        <column name="name" property="NAME"
                cleaner="no.priv.garshol.duke.cleaners.LowerCaseNormalizeCleaner"/>
        <column name="email" property="EMAIL"/>
      </data-source>
    </duke>
  </Deduplication>{extra}
  <RecordLinkage name="pairing" link-mode="one-to-one"{linkdb}>
    <duke>
      <schema>
        <threshold>0.7</threshold>
        <property><name>NAME</name>
          <comparator>levenshtein</comparator><low>0.1</low><high>0.95</high>
        </property>
      </schema>
      <group>
        <data-source class="io.sesam.dukemicroservice.IncrementalRecordLinkageDataSource">
          <param name="dataset-id" value="left"/>
          <column name="name" property="NAME"/>
        </data-source>
      </group>
      <group>
        <data-source class="io.sesam.dukemicroservice.IncrementalRecordLinkageDataSource">
          <param name="dataset-id" value="right"/>
          <column name="name" property="NAME"/>
        </data-source>
      </group>
    </duke>
  </RecordLinkage>
</DukeMicroService>
"""

EXTRA_WORKLOAD = """
  <Deduplication name="people2"{linkdb}>
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
  </Deduplication>"""


def config_xml(folder=None, threshold="0.8", extra=False):
    """The test config: in-memory link databases, or with ``folder`` a
    persistent ``dataFolder`` (SQLite links behind write-behind)."""
    linkdb = "" if folder else ' link-database-type="in-memory"'
    return CONFIG_XML.format(
        folder=f' dataFolder="{folder}"' if folder else "",
        linkdb=linkdb, threshold=threshold,
        extra=EXTRA_WORKLOAD.format(linkdb=linkdb) if extra else "")


_FIRST = ["anne", "bjorn", "carl", "dina", "erik", "frida", "geir", "hege"]
_LAST = ["hansen", "johansen", "olsen", "larsen", "andersen", "pedersen"]


def entities(n, seed, prefix):
    """Seeded people; every third one a near-duplicate (one edit in the
    name, the same email) of an earlier one."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if out and i % 3 == 2:
            src = out[int(rng.integers(len(out)))]
            name = src["name"]
            pos = int(rng.integers(len(name)))
            out.append(dict(src, _id=f"{prefix}{i}",
                            name=name[:pos] + "x" + name[pos + 1:]))
        else:
            out.append({
                "_id": f"{prefix}{i}",
                "name": f"{_FIRST[int(rng.integers(len(_FIRST)))]} "
                        f"{_LAST[int(rng.integers(len(_LAST)))]}",
                "email": f"{int(rng.integers(40))}@x.no"})
    return out


@pytest.fixture(autouse=True)
def _fixed_clocks(monkeypatch):
    # one link clock per package, each a counter: both packages make the
    # same links in the same order, so their timestamps agree
    for base in (jlinkbase, tlinkbase):
        ticks = itertools.count(1_700_000_000_000)
        monkeypatch.setattr(base, "now_millis", lambda t=ticks: next(t))
    for knob in ("FEED_PAGE_SIZE", "MAX_REQUEST_BYTES", "DUKE_SCHEDULER",
                 "DUKE_FAULTS"):
        monkeypatch.delenv(knob, raising=False)
    # the feature cache is off by default in the port (on in the JAX
    # package): off on both sides, so /stats compares its block
    monkeypatch.setenv("DUKE_FEATURE_CACHE_MB", "0")


def jax_app(xml, persistent=False):
    return JApp(jparse(xml), backend="device", persistent=persistent)


def port_app(xml, persistent=False):
    return TApp(tparse(xml), device="cpu", persistent=persistent)


@contextlib.contextmanager
def served(*apps):
    """Serve each app (JAX or port) on an ephemeral port; yields the base
    URLs and closes everything on exit."""
    servers = [(jserve if isinstance(app, JApp) else tserve)(
        app, port=0, host="127.0.0.1") for app in apps]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    try:
        yield [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(timeout=10)
        for app in apps:
            app.close()


@pytest.fixture()
def pair():
    """(JAX app, port app) on the in-memory config, served."""
    xml = config_xml()
    apps = (jax_app(xml), port_app(xml))
    with served(*apps) as urls:
        yield apps, urls


@pytest.fixture()
def port_only():
    app = port_app(config_xml())
    with served(app) as (url,):
        yield app, url


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *args, **kwargs):
        return None


_opener = urllib.request.build_opener(_NoRedirect)


def request(url, method="GET", body=None, headers=None, timeout=60):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    try:
        with _opener.open(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def post_json(url, payload):
    return request(url, "POST", json.dumps(payload).encode(),
                   {"Content-Type": "application/json"})


def post_both(urls, path, payload):
    """The same POST to every app, in order; every answer must be 200."""
    for url in urls:
        status, _, body = post_json(url + path, payload)
        assert status == 200, (url, status, body)


def raw_get(url, path, version="HTTP/1.1"):
    """(status line, body bytes exactly as sent, chunk framing included)
    of one GET on a fresh connection the server closes afterwards."""
    host, port = url.rsplit("/", 1)[-1].split(":")
    with socket.create_connection((host, int(port)), timeout=60) as sock:
        sock.sendall(f"GET {path} {version}\r\nHost: {host}\r\n"
                     "Connection: close\r\n\r\n".encode())
        data = b""
        while True:
            chunk = sock.recv(1 << 16)
            if not chunk:
                break
            data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    return head.split(b"\r\n")[0], body


def multipart(xml, boundary="----testboundary42"):
    body = (
        f"--{boundary}\r\n"
        'Content-Disposition: form-data; name="configfile"; '
        'filename="c.xml"\r\n'
        "Content-Type: application/xml\r\n\r\n"
        f"{xml}\r\n"
        f"--{boundary}--\r\n"
    ).encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


# -- homepage, config, probes, 413 ---------------------------------------------


def test_homepage_and_config_bytes_equal_jax(pair):
    apps, urls = pair
    homes = [request(u + "/") for u in urls]
    status, headers, body = homes[1]
    assert status == 200 and "text/html" in headers["Content-Type"]
    text = body.decode()
    assert "/deduplication/people/crm" in text
    assert "/recordlinkage/pairing/left" in text
    assert "configfile" in text
    assert body == homes[0][2]
    configs = [request(u + "/config") for u in urls]
    status, headers, body = configs[1]
    assert status == 200
    assert headers["Content-Type"].startswith("application/xml")
    assert body.decode() == config_xml()
    assert body == configs[0][2]


def test_config_upload_multipart_and_rollback(pair):
    apps, urls = pair
    new_config = config_xml().replace('name="people"', 'name="people2"')
    for url in urls:
        status, headers, _ = request(url + "/config", "POST",
                                     *multipart(new_config))
        assert status == 302 and headers["Location"] == "/"
        # new workload active, old gone
        assert post_json(url + "/deduplication/people2/crm", [])[0] == 200
        status, _, body = post_json(url + "/deduplication/people/crm", [])
        assert status == 404 and b"Unknown deduplication 'people'" in body
        assert request(url + "/config")[2].decode() == new_config
        # invalid upload -> 400, old config stays active
        status, _, body = request(url + "/config", "POST", b"<Bogus/>",
                                  {"Content-Type": "application/xml"})
        assert status == 400 and body.startswith(b"Invalid configuration")
        assert post_json(url + "/deduplication/people2/crm", [])[0] == 200
        assert request(url + "/config")[2].decode() == new_config
        # a multipart body without the field
        status, _, _ = request(url + "/config", "POST",
                               b"--b\r\n\r\n--b--\r\n",
                               {"Content-Type":
                                "multipart/form-data; boundary=b"})
        assert status == 400
        # the raw-body convenience upload
        status, _, _ = request(url + "/config", "POST",
                               config_xml().encode(),
                               {"Content-Type": "application/xml"})
        assert status == 302
    assert request(urls[0] + "/")[2] == request(urls[1] + "/")[2]


def test_health_readyz_equal_jax(pair):
    apps, urls = pair
    answers = {path: [request(u + path) for u in urls]
               for path in ("/health", "/healthz", "/readyz")}
    for path, (jax_side, port) in answers.items():
        assert port[0] == jax_side[0] == 200, path
        assert json.loads(port[2]) == json.loads(jax_side[2]), path
        assert port[1]["X-Request-Id"] != "-"
    assert json.loads(answers["/health"][1][2]) == {"status": "ok"}
    assert json.loads(answers["/readyz"][1][2])["status"] == "ready"


def test_oversized_post_answers_413(pair, monkeypatch):
    """Bodies over MAX_REQUEST_BYTES are refused before being read, with
    the connection closed."""
    apps, urls = pair
    monkeypatch.setenv("MAX_REQUEST_BYTES", "1024")
    big = json.dumps([{"_id": "big", "name": "x" * 4096}]).encode()
    answers = []
    for url in urls:
        status, headers, body = request(
            url + "/deduplication/people/crm", "POST", big,
            {"Content-Type": "application/json"})
        assert status == 413 and b"MAX_REQUEST_BYTES" in body
        answers.append(body)
        # the unread body must not be parsed as a next request: the
        # server closes the connection after the 413 (EOF, no timeout)
        host, port = url.rsplit("/", 1)[-1].split(":")
        with socket.create_connection((host, int(port)), timeout=10) as sock:
            sock.sendall(b"POST /deduplication/people/crm HTTP/1.1\r\n"
                         b"Host: x\r\nContent-Length: %d\r\n\r\n"
                         % len(big) + big)
            data = b""
            while chunk := sock.recv(1 << 16):
                data += chunk
        assert data.startswith(b"HTTP/1.1 413")
        # under the limit still works
        ok = json.dumps([{"_id": "ok", "name": "fits"}]).encode()
        status, _, _ = request(url + "/deduplication/people/crm", "POST",
                               ok, {"Content-Type": "application/json"})
        assert status == 200
    assert answers[0] == answers[1]


# -- /stats and /metrics -------------------------------------------------------

_STATS_CLOCKS = ("platform", "device_count", "uptime_seconds")
_SCHEDULER_CLOCKS = ("sec_per_record_ewma", "avg_wait_ms")


def comparable_stats(payload):
    """/stats without the fields that hold the platform or a clock."""
    out = {k: v for k, v in payload.items() if k not in _STATS_CLOCKS}
    for row in out["workloads"]:
        for key in [k for k in row if k.endswith("_seconds")]:
            value = row.pop(key)
            if isinstance(value, dict):  # phase_seconds: the phases seen
                row[key + "_phases"] = sorted(value)
    for row in out["workloads"]:
        decisions = row.get("decisions")
        if decisions is not None:  # ring: the sampled records too
            row["decisions"] = {k: decisions[k] for k in
                                ("outcomes", "disagreements", "latched")}
    sched = out.get("scheduler")
    if sched is not None:
        for key in _SCHEDULER_CLOCKS:
            sched.pop(key, None)
        for row in sched["workloads"]:
            for key in _SCHEDULER_CLOCKS:
                row.pop(key, None)
    return out


def drive_traffic(urls):
    """Seeded POSTs, in order, the same on every app: two crm batches,
    one web batch with copies of crm records, one linkage batch per
    side, a delete."""
    crm = entities(24, 11, "c")
    post_both(urls, "/deduplication/people/crm", crm[:12])
    post_both(urls, "/deduplication/people/crm", crm[12:])
    web = [dict(e, _id="w" + e["_id"]) for e in crm[::4]]
    post_both(urls, "/deduplication/people/web", web)
    left = [{"_id": f"l{i}", "name": e["name"]}
            for i, e in enumerate(crm[:6])]
    right = [{"_id": f"r{i}", "name": e["name"]}
             for i, e in enumerate(crm[3:9])]
    post_both(urls, "/recordlinkage/pairing/left", left)
    post_both(urls, "/recordlinkage/pairing/right", right)
    post_both(urls, "/deduplication/people/crm",
              [{"_id": "c1", "_deleted": True}])


def test_stats_equal_jax(pair):
    apps, urls = pair
    drive_traffic(urls)
    jax_side, port = (json.loads(request(u + "/stats")[2]) for u in urls)
    assert port["platform"] == "cpu" and port["device_count"] == 1
    assert port["uptime_seconds"] >= 0
    people = next(w for w in port["workloads"] if w["name"] == "people")
    assert people["records_indexed"] == 29 and people["batches"] == 3
    assert set(people["phase_seconds"]) == {
        "encode", "retrieve", "score", "persist"}
    assert port["scheduler"]["workloads"][0]["microbatches"] >= 1
    assert sum(people["decisions"]["outcomes"].values()) > 0
    assert comparable_stats(port) == comparable_stats(jax_side)


_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$")


def parse_metrics(text):
    """{family: type}, {family: set of label-key tuples}, {(name, labels):
    value}."""
    types, keys, values = {}, {}, {}
    suffixes = ("_bucket", "_sum", "_count")
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(" ", 3)
            types[name] = mtype
            keys.setdefault(name, set())
            continue
        if not line or line.startswith("#"):
            continue
        name, _, labels, value = _SAMPLE.match(line).groups()
        pairs = tuple(re.findall(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:\\.|[^"\\])*)"',
                                 labels or ""))
        family = name
        if name not in types:
            family = next(name[:-len(s)] for s in suffixes
                          if name.endswith(s) and name[:-len(s)] in types)
        keys[family].add(tuple(k for k, _ in pairs if k != "le"))
        values[(name, pairs)] = float(value)
    return types, keys, values


# families whose values are the same function of the same traffic in
# both packages, from each app's own registry or collector (so only this
# test's traffic wrote them)
_DETERMINISTIC = ("duke_http_requests_total", "duke_engine_batches_total",
                  "duke_engine_records_processed_total", "duke_corpus_rows",
                  "duke_links_rows", "duke_decisions_total",
                  "duke_decision_disagreements_total", "duke_pair_logit",
                  "duke_property_similarity")
# process-wide counters, compared as before/after deltas of the traffic
_DELTAS = ("duke_snapshot_fallbacks_total",
           "duke_corpus_capacity_growths_total",
           "duke_stream_append_slices_total")


def declared_labels(*registries):
    """{family: declared label names} of the registries' families: what
    a family's samples may carry, known without any sample -- so the
    check cannot depend on which earlier tests in the process wrote
    process-wide (``GLOBAL``) families on one side only."""
    return {name: fam.labelnames for reg in registries
            for name, fam in reg._families.items()}


@pytest.fixture()
def every_decision_sampled(monkeypatch):
    """Both recorders sample every breakdown: at the default rate (0.01,
    an unseeded draw per decision) whether ``duke_property_similarity``
    exists on either side is a coin toss on this test's few decisions.
    Requested before ``pair``, so both apps are built with it."""
    monkeypatch.setenv("DUKE_DECISION_SAMPLE", "1")


@pytest.fixture()
def fresh_slo_trackers():
    """The SLO trackers are process-wide: a port-only test that ran
    earlier in this process (a feed read, say) leaves trackers whose
    samples the JAX side lacks.  Cleared on both sides before the apps
    are built, so the SLO families hold only this test's traffic."""
    for tel in (jtelemetry, ttelemetry):
        tel.slo._reset_for_tests()
    yield
    for tel in (jtelemetry, ttelemetry):
        tel.slo._reset_for_tests()


@pytest.fixture()
def fresh_mesh_gauge():
    """``duke_mesh_devices`` is process-wide on both sides and set when a
    mesh is built: a mesh test earlier in this process leaves one side at
    8 and the other at 0 (the port's mesh tests drop their mesh, the JAX
    package keeps its own).  Zeroed on both sides for the test -- neither
    app here builds a mesh -- and put back after."""
    gauges = [tel.MESH_DEVICES.single() for tel in (jtelemetry, ttelemetry)]
    saved = [g.value for g in gauges]
    for g in gauges:
        g.set(0)
    yield
    for g, value in zip(gauges, saved):
        g.set(value)


def test_metrics_families_subset_of_jax_with_equal_values(
        every_decision_sampled, fresh_slo_trackers, fresh_mesh_gauge, pair):
    apps, urls = pair
    before = [parse_metrics(request(u + "/metrics")[2].decode())[2]
              for u in urls]
    drive_traffic(urls)
    scraped = [parse_metrics(request(u + "/metrics")[2].decode())
               for u in urls]
    (jtypes, jkeys, jvalues), (ttypes, tkeys, tvalues) = scraped
    assert set(ttypes) <= set(jtypes), sorted(set(ttypes) - set(jtypes))
    jdecl = declared_labels(apps[0].metrics, jtelemetry.GLOBAL)
    tdecl = declared_labels(apps[1].metrics, ttelemetry.GLOBAL)
    for fam, mtype in ttypes.items():
        assert jtypes[fam] == mtype, fam
        if fam == "duke_build_info":
            assert tkeys[fam] == {("version", "torch", "platform")}
            assert jkeys[fam] == {("version", "jax", "platform")}
            continue
        if fam in tdecl:
            assert tdecl[fam] == jdecl.get(fam), (fam, tdecl[fam],
                                                  jdecl.get(fam))
            assert tkeys[fam] <= {tdecl[fam]}, (fam, tkeys[fam])
        else:
            # a collector's family: its samples come from this test's
            # apps, or from process-wide ledgers this traffic fed on both
            # sides
            assert fam not in jdecl, fam
            assert tkeys[fam] <= jkeys[fam] | {()}, (fam, tkeys[fam],
                                                     jkeys[fam])
    for fam in _DETERMINISTIC:
        names = (fam, fam + "_bucket", fam + "_sum", fam + "_count")
        port = {k: v for k, v in tvalues.items() if k[0] in names}
        assert port, fam
        assert port == {k: v for k, v in jvalues.items()
                        if k[0] in names}, fam
    assert tvalues[("duke_http_requests_total", (
        ("route", "/deduplication/:name/:datasetId"), ("method", "POST"),
        ("status", "200")))] == 4
    # neither app built a mesh
    assert tvalues[("duke_mesh_devices", ())] == jvalues[
        ("duke_mesh_devices", ())] == 0

    def delta(values, prior, fam):
        return {k: v - prior.get(k, 0.0) for k, v in values.items()
                if k[0] == fam and v != prior.get(k, 0.0)}

    for fam in _DELTAS:
        assert delta(tvalues, before[1], fam) == delta(jvalues, before[0],
                                                       fam), fam
    # the engine ran and was attributed: phases, costs, device bytes
    for fam in ("duke_engine_phase_seconds", "duke_cost_device_seconds_total",
                "duke_device_bytes", "duke_sched_microbatch_records",
                "duke_query_blocks_total", "duke_slo_ingest_latency_seconds"):
        assert any(k[0].startswith(fam) for k in tvalues), fam


def test_stats_lock_free_under_concurrent_ingest(port_only):
    """/stats and /metrics neither stall behind nor crash against
    concurrent ingest (they read O(1) live counters lock-free)."""
    app, url = port_only
    stop = threading.Event()
    errors = []

    def poster():
        i = 0
        while not stop.is_set():
            try:
                status, _, _ = post_json(
                    f"{url}/deduplication/people/web",
                    [{"_id": f"st{i}-{j}", "name": f"stats load {i} {j}",
                      "email": f"s{i}{j}@x"} for j in range(20)])
            except Exception as e:
                errors.append(("post-error", repr(e)))
                break
            if status != 200:
                errors.append(("post", status))
            i += 1

    def poller():
        while not stop.is_set():
            try:
                status, _, body = request(f"{url}/stats", timeout=10)
                mstatus, _, _ = request(f"{url}/metrics", timeout=10)
            except Exception as e:
                errors.append(("stats-stall", repr(e)))
                continue
            if status != 200 or mstatus != 200:
                errors.append(("stats", status, mstatus))
                continue
            for row in json.loads(body)["workloads"]:
                if not isinstance(row["records_indexed"], int):
                    errors.append(("null-count", row))

    threads = ([threading.Thread(target=poster) for _ in range(2)]
               + [threading.Thread(target=poller) for _ in range(2)])
    for t in threads:
        t.start()
    time.sleep(2.0)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "worker thread hung"
    assert not errors, errors[:5]


# -- the feed ------------------------------------------------------------------


@pytest.mark.parametrize("page_size", [1, 7, 5000])
def test_chunked_feed_bytes_equal_jax(pair, monkeypatch, page_size):
    apps, urls = pair
    drive_traffic(urls)
    monkeypatch.setenv("FEED_PAGE_SIZE", str(page_size))
    for path in ("/deduplication/people?since=0",
                 "/recordlinkage/pairing?since=0"):
        (jstatus, jbody), (tstatus, tbody) = (raw_get(u, path) for u in urls)
        assert tstatus == jstatus == b"HTTP/1.1 200 OK"
        assert tbody == jbody, path
        decoded = request(urls[1] + path)[2]
        rows = json.loads(decoded)
        assert rows and tbody.endswith(b"0\r\n\r\n")
        # one chunk per page plus the brackets
        chunks = tbody.count(b"\r\n") // 2 - 1
        assert chunks == -(-len(rows) // page_size) + 2, (chunks, len(rows))
        since = rows[len(rows) // 2]["_updated"]
        tail = [request(u + path.replace("=0", f"={since}"))[2]
                for u in urls]
        assert tail[0] == tail[1]
        assert json.loads(tail[1]) == [r for r in rows
                                       if r["_updated"] > since]


def test_http10_feed_bytes_equal_jax(pair):
    apps, urls = pair
    drive_traffic(urls)
    path = "/deduplication/people?since=0"
    (jstatus, jbody), (tstatus, tbody) = (raw_get(u, path, "HTTP/1.0")
                                          for u in urls)
    assert tstatus.endswith(b"200 OK") and jstatus.endswith(b"200 OK")
    assert tbody == jbody
    # the same bytes as the streamed feed, de-chunked
    assert tbody == request(urls[1] + path)[2]


def test_feed_pages_do_not_skip_or_duplicate_ties(tmp_path):
    """The paging cursor is strictly-greater-than on timestamp; links
    sharing one timestamp must neither drop nor duplicate across a page
    boundary, in both link databases."""
    from sesam_duke_microservice_tpu_torch.links.memory import (
        InMemoryLinkDatabase,
    )
    from sesam_duke_microservice_tpu_torch.links.sqlite import (
        SqliteLinkDatabase,
    )

    ts = 1_600_000_000_000
    for db in (InMemoryLinkDatabase(),
               SqliteLinkDatabase(str(tmp_path / "l.sqlite"))):
        # 7 links share one timestamp; page size 3 forces tie extension
        for i in range(7):
            db.assert_link(Link(f"x{i}", f"y{i}", LinkStatus.INFERRED,
                                LinkKind.DUPLICATE, 0.9, timestamp=ts))
        db.assert_link(Link("x9", "y9", LinkStatus.INFERRED,
                            LinkKind.DUPLICATE, 0.9, timestamp=ts + 5))
        seen = []
        cursor = 0
        while True:
            page = db.get_changes_page(cursor, 3)
            if not page:
                break
            seen.extend((l.id1, l.id2) for l in page)
            cursor = page[-1].timestamp
        assert len(seen) == len(set(seen)) == 8
        db.close()


def test_feed_streams_in_pages_with_bounded_lock_hold(port_only):
    """A ?since=0 poll over a long backlog streams in pages, holding the
    workload lock per page only (median well under 100 ms), never for
    the whole response."""
    app, url = port_only
    wl = app.deduplications["people"]
    n_links = 60_000
    base_ts = 1_700_000_000_000
    for i in range(n_links):
        wl.link_database.assert_link(Link(
            f"crm__a{i}", f"web__b{i}", LinkStatus.INFERRED,
            LinkKind.DUPLICATE, 0.9, timestamp=base_ts + i))
    real_lock = wl.lock
    holds = []

    class TimedLock:
        def acquire(self, timeout=None, blocking=True):
            ok = (real_lock.acquire(timeout=timeout) if timeout is not None
                  else real_lock.acquire(blocking))
            if ok:
                self._t0 = time.monotonic()
            return ok

        def release(self):
            holds.append(time.monotonic() - self._t0)
            real_lock.release()

        def __enter__(self):
            self.acquire()
            return self

        def __exit__(self, *exc):
            self.release()

    wl.lock = TimedLock()
    try:
        with urllib.request.urlopen(url + "/deduplication/people?since=0",
                                    timeout=600) as resp:
            assert resp.headers.get("Content-Length") is None  # chunked
            body = resp.read()
        rows = json.loads(body)
        assert len(rows) == n_links
        assert rows[0]["_updated"] == base_ts
        assert len(holds) >= n_links // 5000  # actually paged
        for _ in range(3):  # preemption noise on a loaded host: retry
            if max(holds) < 2.0 and statistics.median(holds) < 0.1:
                break
            holds.clear()
            with urllib.request.urlopen(
                    url + "/deduplication/people?since=0",
                    timeout=600) as resp:
                resp.read()
        assert max(holds) < 2.0, f"lock held {max(holds):.3f}s"
        assert statistics.median(holds) < 0.1
    finally:
        wl.lock = real_lock


def test_feed_stream_aborts_on_mid_stream_workload_removal(port_only,
                                                           monkeypatch):
    """A reload that removes the workload mid-stream truncates the
    chunked framing (a protocol error at the client), never closes the
    array cleanly, and counts a ``workload_removed`` abort."""
    app, url = port_only
    monkeypatch.setenv("FEED_PAGE_SIZE", "10")
    wl = app.deduplications["people"]
    base_ts = 1_700_000_000_000
    for i in range(200):
        wl.link_database.assert_link(Link(
            f"crm__a{i}", f"web__b{i}", LinkStatus.INFERRED,
            LinkKind.DUPLICATE, 0.9, timestamp=base_ts + i))
    real_page = wl.links_page
    pages = []
    registry = app.deduplications

    def hooked(since, limit):
        pages.append(since)
        if len(pages) == 3:
            app.deduplications = {}
        return real_page(since, limit)

    wl.links_page = hooked
    host, port = url.rsplit("/", 1)[-1].split(":")
    try:
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        conn.request("GET", "/deduplication/people?since=0")
        resp = conn.getresponse()
        assert resp.status == 200
        with pytest.raises((http.client.IncompleteRead,
                            http.client.HTTPException, ConnectionError)):
            body = resp.read()
            raise http.client.IncompleteRead(body) if not body.endswith(
                b"]") else AssertionError(f"clean close: ...{body[-20:]!r}")
        conn.close()
    finally:
        app.deduplications = registry
    assert app.feed_aborts["workload_removed"] == 1
    text = request(url + "/metrics")[2].decode()
    assert 'duke_feed_aborts_total{reason="workload_removed"} 1' in text


def test_feed_ends_when_the_app_closes(port_only, monkeypatch):
    """``close()`` keeps its closed workloads registered, so a feed must not
    re-resolve them forever: a stream in flight when the app closes
    truncates and counts a ``workload_removed`` abort, and a feed asked
    for after the close answers 503 on either HTTP version."""
    app, url = port_only
    monkeypatch.setenv("FEED_PAGE_SIZE", "10")
    wl = app.deduplications["people"]
    for i in range(200):
        wl.link_database.assert_link(Link(
            f"crm__a{i}", f"web__b{i}", LinkStatus.INFERRED,
            LinkKind.DUPLICATE, 0.9, timestamp=1_700_000_000_000 + i))

    class ClosedAfterTwoPages:
        """The workload lock: before the stream's third page the feed waits
        for ``app.close()``, run in a thread of its own, to finish."""

        def __init__(self, lock):
            self.lock, self.pages, self.closer = lock, 0, None

        def acquire(self, blocking=True, timeout=-1):
            if threading.current_thread() is self.closer:
                return self.lock.acquire(blocking, timeout)
            if self.pages == 2 and self.closer is None:
                self.closer = threading.Thread(target=app.close)
                self.closer.start()
                self.closer.join(timeout=30)
            ok = self.lock.acquire(blocking, timeout)
            self.pages += ok
            return ok

        def release(self):
            self.lock.release()

        def __enter__(self):
            self.acquire()
            return self

        def __exit__(self, *exc):
            self.release()

    real_lock = wl.lock
    wl.lock = ClosedAfterTwoPages(real_lock)
    host, port = url.rsplit("/", 1)[-1].split(":")
    try:
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        conn.request("GET", "/deduplication/people?since=0")
        resp = conn.getresponse()
        assert resp.status == 200
        with pytest.raises((http.client.IncompleteRead,
                            http.client.HTTPException, ConnectionError)):
            body = resp.read()
            raise http.client.IncompleteRead(body) if not body.endswith(
                b"]") else AssertionError(f"clean close: ...{body[-20:]!r}")
        conn.close()
    finally:
        wl.lock = real_lock
    assert wl.closed and app.deduplications["people"] is wl
    assert app.feed_aborts["workload_removed"] == 1
    status, _, body = request(url + "/deduplication/people?since=0",
                              timeout=30)
    assert (status, body) == (503, b"The service is shutting down.")
    status_line, body = raw_get(url, "/deduplication/people?since=0",
                                version="HTTP/1.0")
    assert b" 503 " in status_line
    assert body == b"The service is shutting down."


def test_feed_busy_503_then_deadline_abort(port_only, monkeypatch):
    """Before the stream starts a held lock answers the busy 503 with a
    Retry-After; once it has started, the lock retries back off until
    DUKE_FEED_RETRY_DEADLINE and then truncate the stream."""
    app, url = port_only
    monkeypatch.setattr(tapp_module, "READ_LOCK_TIMEOUT_SECONDS", 0.05)
    monkeypatch.setenv("DUKE_FEED_RETRY_DEADLINE", "1")
    monkeypatch.setenv("FEED_PAGE_SIZE", "5")
    wl = app.deduplications["people"]
    for i in range(20):
        wl.link_database.assert_link(Link(
            f"crm__a{i}", f"web__b{i}", LinkStatus.INFERRED,
            LinkKind.DUPLICATE, 0.9, timestamp=1_700_000_000_000 + i))
    with wl.lock:
        status, headers, body = request(url + "/deduplication/people")
    assert status == 503 and b"being written to" in body
    assert headers["Retry-After"] == "1"

    class WedgedAfterTwoPages:
        """The workload lock as a writer that takes it after the stream's
        second page and never lets go: every later timed acquire fails."""

        def __init__(self, lock):
            self.lock, self.pages = lock, 0

        def acquire(self, blocking=True, timeout=-1):
            if self.pages >= 2:
                time.sleep(max(timeout, 0))
                return False
            ok = self.lock.acquire(blocking, timeout)
            self.pages += ok
            return ok

        def release(self):
            self.lock.release()

    real_lock = wl.lock
    wl.lock = WedgedAfterTwoPages(real_lock)
    try:
        host, port = url.rsplit("/", 1)[-1].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        conn.request("GET", "/deduplication/people?since=0")
        resp = conn.getresponse()
        assert resp.status == 200
        with pytest.raises((http.client.IncompleteRead,
                            http.client.HTTPException, ConnectionError)):
            body = resp.read()
            raise http.client.IncompleteRead(body) if not body.endswith(
                b"]") else AssertionError("clean close")
        conn.close()
    finally:
        wl.lock = real_lock
    assert app.feed_aborts["deadline"] == 1
    text = request(url + "/metrics")[2].decode()
    assert re.search(r'duke_http_busy_total\{route="/deduplication/:name"\} 1',
                     text)


# -- reload ------------------------------------------------------------------


def snapshot_fallbacks():
    """The port's snapshot rejections since process start, all reasons."""
    return sum(v for _, _, v in
               ttelemetry.SNAPSHOT_FALLBACKS.collect().samples)


def test_device_reload_uses_corpus_snapshot(tmp_path, monkeypatch):
    """A hot reload restores the new workloads' corpora from the snapshot
    saved under the quiesce locks, not by re-extracting features, and
    frees the replaced workload's device tensors."""
    app = port_app(config_xml(folder=tmp_path), persistent=True)
    try:
        wl = app.deduplications["people"]
        with wl.lock:
            wl.process_batch("crm", [
                {"_id": f"r{i}", "name": f"acme {i}", "email": f"a{i}@x.no"}
                for i in range(10)
            ])
        assert wl.index.corpus.size == 10
        wl.index.corpus.device_arrays()  # on the device before the reload
        assert wl.index.corpus.device_bytes()["corpus_tensors"] > 0
        fallbacks = snapshot_fallbacks()

        def boom(self, records, plan=None):
            raise AssertionError("extraction ran during reload despite "
                                 "the snapshot")

        monkeypatch.setattr(DeviceIndex, "_extract", boom)
        app.reload_from_string(config_xml(folder=tmp_path))
        wl2 = app.deduplications["people"]
        assert wl2 is not wl and wl.closed
        assert wl2.restore_route == "snapshot"
        assert wl2.index.corpus.size == 10
        assert wl.index.corpus.device_bytes() == {
            "corpus_tensors": 0, "corpus_embeddings": 0, "int8_scales": 0}
        assert snapshot_fallbacks() == fallbacks
    finally:
        app.close()


def test_reload_sequence_matches_jax(tmp_path):
    """POST, reload with a changed threshold and an added workload, POST
    to both workloads: equal tapes and feeds, each package's persistent
    workloads restored through its snapshot."""
    folders = [tmp_path / "jax", tmp_path / "port"]
    apps = (jax_app(config_xml(folder=folders[0]), persistent=True),
            port_app(config_xml(folder=folders[1]), persistent=True))
    batch_a = entities(30, 21, "a")
    batch_b = entities(18, 22, "b") + [dict(batch_a[0], _id="b-copy")]
    with served(*apps) as urls:
        post_both(urls, "/deduplication/people/crm", batch_a)
        feeds_before = [request(u + "/deduplication/people?since=0")[2]
                        for u in urls]
        assert feeds_before[0] == feeds_before[1]
        fallbacks = snapshot_fallbacks()
        for url, folder in zip(urls, folders):
            xml = config_xml(folder=folder, threshold="0.85", extra=True)
            status, headers, _ = request(url + "/config", "POST",
                                         *multipart(xml))
            assert status == 302 and headers["Location"] == "/"
        assert apps[1].deduplications["people"].restore_route == "snapshot"
        assert snapshot_fallbacks() == fallbacks
        tapes = []
        for app in apps:
            tape = _Tape()
            app.deduplications["people"].processor.add_match_listener(tape)
            app.deduplications["people2"].processor.add_match_listener(tape)
            tapes.append(tape)
        for path, payload in (("/deduplication/people/crm", batch_b),
                              ("/deduplication/people2/crm", batch_a[:9])):
            post_both(urls, path, payload)
        assert tapes[1].events == tapes[0].events
        assert any(e[0] == "matches" for e in tapes[1].events)
        for path in ("/deduplication/people?since=0",
                     "/deduplication/people2?since=0"):
            feeds = [request(u + path)[2] for u in urls]
            assert feeds[0] == feeds[1], path
            assert json.loads(feeds[1]), path
        assert json.loads(request(urls[1] + "/deduplication/people?since=0")
                          [2])[:len(json.loads(feeds_before[1]))] == \
            json.loads(feeds_before[1])
        stats = [comparable_stats(json.loads(request(u + "/stats")[2]))
                 for u in urls]
        assert stats[0] == stats[1]


def test_concurrent_posts_across_reloads_all_answer(tmp_path):
    """POSTs from several clients while the config reloads three times:
    every request answers 200 (none deadlocks), and every acked record
    is indexed afterwards."""
    folder = tmp_path / "port"
    app = port_app(config_xml(folder=folder), persistent=True)
    acked, errors = [], []
    lock = threading.Lock()
    with served(app) as (url,):
        def client(c):
            for i in range(6):
                batch = [{"_id": f"k{c}-{i}-{j}", "name": f"client {c} {j}",
                          "email": f"{c}{i}{j}@x"} for j in range(4)]
                try:
                    status, _, body = post_json(
                        url + "/deduplication/people/crm", batch)
                except Exception as e:  # a hang shows as a timeout here
                    errors.append(repr(e))
                    return
                with lock:
                    if status == 200:
                        acked.extend(e["_id"] for e in batch)
                    else:
                        errors.append((status, body))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for n in range(3):
            xml = config_xml(folder=folder, threshold=("0.8", "0.85")[n % 2],
                             extra=n % 2 == 0)
            status, _, body = request(url + "/config", "POST",
                                      xml.encode(),
                                      {"Content-Type": "application/xml"},
                                      timeout=120)
            assert status == 302, body
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a POST hung"
        assert not errors, errors[:3]
        assert len(acked) == 4 * 6 * 4
        stats = json.loads(request(url + "/stats")[2])
        people = next(w for w in stats["workloads"]
                      if w["name"] == "people")
        assert people["records_indexed"] == len(acked)
        status, _, body = request(url + "/readyz")
        assert status == 200 and json.loads(body)["status"] == "ready"


def test_queued_request_of_removed_workload_answers_404(monkeypatch):
    """A request queued in the scheduler when a reload removes its
    workload fails with WorkloadGone -> 404, as in the JAX package."""
    monkeypatch.setenv("DUKE_SCHEDULER", "0")
    app = port_app(config_xml(extra=True))
    app.scheduler = IngestScheduler(app._resolve_workload, start=False)
    result = {}
    with served(app) as (url,):
        def post():
            result["answer"] = post_json(
                url + "/deduplication/people2/crm",
                [{"_id": "q", "name": "queued", "email": "q@x"}])

        t = threading.Thread(target=post)
        t.start()
        deadline = time.monotonic() + 30
        while not any(q.pending for q in app.scheduler.queues()):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        app.reload_from_string(config_xml())
        app.scheduler.start()
        t.join(timeout=30)
        status, _, body = result["answer"]
        assert status == 404
        assert body == (b"Unknown deduplication 'people2'! (All "
                        b"deduplications must be specified in the "
                        b"configuration)")
