"""The port's request tracing and flight recorder
(``sesam_duke_microservice_tpu_torch.telemetry.tracing``) held against
the JAX package's.

The cases of ``tests/test_tracing.py`` that involve no mesh follower run
against both tracers (parametrized over the two packages): traceparent
round trips and rejections, span nesting across threads, the span cap,
the tail latch (slow, errored, fast unsampled), flight-recorder eviction
(oldest first, unremarkable before slow), the digest's phase seconds and
the Chrome export.  Over HTTP, the JAX ``DukeApp(backend="device")`` and
the port's ``DukeApp(device="cpu")`` take the same POSTs with the same
sampled ``traceparent``: both trees hold the same span names at the same
parents (request root, ``sched.queued``, ``sched.microbatch``, encode
with ``encode.stream_append``, persist, ``links:assert_batch``; the JAX
package's aggregate retrieve and score where the port records record
conversion and its scoring pass in true intervals), replies and error
bodies carry ``X-Trace-Id``, ``/debug/requests`` digests the unsampled
requests, and the
``/debug/profile`` capture cycle answers alike (a real ``torch.profiler``
capture on the CPU too).  Span names and statuses compare exactly; no
clock is compared.
"""

import collections
import json
import os
import threading
import time

import pytest

from sesam_duke_microservice_tpu.engine import device_matcher as JDM
from sesam_duke_microservice_tpu.telemetry import tracing as jtracing
from sesam_duke_microservice_tpu.utils import profiling as jprofiling
from sesam_duke_microservice_tpu_torch.engine import device_matcher as TDM
from sesam_duke_microservice_tpu_torch.telemetry import tracing as ttracing
from sesam_duke_microservice_tpu_torch.utils import profiling as tprofiling
from test_torch_service_surface import (
    config_xml,
    entities,
    jax_app,
    port_app,
    request,
    served,
)
from torch_jax_cache import jax_cache_off  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

TRACERS = pytest.mark.parametrize("tracing", [jtracing, ttracing],
                                  ids=["jax", "port"])


# -- traceparent -------------------------------------------------------------

@TRACERS
def test_traceparent_round_trip(tracing):
    tid = "0af7651916cd43dd8448eb211c80319c"
    sid = "b7ad6b7169203331"
    for sampled in (True, False):
        ctx = tracing.parse_traceparent(
            tracing.format_traceparent(tid, sid, sampled))
        assert (ctx.trace_id, ctx.parent_id, ctx.sampled) == (tid, sid,
                                                              sampled)


@TRACERS
@pytest.mark.parametrize("bad", [
    None,
    "",
    "not-a-traceparent",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331",  # no flags
    "00-" + "0" * 32 + "-b7ad6b7169203331-01",               # zero trace id
    "00-0af7651916cd43dd8448eb211c80319c-" + "0" * 16 + "-01",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0AF7651916CD43DD8448EB211C80319C-b7ad6b7169203331-01",  # upper hex
])
def test_traceparent_rejects_malformed(tracing, bad):
    assert tracing.parse_traceparent(bad) is None


# -- spans -------------------------------------------------------------------

@TRACERS
def test_span_nesting_across_threads(tracing):
    recorder = tracing.FlightRecorder(4, 4)
    with tracing.start_trace("root", sampled=True,
                             recorder=recorder) as root:
        with tracing.span("parent") as parent:
            ctx = tracing.current_context()

            def worker():
                with tracing.attach(ctx):
                    with tracing.span("child"):
                        pass

            t = threading.Thread(target=worker)
            t.start()
            t.join()
    record = recorder.get(root.trace_id)
    by_name = {s.name: s for s in record.spans}
    assert set(by_name) == {"root", "parent", "child"}
    assert by_name["child"].parent_id == parent.span_id
    assert by_name["parent"].parent_id == root.span_id
    assert by_name["child"].trace_id == root.trace_id


@TRACERS
def test_span_is_noop_outside_a_trace(tracing):
    assert tracing.current_context() is None
    with tracing.span("orphan") as s:
        assert s is None


@TRACERS
def test_span_cap_bounds_a_pathological_request(tracing, monkeypatch):
    monkeypatch.setenv("TRACE_MAX_SPANS", "8")
    recorder = tracing.FlightRecorder(4, 4)
    with tracing.start_trace("root", sampled=True,
                             recorder=recorder) as root:
        for i in range(50):
            with tracing.span(f"s{i}"):
                pass
    record = recorder.get(root.trace_id)
    assert len(record.spans) == 9  # 8 capped children + the root
    assert record.dropped == 42
    assert root.attributes["spans_dropped"] == record.dropped


# -- tail latch and eviction -------------------------------------------------

@TRACERS
def test_tail_latch_retains_slow_unsampled_trace(tracing, monkeypatch):
    monkeypatch.setenv("TRACE_SAMPLE_RATE", "0")
    monkeypatch.setenv("TRACE_SLOW_MS", "1")
    recorder = tracing.FlightRecorder(4, 4)
    with tracing.start_trace("slow", recorder=recorder) as root:
        time.sleep(0.005)
    record = recorder.get(root.trace_id)
    assert record is not None and record.slow and not record.sampled


@TRACERS
def test_fast_unsampled_trace_digested_but_not_retained(tracing,
                                                        monkeypatch):
    monkeypatch.setenv("TRACE_SAMPLE_RATE", "0")
    monkeypatch.setenv("TRACE_SLOW_MS", "60000")
    recorder = tracing.FlightRecorder(4, 4)
    with tracing.start_trace("fast", recorder=recorder) as root:
        pass
    assert recorder.get(root.trace_id) is None
    digests = recorder.digests()
    assert [d["trace_id"] for d in digests] == [root.trace_id]
    assert digests[0]["retained"] is False


@TRACERS
def test_errored_trace_is_retained(tracing, monkeypatch):
    monkeypatch.setenv("TRACE_SAMPLE_RATE", "0")
    monkeypatch.setenv("TRACE_SLOW_MS", "60000")
    recorder = tracing.FlightRecorder(4, 4)
    with pytest.raises(RuntimeError):
        with tracing.start_trace("boom", recorder=recorder) as root:
            raise RuntimeError("kaput")
    assert recorder.get(root.trace_id).status == "error"


@TRACERS
def test_trace_ring_evicts_oldest(tracing):
    recorder = tracing.FlightRecorder(2, 16)
    ids = []
    for i in range(4):
        with tracing.start_trace(f"t{i}", sampled=True,
                                 recorder=recorder) as root:
            pass
        ids.append(root.trace_id)
    assert recorder.get(ids[0]) is None and recorder.get(ids[1]) is None
    assert [s["trace_id"] for s in recorder.summaries()] == [ids[3], ids[2]]


@TRACERS
def test_eviction_prefers_unremarkable_over_slow_traces(tracing,
                                                        monkeypatch):
    monkeypatch.setenv("TRACE_SLOW_MS", "1")
    recorder = tracing.FlightRecorder(2, 16)
    with tracing.start_trace("slow", sampled=True,
                             recorder=recorder) as slow_root:
        time.sleep(0.005)
    monkeypatch.setenv("TRACE_SLOW_MS", "60000")
    fast_ids = []
    for i in range(3):
        with tracing.start_trace(f"fast{i}", sampled=True,
                                 recorder=recorder) as root:
            pass
        fast_ids.append(root.trace_id)
    assert recorder.get(slow_root.trace_id) is not None
    assert recorder.get(fast_ids[-1]) is not None
    assert len(recorder.summaries()) == 2


@TRACERS
def test_repeat_retention_merges_into_one_tree(tracing):
    """A client reusing one sampled traceparent retains under one trace
    id twice: the trees merge."""
    recorder = tracing.FlightRecorder(4, 8)
    tp = tracing.format_traceparent("ab" * 16, "cd" * 8, True)
    for name in ("first", "second"):
        with tracing.start_trace(name, traceparent=tp, recorder=recorder):
            pass
    assert {s.name for s in recorder.get("ab" * 16).spans} == {
        "first", "second"}
    assert len(recorder.summaries()) == 1


@TRACERS
def test_digest_carries_phase_seconds(tracing):
    recorder = tracing.FlightRecorder(4, 4)
    with tracing.start_trace("batch", sampled=True, recorder=recorder):
        base = time.monotonic_ns()
        tracing.add_span("encode", base, base + 2_000_000)
        tracing.add_phase_spans(base, 0.003, 0.004)
    phases = recorder.digests()[0]["phase_seconds"]
    assert phases == {"encode": 0.002, "retrieve": 0.003, "score": 0.004}


@TRACERS
def test_chrome_export_schema(tracing):
    recorder = tracing.FlightRecorder(4, 4)
    with tracing.start_trace("GET /x", sampled=True,
                             recorder=recorder) as root:
        with tracing.span("encode", {"records": 3}):
            pass
    out = tracing.chrome_trace(recorder.get(root.trace_id))
    json.dumps(out)
    assert out["displayTimeUnit"] == "ms"
    complete = [e for e in out["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in complete} == {"GET /x", "encode"}
    for e in complete:
        assert isinstance(e["ts"], float) and isinstance(e["dur"], float)
        assert e["dur"] >= 0 and e["tid"] == 0
    assert sum(e["ph"] == "M" for e in out["traceEvents"]) == 3


def test_port_chrome_and_json_exports_equal_jax_shape():
    """The same span tree exported by both packages: equal keys at every
    level of both formats."""
    shapes = []
    for tracing in (jtracing, ttracing):
        recorder = tracing.FlightRecorder(4, 4)
        with tracing.start_trace("GET /x", sampled=True,
                                 recorder=recorder) as root:
            with tracing.span("encode", {"records": 3}):
                pass
        record = recorder.get(root.trace_id)
        as_json = tracing.trace_to_json(record)
        chrome = tracing.chrome_trace(record)
        shapes.append((sorted(as_json), sorted(as_json["spans"][0]),
                       sorted(chrome), [sorted(e) for e in
                                        chrome["traceEvents"]]))
    assert shapes[0] == shapes[1]


# -- over HTTP: the JAX app and the port's on the same traffic ----------------

@pytest.fixture
def pair(monkeypatch):
    monkeypatch.setenv("DUKE_FEATURE_CACHE_MB", "0")
    monkeypatch.setenv("TRACE_SAMPLE_RATE", "0")
    monkeypatch.setenv("TRACE_SLOW_MS", "60000")
    monkeypatch.setattr(JDM, "_UPDATE_SLICE", 8)
    monkeypatch.setattr(TDM, "_UPDATE_SLICE", 8)
    xml = config_xml()
    apps = (jax_app(xml), port_app(xml))
    with served(*apps) as urls:
        yield apps, urls


def get_trace(url, trace_id, query=""):
    """``GET /debug/traces/<id>``: a tree lands in the flight recorder when
    the root span exits, after the reply is on the wire, so a request on
    a fresh connection can race the handler's last instructions; poll
    briefly (up to 1 s) before taking a 404."""
    for _ in range(50):
        status, headers, out = request(
            url + "/debug/traces/" + trace_id + query)
        if status != 404:
            break
        time.sleep(0.02)
    return status, headers, out


def tree_shape(tree):
    """{(span name, parent span name): count} of one trace tree."""
    names = {s["span_id"]: s["name"] for s in tree["spans"]}
    return collections.Counter(
        (s["name"], names.get(s["parent_id"])) for s in tree["spans"])


def post(url, path, payload, headers=None):
    return request(url + path, "POST", json.dumps(payload).encode(),
                   dict({"Content-Type": "application/json"},
                        **(headers or {})))


# the port's own spans inside the microbatch: record conversion and the
# scoring pass in true intervals (the JAX package lays its accumulated
# retrieve / score durations end to end instead, AGGREGATE)
PORT_PASS_SPANS = {"ingest.convert", "scan.dispatch", "scan.wait",
                   "finalize.dd", "finalize"}
AGGREGATE = {"retrieve", "score"}


def test_sampled_post_trees_equal_jax(pair):
    """A sampled POST that streams (24 records past an 8-row slice on a
    warm corpus): both trees hold the same span names under the same
    parents, among them every span site of the ingest path, but that the
    port records its scoring pass in true intervals (PORT_PASS_SPANS)
    where the JAX package lays out its aggregate retrieve and score."""
    _, urls = pair
    crm = entities(40, 5, "c")
    shapes = []
    for side, url in enumerate(urls):
        status, _, body = post(url, "/deduplication/people/crm", crm[:16])
        assert status == 200, body
        tid = f"{side + 1:02d}" * 16
        tp = jtracing.format_traceparent(tid, "34" * 8, True)
        status, headers, body = post(url, "/deduplication/people/crm",
                                     crm[16:], {"traceparent": tp})
        assert status == 200, body
        assert headers["X-Trace-Id"] == tid
        status, _, out = get_trace(url, tid)
        assert status == 200
        tree = json.loads(out)
        assert tree["sampled"] is True and tree["status"] == "ok"
        shapes.append(tree_shape(tree))
        status, _, out = request(url + "/debug/traces/" + tid
                                 + "?format=chrome")
        assert status == 200 and json.loads(out)["traceEvents"]
    jax_tree, port_tree = shapes
    assert ({e: n for e, n in port_tree.items()
             if e[0] not in PORT_PASS_SPANS}
            == {e: n for e, n in jax_tree.items() if e[0] not in AGGREGATE})
    root = "POST /deduplication/:name/:datasetId"
    for edge in ((root, None), ("sched.queued", root),
                 ("sched.microbatch", root), ("encode", "sched.microbatch"),
                 ("encode.stream_append", "encode"),
                 ("persist", "sched.microbatch"),
                 ("links:assert_batch", "persist")):
        assert edge in port_tree, edge
        assert edge in jax_tree, edge
    for name in AGGREGATE:
        assert (name, "sched.microbatch") in jax_tree, name
    for name in PORT_PASS_SPANS:
        assert (name, "sched.microbatch") in port_tree, name


def test_unsampled_requests_digest_and_headers_equal_jax(pair):
    """``/debug/requests`` digests every request, retained or not; an
    unretained tree answers 404; error replies and the stdlib's 501 carry
    both correlation headers, in both apps."""
    _, urls = pair
    out = []
    for url in urls:
        status, headers, _ = request(url + "/stats")
        assert status == 200
        tid = headers["X-Trace-Id"]
        mine = []
        for _ in range(50):  # the digest lands after the reply is sent
            rows = json.loads(request(url + "/debug/requests")[2])[
                "requests"]
            mine = [r for r in rows if r["trace_id"] == tid]
            if mine:
                break
            time.sleep(0.02)
        assert mine and mine[0]["retained"] is False
        status_tree = request(url + "/debug/traces/" + tid)[0]
        status_404, h404, _ = request(url + "/no/such/path")
        status_501, h501, _ = request(url + "/healthz", method="PUT")
        assert h404.get("X-Trace-Id") not in (None, "-")
        assert h404.get("X-Request-Id") not in (None, "-")
        assert h501.get("X-Request-Id") not in (None, "-")
        out.append((mine[0]["name"], sorted(mine[0]), status_tree,
                    status_404, status_501, h501.get("X-Trace-Id")))
    assert out[0] == out[1] == (out[0][0], out[0][1], 404, 404, 501, "-")
    assert out[0][0] == "GET /stats"


def test_slow_unsampled_request_retained_over_http(pair, monkeypatch):
    _, urls = pair
    monkeypatch.setenv("TRACE_SLOW_MS", "0.0001")
    for url in urls:
        status, headers, _ = request(url + "/healthz")
        assert status == 200
        status, _, out = get_trace(url, headers["X-Trace-Id"])
        assert status == 200 and json.loads(out)["slow"] is True


def test_debug_trace_endpoint_validation(pair):
    _, urls = pair
    for url in urls:
        assert request(url + "/debug/traces/" + "ab" * 16)[0] == 404
        assert request(url + "/debug/traces/" + "ab" * 16
                       + "?format=xml")[0] == 400


def test_profile_endpoint_capture_cycle_equal_jax(pair, monkeypatch):
    """The capture cycle with the profiler seams patched: status, 409 on
    a second capture, annotations live only while capturing, 400s."""
    _, urls = pair
    calls = []
    monkeypatch.setattr(jprofiling, "profiler_start",
                        lambda d: calls.append("jax start"))
    monkeypatch.setattr(jprofiling, "profiler_stop",
                        lambda: calls.append("jax stop"))
    monkeypatch.setattr(tprofiling, "profiler_start",
                        lambda d, s: calls.append("port start"))
    monkeypatch.setattr(tprofiling, "profiler_stop",
                        lambda: calls.append("port stop") or "t.json")
    answers = []
    for url, profiling, tracing in ((urls[0], jprofiling, jtracing),
                                    (urls[1], tprofiling, ttracing)):
        seen = [request(url + "/debug/profile")]
        try:
            seen.append(request(url + "/debug/profile?seconds=30", "POST",
                                b""))
            assert tracing.device_annotations_active()
            seen.append(request(url + "/debug/profile?seconds=1", "POST",
                                b""))
            live = json.loads(request(url + "/debug/profile")[2])
            assert live["capturing"]["remaining_seconds"] > 0
        finally:
            profiling.stop_capture()
        assert not tracing.device_annotations_active()
        seen.append(request(url + "/debug/profile?seconds=bogus", "POST",
                            b""))
        seen.append(request(url + "/debug/profile?seconds=-1", "POST",
                            b""))
        profiling._traced_batches = 5
        seen.append(request(url + "/debug/profile/reset", "POST", b""))
        assert profiling._traced_batches == 0
        answers.append([(status, sorted(json.loads(body)))
                        for status, _, body in seen])
    assert answers[1] == answers[0]
    assert [a[0] for a in answers[1]] == [200, 200, 409, 400, 400, 200]
    assert calls == ["jax start", "jax stop", "port start", "port stop"]


def test_real_capture_holds_the_annotated_spans(tmp_path):
    """A real ``torch.profiler`` capture (CPU activity here): the trace
    file is written, and an ``annotate=True`` span opened on the capture's
    own thread lands in it as a ``record_function`` range.  (Ranges of
    other threads depend on the PyTorch version; the card run records
    what its capture held.)"""
    info = tprofiling.start_capture(30, logdir=str(tmp_path))
    assert tprofiling.capture_status()["dir"] == info["dir"]
    done = tprofiling.stop_capture()
    assert done["trace_file"].startswith(str(tmp_path))
    events = json.load(open(done["trace_file"]))["traceEvents"]
    assert isinstance(events, list)
    assert tprofiling.capture_status() is None
    assert tprofiling.stop_capture() is None
    assert os.path.basename(done["trace_file"]).startswith("capture-")


# -- log correlation -----------------------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_log_records_carry_request_and_trace_ids(pkg):
    """``RequestIdFilter`` stamps the request id and the active trace id
    on every record, ``JsonFormatter`` renders them; outside a trace the
    trace id is ``-``.  The same keys in both packages."""
    import logging

    if pkg == "jax":
        from sesam_duke_microservice_tpu.telemetry import logctx
        tracing = jtracing
    else:
        from sesam_duke_microservice_tpu_torch.telemetry import logctx
        tracing = ttracing
    filt, fmt = logctx.RequestIdFilter(), logctx.JsonFormatter()
    token = logctx.request_id_var.set("req-1")
    try:
        rec = logging.LogRecord("x", logging.INFO, __file__, 1, "hi %s",
                                ("there",), None)
        assert filt.filter(rec)
        assert (rec.request_id, rec.trace_id) == ("req-1", "-")
        with tracing.start_trace("t", sampled=False,
                                 recorder=tracing.FlightRecorder(1, 1)) as r:
            filt.filter(rec)
            assert rec.trace_id == r.trace_id
        line = json.loads(fmt.format(rec))
    finally:
        logctx.request_id_var.reset(token)
    assert sorted(line) == ["level", "logger", "message", "request_id",
                            "time", "trace_id", "ts"]
    assert line["message"] == "hi there"
