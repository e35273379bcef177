"""The port's measurement of a scoring pass and of the two paths that
contend for its workload lock, on the CPU.

A sampled POST's ``sched.microbatch`` holds the pass in true intervals
(``ingest.convert``, ``store.put``, ``encode``, ``scan.dispatch``,
``scan.wait`` with the lookahead dispatch inside it, ``finalize.dd``,
``finalize``, ``persist`` with ``links.journal``) that follow one another
and cover the hold; the pass's ``ProfileStats`` clocks add up to the
JAX package's retrieve and score phases and ``device_seconds`` stays 0
without a card.  A held workload lock makes the scheduler requeue and
wait (``lock_requeues``, ``lock_wait_s``, ``sched.lock_wait``); a feed
page read counts its hold (``feed.page`` with ``links.drain``); the
write-behind flusher's batches land ``links.flush`` traces; and an
on-demand capture carries the retained spans on its own clock.
"""

import json
import shutil
import threading
import time
import urllib.request

import pytest

from sesam_duke_microservice_tpu_torch.core.config import parse_config
from sesam_duke_microservice_tpu_torch.service.app import DukeApp, serve
from sesam_duke_microservice_tpu_torch.telemetry import tracing
from sesam_duke_microservice_tpu_torch.utils import profiling

from torch_threads import torch_threads_per_worker  # noqa: F401

CONFIG = """
<DukeMicroService dataFolder="{folder}">
  <Deduplication name="people">
    <duke>
      <schema>
        <threshold>0.8</threshold>
        <property><name>NAME</name>
          <comparator>levenshtein</comparator><low>0.1</low><high>0.95</high>
        </property>
        <property><name>EMAIL</name>
          <comparator>exact</comparator><low>0.2</low><high>0.95</high>
        </property>
      </schema>
      <data-source class="io.sesam.dukemicroservice.IncrementalDeduplicationDataSource">
        <param name="dataset-id" value="crm"/>
        <column name="name" property="NAME"/>
        <column name="email" property="EMAIL"/>
      </data-source>
    </duke>
  </Deduplication>
</DukeMicroService>
"""

# the microbatch's children, in the order a pass runs them
PASS_CHILDREN = ("ingest.convert", "store.put", "encode", "scan.dispatch",
                 "scan.wait", "finalize.dd", "finalize", "persist")

_NAMES = ["anne hansen", "bjorn olsen", "carl larsen", "dina berg",
          "erik dahl", "frida moe", "geir lie", "hege strand"]


def entities(n, prefix):
    """People whose every second one copies an earlier one's email and
    name but a letter: pairs to link."""
    out = []
    for i in range(n):
        if i % 2:
            src = out[i - 1]
            out.append(dict(src, _id=f"{prefix}{i}",
                            name=src["name"][:-1] + "x"))
        else:
            out.append({"_id": f"{prefix}{i}", "name": _NAMES[i % 8] + f" {i}",
                        "email": f"{prefix}{i}@x.no"})
    return out


@pytest.fixture
def served_app(tmp_path, monkeypatch):
    """A persistent port app (SQLite links behind write-behind and the
    journal) on the CPU, served on an ephemeral port; every trace kept."""
    monkeypatch.setenv("TRACE_SAMPLE_RATE", "1")
    monkeypatch.setenv("DUKE_FEATURE_CACHE_MB", "0")
    monkeypatch.delenv("DUKE_SCHEDULER", raising=False)
    tracing.RECORDER.clear()
    app = DukeApp(parse_config(CONFIG.format(folder=tmp_path)), device="cpu")
    server = serve(app, port=0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield app, f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        app.close()
        tracing.RECORDER.clear()


def request(url, method="GET", body=None, headers=None):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


def post(url, rows, trace_id=None):
    headers = {"Content-Type": "application/json"}
    if trace_id is not None:
        headers["traceparent"] = tracing.format_traceparent(
            trace_id, "34" * 8, True)
    status, _ = request(url + "/deduplication/people/crm", "POST",
                        json.dumps(rows).encode(), headers)
    assert status == 200


def spans_of(trace_id):
    """The retained tree's spans (it lands as the root exits, after the
    reply)."""
    for _ in range(100):
        record = tracing.RECORDER.get(trace_id)
        if record is not None:
            return record.spans
        time.sleep(0.02)
    raise AssertionError(f"trace {trace_id} never landed")


def children(spans, parent):
    return sorted((s for s in spans if s.parent_id == parent.span_id),
                  key=lambda s: s.start_ns)


def test_microbatch_children_tile_the_pass(served_app):
    app, url = served_app
    post(url, entities(40, "a"))
    tid = "ab" * 16
    # 64 records: two query blocks of 32, the second dispatched as the
    # first one's lookahead
    post(url, entities(64, "b"), trace_id=tid)
    spans = spans_of(tid)
    names = {s.name for s in spans}
    assert not names & {"retrieve", "score"}
    (batch,) = [s for s in spans if s.name == "sched.microbatch"]
    kids = children(spans, batch)
    assert {k.name for k in kids} == set(PASS_CHILDREN)
    order = [k.name for k in kids]
    assert order.index("ingest.convert") < order.index("encode") \
        < order.index("scan.dispatch") < order.index("scan.wait") \
        < order.index("finalize") < order.index("persist")
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns, (a.name, b.name)
    covered = sum(k.duration_ns for k in kids)
    assert covered >= 0.9 * batch.duration_ns, (covered, batch.duration_ns)
    # the lookahead dispatch runs inside the first block's wait
    waits = [k for k in kids if k.name == "scan.wait"]
    nested = [s for w in waits for s in children(spans, w)
              if s.name == "scan.dispatch"]
    assert len(waits) == 2 and len(nested) == 1
    assert nested[0].attributes["lookahead"] is True
    assert waits[0].attributes["escalations"] >= 0
    top = [k for k in kids if k.name == "scan.dispatch"]
    assert len(top) == 1 and top[0].attributes["h2d_bytes"] > 0
    assert "h2d_bytes" in next(k for k in kids
                               if k.name == "encode").attributes
    # the durable commit, under persist, tagged with its bytes and sync
    (journal,) = [s for s in spans if s.name == "links.journal"]
    assert journal.attributes["bytes"] > 0
    assert journal.attributes["sync"] in ("fsync", "fdatasync", "none")
    persist = next(k for k in kids if k.name == "persist")
    parents = {s.span_id: s for s in spans}
    up = parents[journal.parent_id]
    while up.span_id != persist.span_id:
        up = parents[up.parent_id]
    # the request digest folds the true intervals into the four phases
    digest = next(d for d in tracing.RECORDER.digests()
                  if d["trace_id"] == tid)
    assert set(digest["phase_seconds"]) == {"encode", "retrieve", "score",
                                            "persist"}


def test_pass_counters_advance_and_device_time_stays_zero_on_the_cpu(
        served_app):
    app, url = served_app
    wl = app.deduplications["people"]
    post(url, entities(64, "c"))
    st = wl.processor.stats
    assert st.batches == 1
    for clock in ("dispatch_seconds", "wait_seconds", "dd_seconds",
                  "finalize_seconds"):
        assert getattr(st, clock) > 0, clock
    # the device path writes only its four intervals; /stats and the
    # phases read retrieval and compare as their sums
    assert st.retrieval_seconds == st.compare_seconds == 0.0
    assert st.retrieval_total() == pytest.approx(
        st.dispatch_seconds + st.wait_seconds)
    assert st.compare_total() == pytest.approx(
        st.dd_seconds + st.finalize_seconds)
    phases = wl.processor.phases.phase_seconds()
    assert phases["retrieve"] == pytest.approx(st.retrieval_total())
    assert phases["score"] == pytest.approx(st.compare_total())
    assert st.h2d_bytes > 0
    assert st.device_seconds == 0.0
    before = st.h2d_bytes
    post(url, entities(8, "d"))
    assert st.batches == 2 and st.h2d_bytes > before
    assert st.device_seconds == 0.0


def test_a_held_workload_lock_is_counted_as_the_dispatchers_wait(
        served_app):
    app, _ = served_app
    wl = app.deduplications["people"]
    sched = app.scheduler
    rows = entities(8, "e")
    errors = []

    def submit():
        try:
            with tracing.start_trace("lock.test", sampled=True) as root:
                holder["tid"] = root.trace_id
                sched.submit("deduplication", "people", "crm", rows)
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    holder = {}
    wl.lock.acquire()
    try:
        t = threading.Thread(target=submit)
        t.start()
        deadline = time.monotonic() + 30
        queue = None
        while time.monotonic() < deadline:
            queue = next((q for q in sched.queues() if q.name == "people"),
                         None)
            if queue is not None and queue.lock_requeues >= 1:
                break
            time.sleep(0.005)
        assert queue is not None and queue.lock_requeues >= 1
        time.sleep(0.12)
    finally:
        wl.lock.release()
    t.join(timeout=60)
    assert not errors and not t.is_alive()
    assert queue.lock_requeues >= 1
    assert queue.lock_wait_s >= 0.1
    assert queue.lock_failed_ns is None
    spans = spans_of(holder["tid"])
    (wait,) = [s for s in spans if s.name == "sched.lock_wait"]
    assert wait.duration_ns >= 0.1e9
    (batch,) = [s for s in spans if s.name == "sched.microbatch"]
    assert wait.parent_id == batch.parent_id
    assert wait.end_ns <= batch.start_ns


def test_feed_page_counts_its_hold_and_the_flusher_lands_traces(
        served_app):
    app, url = served_app
    wl = app.deduplications["people"]
    post(url, entities(16, "f"))
    pages, hold = wl.feed_pages, wl.feed_lock_hold_s
    tid = "cd" * 16
    status, body = request(
        url + "/deduplication/people?since=0",
        headers={"traceparent": tracing.format_traceparent(
            tid, "56" * 8, True)})
    assert status == 200 and json.loads(body)
    assert wl.feed_pages > pages and wl.feed_lock_hold_s > hold
    spans = spans_of(tid)
    page = next(s for s in spans if s.name == "feed.page")
    assert any(s.name == "links.drain" and s.parent_id == page.span_id
               for s in spans)
    links = wl.link_database
    assert links.journal_seconds > 0 and links.flush_seconds > 0
    flushes = [row for row in tracing.RECORDER.summaries()
               if row["name"] == "links.flush"]
    assert flushes
    record = tracing.RECORDER.get(flushes[0]["trace_id"])
    root = next(s for s in record.spans if s.name == "links.flush")
    assert root.attributes["links"] > 0


def _capture_events(path):
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def _anchor_ts(events):
    return next(e["ts"] for e in events
                if e.get("name") == profiling.CLOCK_ANCHOR)


def test_capture_carries_a_span_on_the_traces_clock(tmp_path):
    t0 = time.monotonic()
    profiling.start_capture(30, logdir=str(tmp_path))
    try:
        with tracing.start_trace("capture.test", sampled=True) as root:
            with tracing.span("held.span"):
                time.sleep(0.02)
    finally:
        done = profiling.stop_capture()
    wall_us = (time.monotonic() - t0) * 1e6
    events = _capture_events(done["trace_file"])
    anchor = float(_anchor_ts(events))
    (held,) = [e for e in events if e.get("name") == "held.span"
               and e.get("pid") == profiling.SPAN_ROW_PID]
    assert held["args"]["trace_id"] == root.trace_id
    assert held["dur"] >= 20_000 * 0.9
    assert anchor <= held["ts"]
    assert held["ts"] + held["dur"] <= anchor + wall_us


def test_debug_profile_capture_holds_the_programs_spans(served_app):
    app, url = served_app
    post(url, entities(16, "g"))
    t0 = time.monotonic()
    status, body = request(url + "/debug/profile?seconds=30", "POST", b"")
    assert status == 200
    try:
        tid = "ef" * 16
        post(url, entities(16, "h"), trace_id=tid)
        spans_of(tid)
    finally:
        done = profiling.stop_capture()
    wall_us = (time.monotonic() - t0) * 1e6
    assert done["dir"] == json.loads(body)["capturing"]["dir"]
    events = _capture_events(done["trace_file"])
    shutil.rmtree(done["dir"], ignore_errors=True)
    anchor = float(_anchor_ts(events))
    mine = [e for e in events if e.get("pid") == profiling.SPAN_ROW_PID
            and e.get("ph") == "X" and e["args"].get("trace_id") == tid]
    names = {e["name"] for e in mine}
    assert {"sched.microbatch", "encode", "scan.dispatch", "scan.wait",
            "finalize", "persist"} <= names
    for e in mine:
        assert anchor <= e["ts"] and e["ts"] + e["dur"] <= anchor + wall_us
