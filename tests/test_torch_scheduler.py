"""The port's ingest scheduler and merged ingest, case for case against the
JAX package's tests/test_scheduler.py and the merge cases of
tests/test_service.py, plus one differential against the JAX scheduler.

The load-bearing contract: scheduler on vs off gives bit-identical
listener event tapes and link rows (the scheduler changes WHEN work runs,
never what it computes), and the port's coalesced microbatches give the
JAX package's tapes and rows for the same queued requests, for the
``host``, ``device`` and ``ann`` backends.

Coalescing is made deterministic as the JAX tests make it: the scheduler
is built with ``start=False``, the test waits until the queue holds the
requests, then starts it.  No test depends on the 5 ms window; where
timing matters the window is pinned.  Every test runs under its own
deadline (``bounded``) and shuts its scheduler down with a timeout.
"""

import functools
import json
import threading
import time

import pytest

from sesam_duke_microservice_tpu.core.config import parse_config as jparse
from sesam_duke_microservice_tpu.engine.scheduler import (
    IngestScheduler as JScheduler,
)
from sesam_duke_microservice_tpu.engine.workload import (
    build_workload as jbuild,
)
from sesam_duke_microservice_tpu_torch.core.config import (
    parse_config as tparse,
)
from sesam_duke_microservice_tpu_torch.engine import scheduler as S
from sesam_duke_microservice_tpu_torch.engine.scheduler import (
    DatasetGone,
    IngestScheduler,
    SchedulerClosed,
    WorkloadGone,
)
from sesam_duke_microservice_tpu_torch.engine.workload import (
    BACKENDS,
    _BatchRequest,
    build_workload,
)
from sesam_duke_microservice_tpu_torch.service import app as app_module
from sesam_duke_microservice_tpu_torch.service.app import DukeApp, serve

from test_scheduler import (
    CONFIG_XML,
    REQUESTS,
    EventLog,
    link_rows,
    post_json,
    request,
    run_off,
)
from torch_jax_cache import jax_cache_off  # noqa: F401

DRAIN = 10.0  # seconds a scheduler shutdown may take in these tests


def bounded(seconds):
    """Run the test body on a daemon thread and fail it, rather than hang
    the worker, when it outlives ``seconds``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box = {}

            def target():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # re-raised on the test thread
                    box["error"] = e

            t = threading.Thread(target=target, daemon=True)
            t.start()
            t.join(seconds)
            assert not t.is_alive(), (
                f"{fn.__name__} outlived its {seconds} s deadline")
            if "error" in box:
                raise box["error"]
        return run
    return wrap


@pytest.fixture()
def sc(monkeypatch):
    monkeypatch.setenv("MIN_RELEVANCE", "0.05")
    return tparse(CONFIG_XML)


def build(sc, name="people", backend="host"):
    return build_workload(sc.deduplications[name], sc, backend=backend,
                          device="cpu", persistent=False)


def wait_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def depth(sched):
    return sum(len(q.pending) for q in sched.queues())


def record_dispatches(log, name, wl):
    """Append (name, completion time) to ``log`` as each of ``wl``'s
    microbatches completes on the dispatcher: an order and a clock that
    the waking of the submitting threads cannot blur."""
    real = wl._run_merged

    def run(work):
        real(work)
        log.append((name, time.monotonic()))

    wl._run_merged = run


def submit_queued(sched, name, requests):
    """Queue ``requests`` in order on a stopped scheduler (each thread's
    request is in the queue before the next thread starts), start it, and
    return each request's error type name or None, in request order."""
    errors = [None] * len(requests)
    threads = []

    def one(i, dataset, entities):
        try:
            sched.submit("deduplication", name, dataset, entities)
        except Exception as e:
            errors[i] = type(e).__name__

    for i, (dataset, entities) in enumerate(requests):
        t = threading.Thread(target=one, args=(i, dataset, entities))
        t.start()
        threads.append(t)
        assert wait_until(lambda: depth(sched) == i + 1)
    sched.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return errors


def run_on(wl):
    sched = IngestScheduler(lambda kind, name: wl)
    errors = []
    try:
        for dataset, entities in REQUESTS:
            try:
                sched.submit("deduplication", wl.name, dataset, entities)
            except Exception as e:
                errors.append(type(e).__name__)
    finally:
        sched.shutdown(DRAIN)
    return errors


@pytest.mark.parametrize("backend", ["host", "device", "ann"])
@bounded(60)
def test_scheduler_on_off_bit_identical(sc, backend):
    """Same request sequence through the scheduler vs the direct lock
    path: identical event tape, identical link rows, per-request errors
    stay per-request."""
    tapes, rows, errs = [], [], []
    for runner in (run_off, run_on):
        wl = build(sc, backend=backend)
        log = EventLog()
        wl.processor.add_match_listener(log)
        try:
            errs.append(runner(wl))
            tapes.append(log.events)
            rows.append(link_rows(wl))
        finally:
            wl.close()
    assert errs[0] == errs[1]
    assert len(errs[0]) == 1, (
        "exactly the conversion-error request must fail in both modes")
    assert tapes[0] == tapes[1]
    assert rows[0] == rows[1]
    assert rows[0], "the duplicate upsert must have produced links"


@pytest.mark.parametrize("backend", ["host", "device", "ann"])
@bounded(60)
def test_coalesced_microbatches_equal_jax_scheduler(sc, backend):
    """The same queued requests through the JAX scheduler and the port's:
    one coalesced dispatch, split at the delete/upsert conflict, with equal
    errors, event tapes and link rows."""
    results = []
    for package in ("jax", "port"):
        if package == "jax":
            jsc = jparse(CONFIG_XML)
            wl = jbuild(jsc.deduplications["people"], jsc, backend=backend,
                        persistent=False)
            sched = JScheduler(lambda kind, name: wl, start=False)
        else:
            wl = build(sc, backend=backend)
            sched = IngestScheduler(lambda kind, name: wl, start=False)
        log = EventLog()
        wl.processor.add_match_listener(log)
        try:
            errors = submit_queued(sched, "people", REQUESTS)
            (q,) = sched.queues()
            results.append((errors, log.events, link_rows(wl),
                            q.microbatches, q.merged_requests))
        finally:
            sched.shutdown(DRAIN)
            wl.close()
    jax, port = results
    assert port == jax
    errors, tape, rows, microbatches, merged = port
    assert errors == [None, None, "IngestError", None, None]
    assert microbatches == 1 and merged == len(REQUESTS)
    # the a2 delete after the a2 upsert split the merged pass in two
    assert [e for e in tape if e[0] == "batch_ready"] == [
        ("batch_ready", 3), ("batch_ready", 2)]
    assert rows


def test_bucket_helpers_exposed():
    from sesam_duke_microservice_tpu_torch.engine.device_matcher import (
        bucket_for,
        query_buckets,
    )

    ladder = query_buckets()
    assert ladder == tuple(sorted(ladder))
    assert bucket_for(1) == ladder[0]
    assert bucket_for(ladder[-1] + 1) == ladder[-1]
    for b in ladder:
        assert bucket_for(b) == b
    assert IngestScheduler(lambda k, n: None, start=False)._buckets == ladder


@bounded(20)
def test_concurrent_submits_coalesce_into_one_microbatch(sc):
    """Requests queued before the dispatcher starts ride ONE microbatch."""
    wl = build(sc)
    sched = IngestScheduler(lambda kind, name: wl, start=False)
    try:
        errors = submit_queued(sched, "people", [
            ("crm", [{"_id": f"c{i}a", "name": f"co {i}", "email": f"{i}@x"},
                     {"_id": f"c{i}b", "name": f"co {i}", "email": f"{i}@x"}])
            for i in range(3)])
        assert errors == [None] * 3
        (q,) = sched.queues()
        assert q.microbatches == 1
        assert q.merged_requests == 3
        assert q.dispatched_records == 6
        assert len(link_rows(wl)) == 3  # one dup pair per request
    finally:
        sched.shutdown(DRAIN)
        wl.close()


@bounded(20)
def test_submit_after_shutdown_raises_closed(sc):
    wl = build(sc)
    sched = IngestScheduler(lambda kind, name: wl)
    sched.shutdown(DRAIN)
    with pytest.raises(SchedulerClosed):
        sched.submit("deduplication", "people", "crm", [{"_id": "x"}])
    wl.close()


@bounded(20)
def test_shutdown_drains_queued_requests(sc):
    """Requests queued at shutdown complete normally -- never lost, never
    completed twice."""
    wl = build(sc)
    log = EventLog()
    wl.processor.add_match_listener(log)
    sched = IngestScheduler(lambda kind, name: wl, start=False)
    done = []
    lock = threading.Lock()

    def one(i):
        sched.submit("deduplication", "people", "crm",
                     [{"_id": f"d{i}", "name": f"drain {i}",
                       "email": f"d{i}@x"}])
        with lock:
            done.append(i)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    assert wait_until(lambda: depth(sched) == 4)
    sched.start()
    sched.shutdown(DRAIN)  # stops admission, drains, joins
    for t in threads:
        t.join(timeout=10)
    assert sorted(done) == [0, 1, 2, 3]
    assert wl.index.find_record_by_id("crm__d0") is not None
    assert wl.index.find_record_by_id("crm__d3") is not None
    scored = sorted(e[1] for e in log.events if e[0] == "none")
    assert scored == [f"crm__d{i}" for i in range(4)]  # each exactly once
    wl.close()


@bounded(20)
def test_workload_gone_fails_queued_requests(sc):
    wl = build(sc)
    live = {"wl": wl}
    sched = IngestScheduler(lambda kind, name: live["wl"], start=False)
    results = []

    def one():
        try:
            sched.submit("deduplication", "people", "crm",
                         [{"_id": "g1", "name": "gone", "email": "g@x"}])
            results.append("ok")
        except WorkloadGone:
            results.append("gone")

    t = threading.Thread(target=one)
    t.start()
    assert wait_until(lambda: depth(sched) == 1)
    live["wl"] = None  # the registry dropped the workload
    sched.start()
    t.join(timeout=10)
    assert results == ["gone"]
    sched.shutdown(DRAIN)
    wl.close()


@bounded(20)
def test_dataset_gone_fails_request(sc):
    """A queued request whose dataset the resolved workload does not
    define fails with DatasetGone (the HTTP 404), not a bare KeyError 500
    out of the merge."""
    # 'orgs' stands in for the replacement: it has no 'crm' datasource
    replacement = build(sc, "orgs")
    sched = IngestScheduler(lambda kind, name: replacement)
    try:
        with pytest.raises(DatasetGone) as exc:
            sched.submit("deduplication", "people", "crm",
                         [{"_id": "dg1", "name": "x", "email": "x@x"}])
        assert exc.value.dataset_id == "crm"
    finally:
        sched.shutdown(DRAIN)
        replacement.close()


@bounded(20)
def test_removed_workload_queue_ages_out(sc):
    """A tenant queue whose workload the registry dropped disappears from
    the scheduler (no dead DRR rotation entry)."""
    people, orgs = build(sc), build(sc, "orgs")
    registry = {"people": people, "orgs": orgs}
    sched = IngestScheduler(lambda kind, name: registry.get(name))
    try:
        sched.submit("deduplication", "people", "crm",
                     [{"_id": "ao1", "name": "ager", "email": "a@x"}])
        assert [q.name for q in sched.queues()] == ["people"]
        del registry["people"]
        # traffic to another tenant drives the rounds that age it out
        sched.submit("deduplication", "orgs", "reg",
                     [{"_id": "ao2", "name": "other tenant"}])
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if all(q.name != "people" for q in sched.queues()):
                break
            sched.submit("deduplication", "orgs", "reg",
                         [{"_id": "ao3", "name": "other tenant again"}])
        assert all(q.name != "people" for q in sched.queues())
    finally:
        sched.shutdown(DRAIN)
        people.close()
        orgs.close()


@bounded(20)
def test_sparse_tenant_window_does_not_stall_full_tenant(sc, monkeypatch):
    """A sparse tenant inside its coalesce window must not hold the
    dispatcher: tenants with dispatchable work are served first and the
    sparse batch rides a later round (or its window expiry)."""
    monkeypatch.setenv("DUKE_SCHED_WINDOW_MS", "500")
    sparse, full = build(sc, "orgs"), build(sc)
    registry = {"orgs": sparse, "people": full}
    dispatched = []
    for name, wl in registry.items():
        record_dispatches(dispatched, name, wl)
    sched = IngestScheduler(lambda kind, name: registry[name], start=False)

    def sparse_post():
        sched.submit("deduplication", "orgs", "reg",
                     [{"_id": "sp1", "name": "sparse tenant"}])

    def full_post(i):
        sched.submit("deduplication", "people", "crm",
                     [{"_id": f"fl{i}-{j}", "name": f"full {i} {j}",
                       "email": f"f{i}{j}@x"} for j in range(8)])

    ts = threading.Thread(target=sparse_post)
    ts.start()
    assert wait_until(lambda: depth(sched) == 1)
    # 4 x 8 records fills the 32-query bucket (conftest ladder 8,32), so
    # the full tenant is dispatchable with no window to honor
    tf = [threading.Thread(target=full_post, args=(i,)) for i in range(4)]
    for t in tf:
        t.start()
    assert wait_until(lambda: depth(sched) == 5)
    t0 = time.monotonic()
    sched.start()
    for t in tf:
        t.join(timeout=10)
    ts.join(timeout=10)
    assert not any(t.is_alive() for t in tf + [ts])
    order = [name for name, _ in dispatched]
    assert order[0] == "people" and "orgs" in order
    full_first = dispatched[0][1]
    assert full_first - t0 < 0.4, (
        "full tenant stalled behind the sparse tenant's coalesce window")
    sched.shutdown(DRAIN)
    sparse.close()
    full.close()


@bounded(20)
def test_drr_fairness_hot_tenant_cannot_starve(sc, monkeypatch):
    """A hot tenant's deep queue must not delay another workload's single
    request to the end of the hot backlog: DRR gives every workload a
    quantum per round."""
    monkeypatch.setenv("DUKE_SCHED_QUANTUM", "8")
    monkeypatch.setenv("DUKE_SCHED_WINDOW_MS", "0")
    hot, cold = build(sc), build(sc, "orgs")
    registry = {"people": hot, "orgs": cold}
    dispatched = []
    for name, wl in registry.items():
        record_dispatches(dispatched, name, wl)
    sched = IngestScheduler(lambda kind, name: registry[name], start=False)

    def hot_post(i):
        sched.submit("deduplication", "people", "crm",
                     [{"_id": f"h{i}-{j}", "name": f"hot {i} {j}",
                       "email": f"h{i}{j}@x"} for j in range(8)])

    def cold_post():
        sched.submit("deduplication", "orgs", "reg",
                     [{"_id": "cold1", "name": "the cold tenant"}])

    threads = [threading.Thread(target=hot_post, args=(i,))
               for i in range(10)]
    for t in threads:
        t.start()
    assert wait_until(lambda: depth(sched) == 10)
    tc = threading.Thread(target=cold_post)
    tc.start()
    assert wait_until(lambda: depth(sched) == 11)
    sched.start()
    for t in threads:
        t.join(timeout=10)
    tc.join(timeout=10)
    assert not any(t.is_alive() for t in threads + [tc])
    order = [name for name, _ in dispatched]
    assert order.count("orgs") == 1
    # the cold request must complete well before the hot backlog drains
    # (DRR: it rides round 1 or 2, not round 10): at most 4 hot
    # microbatches complete before it
    assert order.index("orgs") <= 4, (
        f"cold tenant starved behind the hot queue: {order}")
    hot_q = next(q for q in sched.queues() if q.name == "people")
    assert hot_q.microbatches >= 5
    sched.shutdown(DRAIN)
    hot.close()
    cold.close()


@pytest.mark.parametrize("spec, want", [
    ("people=2,deduplication/orgs=0.5", {"people": 2.0,
                                         "deduplication/orgs": 0.5}),
    ("people=2,,=3,orgs", {"people": 2.0}),
    ("people=-1, orgs = x", {"people": 0.0}),
])
def test_parse_tenant_weights(spec, want):
    assert S.parse_tenant_weights(spec) == want


def test_retry_after_policy():
    assert S.fold_ewma(None, 4.0) == 4.0
    assert S.fold_ewma(4.0, 1.0) == pytest.approx(3.1)
    assert [S.retry_after_seconds(x) for x in (0.0, 0.2, 3.1, 600.0)] == \
        [1, 1, 4, 60]


# -- HTTP surface ----------------------------------------------------------


class served:
    """``DukeApp(backend="host")`` over HTTP on a free port; shut down and
    closed on exit."""

    def __init__(self, sc, **kwargs):
        self.app = DukeApp(sc, backend=kwargs.pop("backend", "host"),
                           device="cpu", persistent=False, **kwargs)

    def __enter__(self):
        self.server = serve(self.app, port=0, host="127.0.0.1")
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        return self.app, f"http://127.0.0.1:{self.server.server_address[1]}"

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        self.app.close()


@bounded(30)
def test_backpressure_429_with_retry_after(sc, monkeypatch):
    """Past DUKE_SCHED_QUEUE_MAX pending requests the service answers 429
    with a Retry-After header instead of queueing unboundedly."""
    monkeypatch.setenv("DUKE_SCHEDULER", "1")
    monkeypatch.setenv("DUKE_SCHED_QUEUE_MAX", "2")
    monkeypatch.setenv("DUKE_SCHED_WINDOW_MS", "0")
    with served(sc) as (app, url):
        wl = app.deduplications["people"]
        results = []
        lock = threading.Lock()

        def post_one(i):
            status, headers, body = post_json(
                url + "/deduplication/people/crm",
                [{"_id": f"bp{i}-{j}", "name": f"press {i} {j}",
                  "email": f"bp{i}{j}@x"} for j in range(8)])
            with lock:
                results.append((status, headers.get("Retry-After"), body))

        threads = []
        wl.lock.acquire()  # wedge the dispatcher mid-batch
        try:
            for i in range(6):
                t = threading.Thread(target=post_one, args=(i,))
                t.start()
                threads.append(t)
                time.sleep(0.1)  # deterministic arrival order
            time.sleep(0.3)
        finally:
            wl.lock.release()
        for t in threads:
            t.join(timeout=20)
        assert not any(t.is_alive() for t in threads)
        statuses = sorted(s for s, _, _ in results)
        assert set(statuses) <= {200, 429}
        assert statuses.count(429) >= 1, results
        assert statuses.count(200) >= 2, results
        for status, retry_after, body in results:
            if status == 429:
                assert retry_after is not None and int(retry_after) >= 1
                assert b"ingest queue is full" in body
        (people,) = [w for w in app.scheduler.stats_snapshot()["workloads"]
                     if w["name"] == "people"]
        assert people["rejected"] >= 1
        assert people["retry_after_hint"] >= 1


@bounded(20)
def test_scheduler_off_env_restores_direct_path(sc, monkeypatch):
    monkeypatch.setenv("DUKE_SCHEDULER", "0")
    calls = []
    real = app_module.Workload.submit_batch

    def spy(self, *args, **kwargs):
        calls.append(args[0])
        return real(self, *args, **kwargs)

    monkeypatch.setattr(app_module.Workload, "submit_batch", spy)
    with served(sc) as (app, url):
        assert app.scheduler is None
        status, _, body = post_json(
            url + "/deduplication/people/crm",
            [{"_id": "off1", "name": "no scheduler", "email": "o@x"}])
        assert status == 200 and json.loads(body)["success"]
        assert calls == ["crm"]
        assert app.deduplications["people"].index.find_record_by_id(
            "crm__off1") is not None


@pytest.mark.parametrize("scheduler", ["1", "0"])
@bounded(20)
def test_per_request_error_stays_per_request_over_http(sc, monkeypatch,
                                                       scheduler):
    monkeypatch.setenv("DUKE_SCHEDULER", scheduler)
    with served(sc) as (app, url):
        status, _, body = post_json(url + "/deduplication/people/crm",
                                    [{"name": "no id"}])
        assert status == 500 and b"Batch processing failed" in body
        status, _, _ = post_json(
            url + "/deduplication/people/crm",
            [{"_id": "ok1", "name": "fine", "email": "f@x"}])
        assert status == 200


@bounded(20)
def test_busy_503_carries_retry_after(sc, monkeypatch):
    """Read-path lock-timeout 503s get a Retry-After derived from recent
    write-hold observations; the reference body is unchanged."""
    with served(sc) as (app, url):
        wl = app.deduplications["people"]
        # two observations -> EWMA 0.7*4 + 0.3*1 = 3.1 -> ceil 4
        wl.note_lock_hold(4.0)
        wl.note_lock_hold(1.0)
        assert wl.busy_retry_after() == 4
        monkeypatch.setattr(app_module, "READ_LOCK_TIMEOUT_SECONDS", 0.05)
        with wl.lock:
            status, headers, body = request(url + "/deduplication/people")
            assert status == 503
            assert b"being written to" in body
            assert headers.get("Retry-After") == "4"
        # no write observed yet: the hint is the 1 s floor
        orgs = app.deduplications["orgs"]
        with orgs.lock:
            status, headers, _ = request(url + "/deduplication/orgs")
        assert status == 503 and headers.get("Retry-After") == "1"


@bounded(20)
def test_stats_snapshot_exposes_scheduler(sc, monkeypatch):
    monkeypatch.setenv("DUKE_SCHEDULER", "1")
    with served(sc) as (app, url):
        status, _, _ = post_json(
            url + "/deduplication/people/crm",
            [{"_id": "m1", "name": "metrics person", "email": "m@x"}])
        assert status == 200
        block = app.scheduler.stats_snapshot()
        assert block["queue_max"] == 256 and block["window_ms"] == 5.0
        assert block["quantum_records"] == 4096
        assert block["min_share"] == 0.05
        assert block["sec_per_record_ewma"] > 0
        (people,) = [w for w in block["workloads"] if w["name"] == "people"]
        assert people["admitted"] == 1 and people["microbatches"] == 1
        assert people["records_dispatched"] == 1
        assert people["merged_requests"] == 1
        assert people["depth"] == 0 and people["queued_records"] == 0
        assert people["rejected"] == 0 and people["throttled"] == 0
        assert people["weight"] == 1.0
        assert people["avg_wait_ms"] >= 0
        assert people["retry_after_hint"] >= 1


@bounded(30)
def test_close_drains_queue_before_closing_workloads(sc, monkeypatch):
    """``DukeApp.close()`` drains the scheduler first: requests queued
    behind a held workload lock all complete exactly once against the
    still-open workload, then the workloads close and admission refuses."""
    monkeypatch.setenv("DUKE_SCHED_WINDOW_MS", "0")
    app = DukeApp(sc, backend="host", device="cpu", persistent=False)
    wl = app.deduplications["people"]
    log = EventLog()
    wl.processor.add_match_listener(log)
    done, lock = [], threading.Lock()

    def one(i):
        app.scheduler.submit("deduplication", "people", "crm",
                             [{"_id": f"cl{i}", "name": f"closing {i}",
                               "email": f"cl{i}@x"}])
        with lock:
            done.append(i)

    wl.lock.acquire()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    assert wait_until(lambda: app.scheduler.queues()
                      and app.scheduler.queues()[0].admitted == 4)
    closer = threading.Thread(target=app.close)
    closer.start()
    time.sleep(0.2)
    assert not wl.closed  # close() waits on the drain, not the lock
    wl.lock.release()
    closer.join(timeout=20)
    for t in threads:
        t.join(timeout=10)
    assert not closer.is_alive() and sorted(done) == [0, 1, 2, 3]
    assert wl.closed
    scored = sorted(e[1] for e in log.events if e[0] == "none")
    assert scored == [f"crm__cl{i}" for i in range(4)]
    with pytest.raises(SchedulerClosed):
        app.scheduler.submit("deduplication", "people", "crm",
                             [{"_id": "late", "name": "late"}])


@bounded(20)
def test_direct_path_after_close_answers_503(sc, monkeypatch):
    monkeypatch.setenv("DUKE_SCHEDULER", "0")
    with served(sc) as (app, url):
        app.deduplications["people"].closed = True
        status, _, body = post_json(url + "/deduplication/people/crm",
                                    [{"_id": "z", "name": "z"}])
        assert status == 503 and b"shutting down" in body
        app.deduplications["people"].closed = False


def test_cli_offers_the_host_backend():
    assert BACKENDS == ("device", "ann", "sharded", "sharded-brute", "host")


# -- the merge cases of tests/test_service.py ---------------------------------


@bounded(30)
def test_concurrent_posts_microbatch_and_all_succeed(sc):
    """Concurrent small POSTs merge into workload microbatches; every
    request still gets its own success/error and all links land."""
    with served(sc) as (app, url):
        results, lock = [], threading.Lock()

        def poster(i):
            status, _, body = post_json(
                f"{url}/deduplication/people/crm",
                [{"_id": f"mb{i}", "name": f"micro batch {i}",
                  "email": f"mb{i}@x"},
                 {"_id": f"mb{i}-dup", "name": f"micro batch {i}",
                  "email": f"mb{i}@x"}])
            with lock:
                results.append((status, body))

        threads = [threading.Thread(target=poster, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
        assert all(s == 200 for s, _ in results), results
        assert all(json.loads(b)["success"] for _, b in results)
        _, _, feed = request(f"{url}/deduplication/people?since=0")
        ids = {row["_id"] for row in json.loads(feed)}
        for i in range(8):
            assert any(f"mb{i}-dup" in rid and f"mb{i}" in rid
                       for rid in ids), (i, ids)

        statuses = []

        def post_one(payload):
            status, _, _ = post_json(f"{url}/deduplication/people/crm",
                                     payload)
            with lock:
                statuses.append(status)

        threads = [
            threading.Thread(target=post_one,
                             args=([{"_id": f"ok{i}", "name": f"fine {i}",
                                     "email": f"ok{i}@x"}],))
            for i in range(3)
        ] + [threading.Thread(target=post_one,
                              args=([{"name": "missing id"}],))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
        assert sorted(statuses) == [200, 200, 200, 500]


@pytest.mark.parametrize("backend", ["host", "device"])
@bounded(30)
def test_merged_conflicting_delete_upsert_is_serializable(sc, backend):
    """Req A (delete X, add Y) merged with req B (delete Y, add X) must
    end in a state matching a serial execution of the merged requests:
    the merge splits at the delete/upsert conflict, so the outcome equals
    queue order A;B: X re-added live, Y deleted."""
    wl = build(sc, backend=backend)
    try:
        with wl.lock:
            wl.process_batch("crm", [
                {"_id": "x", "name": "xavier", "email": "x@a.no"},
                {"_id": "y", "name": "yvonne", "email": "y@a.no"},
            ])
        req_a = _BatchRequest("crm", [
            {"_id": "x", "_deleted": True},
            {"_id": "y", "name": "yvonne2", "email": "y@a.no"},
        ])
        req_b = _BatchRequest("crm", [
            {"_id": "y", "_deleted": True},
            {"_id": "x", "name": "xavier2", "email": "x@a.no"},
        ])
        with wl.lock:
            wl._run_merged([req_a, req_b])
        assert req_a.error is None and req_b.error is None
        assert req_a.event.is_set() and req_b.event.is_set()
        rx = wl.index.find_record_by_id("crm__x")
        ry = wl.index.find_record_by_id("crm__y")
        assert rx is not None and not rx.is_deleted()
        assert ry is not None and ry.is_deleted()
    finally:
        wl.close()


@bounded(30)
def test_merged_flush_skips_sync_stamp_after_partial_store_write(
        tmp_path, monkeypatch):
    """If one merged request's store put_many commits but its tombstone
    indexing then raises, the flush must NOT stamp the store content hash
    as synced because another request of the group succeeded; the latch is
    sticky, and the process_batch path sets it too."""
    monkeypatch.setenv("MIN_RELEVANCE", "0.05")

    def persistent(folder):
        sc = tparse(CONFIG_XML.replace(
            "<DukeMicroService>", f'<DukeMicroService dataFolder="{folder}">'))
        return build_workload(sc.deduplications["people"], sc,
                              backend="host", persistent=True)

    wl = persistent(tmp_path)
    try:
        with wl.lock:
            wl.process_batch("crm", [
                {"_id": "x", "name": "xavier", "email": "x@a.no"}])
        stamps = []
        wl.index.mark_store_synced = lambda h: stamps.append(h)
        real_index = wl.index.index

        def failing_index(record):
            if record.is_deleted():
                raise RuntimeError("tombstone indexing failed")
            return real_index(record)

        wl.index.index = failing_index
        req_a = _BatchRequest("crm", [{"_id": "x", "_deleted": True}])
        req_b = _BatchRequest("crm", [
            {"_id": "z", "name": "zelda", "email": "z@a.no"}])
        with wl.lock:
            wl._run_merged([req_a, req_b])
        assert isinstance(req_a.error, RuntimeError)
        assert req_b.error is None and req_b.event.is_set()
        assert stamps == []
        # sticky: a later clean flush must not stamp either
        wl.index.index = real_index
        req_c = _BatchRequest("crm", [
            {"_id": "w", "name": "willa", "email": "w@a.no"}])
        with wl.lock:
            wl._run_merged([req_c])
        assert req_c.error is None
        assert stamps == []

        wl2 = persistent(tmp_path / "wl2")
        try:
            stamps2 = []
            wl2.index.mark_store_synced = lambda h: stamps2.append(h)
            wl2.index.index = failing_index
            with wl2.lock:
                with pytest.raises(RuntimeError):
                    wl2.process_batch("crm", [{"_id": "q", "_deleted": True}])
            wl2.index.index = wl2.index.__class__.index.__get__(wl2.index)
            with wl2.lock:
                wl2.process_batch("crm", [
                    {"_id": "p", "name": "pat", "email": "p@a.no"}])
            assert stamps2 == []
            assert wl2._store_dirty
        finally:
            wl2.close()
    finally:
        wl.close()
