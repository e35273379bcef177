"""The port's fault injection drills against the JAX package's.

Twins of tests/test_faults.py's spec and drill cases on the port:

  * every token kind parses into the JAX plan's fields, garbage is
    refused, and the hashed draws (``drop``, ``slow_lock``) and the
    ``flush_fail`` occurrence hit the same sites as the JAX plan's for
    the same spec;
  * ``flush_fail=<n>`` raises ``InjectedFlushFailure`` in the write-behind
    flusher, which latches under ``DUKE_FLUSH_RETRIES=0`` (the default
    ladder heals one failure) and flips ``/readyz`` unready with
    ``/healthz`` naming the workload and the exception;
  * the mid-stream lock deadline truncates the feed and counts
    ``deadline``; ``slow_lock=<p>:<seconds>`` stalls every feed-page lock
    acquire, counts each stall, and a stall that lets a writer in drives
    that deadline abort.

Each injected fault counts in ``duke_faults_injected_total{kind}``.  The
comparisons are exact; the stall is checked against the wall clock as a
lower bound only.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from sesam_duke_microservice_tpu.utils import faults as JF
from sesam_duke_microservice_tpu_torch import telemetry
from sesam_duke_microservice_tpu_torch.core.config import parse_config
from sesam_duke_microservice_tpu_torch.links.base import (
    Link,
    LinkKind,
    LinkStatus,
)
from sesam_duke_microservice_tpu_torch.links.sqlite import SqliteLinkDatabase
from sesam_duke_microservice_tpu_torch.links.write_behind import (
    WriteBehindLinkDatabase,
)
from sesam_duke_microservice_tpu_torch.service.app import DukeApp, serve
from sesam_duke_microservice_tpu_torch.utils import faults

from test_sharded_service import DEDUP_XML, _seeded_batch
from torch_threads import torch_threads_per_worker  # noqa: F401

SPEC = ("seed=42; drop=0.5@commit; dup=0.25; delay=0.1:0.05;"
        "partition=1:10:20; crash_follower=0:7; crash_leader=33;"
        "flush_fail=2; slow_lock=0.5:0.01; crash_at=pre_flush:4;"
        "probe_flip=3; fed_down=2")


@pytest.fixture(autouse=True)
def _no_env_faults():
    faults.configure("")
    JF.configure("")
    yield
    faults.configure(None)
    JF.configure(None)


def _fault_count(kind: str) -> float:
    return telemetry.FAULTS_INJECTED.labels(kind=kind).value


# -- spec parsing and draws ---------------------------------------------------


def _fields(plan):
    return (plan.seed, plan._drop, plan._dup, plan._delay, plan._partitions,
            plan._follower_crash, plan._leader_crash, plan._flush_fail_at,
            plan._slow_lock, plan._crash_at, plan._probe_flip_at,
            plan._fed_down)


def test_fault_spec_parses_every_kind_like_jax():
    plan = faults.FaultPlan(SPEC)
    assert _fields(plan) == _fields(JF.FaultPlan(SPEC))
    assert plan._flush_fail_at == 2
    assert plan._slow_lock == (0.5, 0.01)
    assert [plan.crash_hit("pre_flush") for _ in range(5)] == [
        False, False, False, True, False]
    assert plan.crash_hit("unconfigured_site") is False


def test_fault_spec_rejects_garbage():
    with pytest.raises(ValueError, match="bad DUKE_FAULTS token"):
        faults.FaultPlan("drop=notanumber")
    with pytest.raises(ValueError, match="bad DUKE_FAULTS token"):
        faults.FaultPlan("slow_lock=0.5")
    with pytest.raises(ValueError, match="bad DUKE_FAULTS token"):
        faults.FaultPlan("flush_fail=soon")
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.FaultPlan("explode=1")


def _send_draws(pkg, spec, ops):
    plan = pkg.FaultPlan(spec)
    out = []
    for op in ops:
        try:
            plan.before_send("commit", 0, op, 0)
            out.append(False)
        except pkg.InjectedSendFailure:
            out.append(True)
    return out


def test_fault_draws_equal_the_jax_plans():
    """Same seed and site coordinates: the same decisions in both packages,
    whatever the call order (the drop draws), and the same stall
    sequence and flush occurrence."""
    ops = list(range(50))
    port = _send_draws(faults, "seed=7;drop=0.5", ops)
    assert port == _send_draws(JF, "seed=7;drop=0.5", ops)
    assert port == list(reversed(_send_draws(faults, "seed=7;drop=0.5",
                                             list(reversed(ops)))))
    assert any(port) and not all(port)
    tplan = faults.FaultPlan("seed=3;slow_lock=0.4:0.25")
    jplan = JF.FaultPlan("seed=3;slow_lock=0.4:0.25")
    stalls = [tplan.lock_delay() for _ in range(64)]
    assert stalls == [jplan.lock_delay() for _ in range(64)]
    assert set(stalls) == {0.0, 0.25}
    hits = []
    for pkg in (faults, JF):
        plan = pkg.FaultPlan("flush_fail=3")
        seen = []
        for _ in range(5):
            try:
                plan.check_flush("link write-behind")
                seen.append(False)
            except pkg.InjectedFlushFailure:
                seen.append(True)
        hits.append(seen)
    assert hits[0] == hits[1] == [False, False, True, False, False]
    assert issubclass(faults.InjectedFlushFailure, IOError)


def test_env_spec_activation(monkeypatch):
    faults.configure(None)  # let the env var through
    monkeypatch.setenv("DUKE_FAULTS", "seed=1;flush_fail=1;slow_lock=1:0")
    plan = faults.active()
    assert plan is not None and plan.seed == 1
    assert plan._flush_fail_at == 1 and plan._slow_lock == (1.0, 0.0)
    monkeypatch.delenv("DUKE_FAULTS")
    assert faults.active() is None


def test_slow_lock_fault_counts_and_stalls():
    faults.configure("slow_lock=1:0.01")
    plan = faults.active()
    before = _fault_count("slow_lock")
    assert plan.lock_delay() == 0.01
    assert _fault_count("slow_lock") == before + 1
    faults.configure("slow_lock=0:0.01")
    assert faults.active().lock_delay() == 0.0
    assert _fault_count("slow_lock") == before + 1


# -- write-behind flush failure ----------------------------------------------


def _wait_for(pred, seconds=10.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline and not pred():
        time.sleep(0.01)
    return pred()


def test_flush_fail_latches_buffer(tmp_path, monkeypatch):
    # retries off: the injected failure hits only the first flush call,
    # which the default retry ladder would heal
    monkeypatch.setenv("DUKE_FLUSH_RETRIES", "0")
    faults.configure("flush_fail=1")
    before = _fault_count("flush_fail")
    db = WriteBehindLinkDatabase(
        SqliteLinkDatabase(str(tmp_path / "links.db")))
    try:
        db.assert_link(Link("a", "b", LinkStatus.INFERRED,
                            LinkKind.DUPLICATE, 0.9))
        db.commit()
        assert _wait_for(lambda: db.flush_error is not None)
        assert isinstance(db.flush_error, faults.InjectedFlushFailure)
        assert _fault_count("flush_fail") == before + 1
        with pytest.raises(RuntimeError, match="flush failed"):
            db.drain()
    finally:
        db.close()


def test_flush_fail_heals_on_the_retry_ladder(tmp_path, monkeypatch):
    """At the default ladder the injected failure is one failed attempt:
    the retry commits the batch and nothing latches."""
    monkeypatch.setenv("DUKE_FLUSH_RETRIES", "3")
    faults.configure("flush_fail=1")
    inner = SqliteLinkDatabase(str(tmp_path / "links.db"))
    db = WriteBehindLinkDatabase(inner)
    try:
        db.assert_link(Link("a", "b", LinkStatus.INFERRED,
                            LinkKind.DUPLICATE, 0.9))
        db.commit()
        db.drain()
        assert db.flush_error is None
        assert [(l.id1, l.id2) for l in inner.get_all_links()] == [("a", "b")]
    finally:
        db.close()


def _persistent_xml(folder):
    return DEDUP_XML.replace(
        "<DukeMicroService>", f'<DukeMicroService dataFolder="{folder}">'
    ).replace(' link-database-type="in-memory"', "")


def _served(app):
    server = serve(app, port=0, host="127.0.0.1")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.mark.parametrize("backend", ["host", "device"])
def test_flush_latch_flips_readyz_and_healthz(tmp_path, monkeypatch,
                                              backend):
    """A dead persistence thread goes unready in /readyz and is named in
    /healthz before any read drains into it."""
    monkeypatch.setenv("DUKE_FLUSH_RETRIES", "0")  # latch on first failure
    app = DukeApp(parse_config(_persistent_xml(tmp_path),
                               env={"MIN_RELEVANCE": "0.05"}),
                  backend=backend, persistent=True, device="cpu")
    server, base = _served(app)
    try:
        with urllib.request.urlopen(base + "/readyz", timeout=30) as r:
            assert r.status == 200  # healthy before the fault
        faults.configure("flush_fail=1")
        wl = app.deduplications["people"]
        with wl.lock:
            wl.process_batch("crm", _seeded_batch(6))
        assert _wait_for(lambda: wl.link_database.flush_error is not None)
        ready, checks = app.readiness()
        assert ready is False and checks["link_persistence"] is False
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/readyz", timeout=30)
        assert err.value.code == 503
        assert json.loads(err.value.read())["checks"][
            "link_persistence"] is False
        # liveness stays 200 but names the latched exception
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
            assert r.status == 200
        assert "deduplication/people" in health["link_flush_errors"]
        assert "InjectedFlushFailure" in \
            health["link_flush_errors"]["deduplication/people"]
    finally:
        faults.configure("")
        server.shutdown()
        server.server_close()
        app.close()


# -- feed lock deadline -------------------------------------------------------


def _feed_app(monkeypatch, n_links=50):
    monkeypatch.setenv("FEED_PAGE_SIZE", "10")
    app = DukeApp(parse_config(DEDUP_XML, env={"MIN_RELEVANCE": "0.05"}),
                  backend="host", persistent=False)
    wl = app.deduplications["people"]
    for i in range(n_links):
        wl.link_database.assert_link(
            Link(f"crm__a{i}", f"crm__b{i}", LinkStatus.INFERRED,
                 LinkKind.DUPLICATE, 0.9, timestamp=1_700_000_000_000 + i))
    pages = []
    real_page = wl.links_page

    def hooked(since, limit):
        pages.append(since)
        return real_page(since, limit)

    wl.links_page = hooked
    return app, wl, pages


def _read_feed(base):
    """The whole feed, or None when the stream was truncated."""
    try:
        with urllib.request.urlopen(
                base + "/deduplication/people?since=0", timeout=60) as r:
            return json.loads(r.read())
    except Exception:
        return None  # truncated chunked framing: a transport error


def test_feed_midstream_deadline_abort(monkeypatch):
    """After page 1 the wrapped lock denies the feed's re-acquisitions (a
    writer holding the lock past the deadline): the retry loop backs off
    until DUKE_FEED_RETRY_DEADLINE, truncates the stream and counts
    ``deadline``."""
    monkeypatch.setenv("DUKE_FEED_RETRY_DEADLINE", "2")
    app, wl, pages = _feed_app(monkeypatch)
    deny = threading.Event()
    inner_lock = wl.lock

    class DenyingLock:
        def acquire(self, *a, **kw):
            if deny.is_set():
                return False
            ok = inner_lock.acquire(*a, **kw)
            deny.set()  # page 1 is read under this acquire
            return ok

        def release(self):
            return inner_lock.release()

        def __enter__(self):
            self.acquire()
            return self

        def __exit__(self, *exc):
            self.release()
            return False

    wl.lock = DenyingLock()
    server, base = _served(app)
    try:
        assert _read_feed(base) is None
        assert _wait_for(lambda: app.feed_aborts["deadline"] == 1, 15)
        assert pages == [0]
        deny.clear()
        wl.lock = inner_lock
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
        assert 'duke_feed_aborts_total{reason="deadline"} 1' in text
    finally:
        deny.clear()
        wl.lock = inner_lock
        server.shutdown()
        server.server_close()
        app.close()


def test_slow_lock_stalls_every_feed_page(monkeypatch):
    """``slow_lock=1:<s>`` sleeps before each page's lock acquire: the feed
    is whole, every acquire counted one stall, and the stream took at
    least the stalls' sum."""
    stall = 0.05
    app, wl, pages = _feed_app(monkeypatch)
    server, base = _served(app)
    try:
        faults.configure(f"slow_lock=1:{stall}")
        before = _fault_count("slow_lock")
        t0 = time.monotonic()
        rows = _read_feed(base)
        wall = time.monotonic() - t0
        assert rows is not None and len(rows) == 50
        stalls = _fault_count("slow_lock") - before
        # 5 full pages and the empty one that ends the stream
        assert stalls == len(pages) == 6
        assert wall >= stalls * stall
        assert app.feed_aborts["deadline"] == 0
    finally:
        faults.configure("")
        server.shutdown()
        server.server_close()
        app.close()


def test_slow_lock_stall_lets_a_writer_in_and_the_deadline_aborts(
        monkeypatch):
    """The stall before page 2's acquire lets a writer take the workload
    lock; it holds the lock past DUKE_FEED_RETRY_DEADLINE, so the feed's
    mid-stream retries give up, truncate the stream and count
    ``deadline`` -- the drill the JAX package's ``slow_lock`` drives."""
    monkeypatch.setenv("DUKE_FEED_RETRY_DEADLINE", "1")
    app, wl, pages = _feed_app(monkeypatch)
    page_read, held, release = (threading.Event() for _ in range(3))
    real_page = wl.links_page

    def first_page(since, limit):
        out = real_page(since, limit)
        page_read.set()
        return out

    wl.links_page = first_page

    def writer():
        page_read.wait(30)
        with wl.lock:  # waits for the feed to release after page 1
            held.set()
            release.wait(30)

    thread = threading.Thread(target=writer, daemon=True)
    thread.start()
    server, base = _served(app)
    try:
        faults.configure("slow_lock=1:0.5")
        before = _fault_count("slow_lock")
        assert _read_feed(base) is None
        assert held.is_set()
        assert _wait_for(lambda: app.feed_aborts["deadline"] == 1, 15)
        assert pages == [0]
        # the stall before page 1, before page 2 and before every retry
        assert _fault_count("slow_lock") - before >= 3
    finally:
        release.set()
        thread.join(30)
        faults.configure("")
        server.shutdown()
        server.server_close()
        app.close()
