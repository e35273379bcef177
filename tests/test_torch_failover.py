"""Leader failover of the port's serving group: promotion from replica
state and epoch fencing.  The counterparts of tests/test_failover.py.

The leader dies mid-ingest (an injected ``crash_leader`` fault at a fixed
op index); the follower's replicas are promoted into a serving ``DukeApp``
(``dispatch.promote_follower``), whose link DB must equal the deposed
leader's feed at the watermark -- the same rows, timestamps included --
and whose live links must equal a clean single-process run of the
committed batches, in the port and in the JAX package; it keeps ingesting,
re-binds the full HTTP frontend, refuses a config reload, and fences a
zombie ex-leader's stale broadcasts.  Promotion without replicas is
refused; a failed publish keeps its batch; the split-brain probe tells an
evicted follower from a dead leader; a zero-byte send failure heals
through the retry layer without an eviction.
"""

import json
import socket
import threading
import time
import urllib.request

import pytest

from sesam_duke_microservice_tpu_torch import telemetry
from sesam_duke_microservice_tpu_torch.core.config import parse_config
from sesam_duke_microservice_tpu_torch.engine.workload import build_workload
from sesam_duke_microservice_tpu_torch.links.base import (
    Link,
    LinkKind,
    LinkStatus,
)
from sesam_duke_microservice_tpu_torch.links.memory import (
    InMemoryLinkDatabase,
)
from sesam_duke_microservice_tpu_torch.links.replica import (
    PublishingLinkDatabase,
    ReplicaLinkDatabase,
)
from sesam_duke_microservice_tpu_torch.parallel import dispatch
from sesam_duke_microservice_tpu_torch.service.app import serve
from sesam_duke_microservice_tpu_torch.utils import faults

from test_torch_replica_serving import KEY, HaGroup
from test_sharded_service import DEDUP_XML, _seeded_batch
from test_sharded_service import _run_dedup as jax_clean_run
from torch_jax_cache import jax_cache_off  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    # the follower and the promotion parse the config with the real env
    monkeypatch.setenv("MIN_RELEVANCE", "0.05")
    faults.configure("")
    yield
    faults.configure(None)


def _live(rows):
    return sorted((r["entity1"], r["entity2"], round(r["confidence"], 9))
                  for r in rows if not r["_deleted"])


def port_clean_run(batches):
    sc = parse_config(DEDUP_XML, env={"MIN_RELEVANCE": "0.05"})
    wl = build_workload(sc.deduplications["people"], sc, backend="device",
                        device="cpu", persistent=False)
    try:
        with wl.lock:
            for batch in batches:
                wl.process_batch("crm", batch)
            return _live(wl.links_since(0))
    finally:
        wl.close()


def test_leader_crash_promotion_matches_clean_run():
    b1, b2, b3 = (_seeded_batch(24), _seeded_batch(12, prefix="b"),
                  _seeded_batch(9, prefix="d"))
    g = HaGroup(DEDUP_XML, backend="device")
    app2 = None
    try:
        g.ingest(b1)
        g.wait_applied()
        pre_crash_rows = g.leader_feed()
        # kill the leader MID-INGEST: the very next broadcast (b2's
        # corpus commit) dies before any byte reaches the wire
        faults.configure(f"crash_leader={g.dispatcher._op_index + 1}")
        with pytest.raises(faults.LeaderCrash):
            g.ingest(b2)
        faults.configure("")
        session = g.followers[0].session
        assert (session.link_replicas[KEY].applied_seq
                == g.workload().link_database.seq)

        app2 = dispatch.promote_follower(session)
        assert session.promoted and session.epoch == 2
        assert telemetry.DISPATCH_EPOCH.single().value == 2
        wl2 = app2.deduplications["people"]
        with wl2.lock:  # the deposed leader's feed, verbatim
            assert wl2.links_since(0) == pre_crash_rows
        clean = port_clean_run([b1])
        assert _live(pre_crash_rows) == clean == jax_clean_run("device",
                                                                [b1])
        # the promoted leader keeps serving writes: b1 + b3 end state
        with wl2.lock:
            wl2.process_batch("crm", b3)
            rows_after = wl2.links_since(0)
        assert (_live(rows_after) == port_clean_run([b1, b3])
                == jax_clean_run("device", [b1, b3]))

        # zombie fencing: the deposed leader broadcasts at epoch 1
        stale0 = session.stale_rejected
        seq0 = session.link_replicas[KEY].applied_seq
        g.dispatcher.broadcast(("score", KEY, []))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and session.stale_rejected == stale0:
            time.sleep(0.01)
        assert session.stale_rejected == stale0 + 1
        assert session.link_replicas[KEY].applied_seq == seq0
    finally:
        if app2 is not None:
            app2.close()
        g.close()


def test_promoted_frontend_rebinds_http_and_refuses_reload():
    """The full REST surface comes back on the promoted follower; a
    config reload there would swap in empty link DBs, so it refuses."""
    g = HaGroup(DEDUP_XML, backend="device")
    app2 = server = None
    try:
        g.ingest(_seeded_batch(24))
        g.wait_applied()
        expected = g.leader_feed()
        app2 = dispatch.promote_follower(g.followers[0].session)
        server = serve(app2, port=0, host="127.0.0.1")
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + "/deduplication/people?since=0",
                                    timeout=30) as r:
            assert r.status == 200 and json.loads(r.read()) == expected
        with urllib.request.urlopen(base + "/readyz", timeout=30) as r:
            assert r.status == 200
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            assert json.loads(r.read())["workloads"][0][
                "records_indexed"] == 24
        req = urllib.request.Request(
            base + "/deduplication/people/crm",
            json.dumps(_seeded_batch(6, prefix="x")).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
        wl2 = app2.deduplications["people"]
        with wl2.lock:
            rows_before = wl2.links_since(0)
        with pytest.raises(RuntimeError, match="promoted leader"):
            app2.reload_from_string(g.sc.config_string)
        assert app2.deduplications["people"] is wl2
        with wl2.lock:
            assert wl2.links_since(0) == rows_before
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if app2 is not None:
            app2.close()
        g.close()


def test_promote_without_replicas_refuses():
    session = dispatch._FollowerSession(lambda frame: None, device="cpu")
    with pytest.raises(RuntimeError, match="nothing to promote"):
        dispatch.promote_follower(session)
    session.close()


def test_publish_failure_keeps_seq_and_batch():
    """A publish that raises advances neither the stream seq nor drops
    the batch: the next commit re-publishes it (no ReplicaGap hole)."""
    published, fail = [], {"on": True}

    def publish(seq, rows):
        if fail["on"]:
            raise RuntimeError("broadcast failed")
        published.append((seq, list(rows)))

    db = PublishingLinkDatabase(InMemoryLinkDatabase(), publish)
    db.assert_link(Link("a", "b", LinkStatus.INFERRED, LinkKind.DUPLICATE,
                        0.9, timestamp=1000))
    with pytest.raises(RuntimeError, match="broadcast failed"):
        db.commit()
    assert db.seq == 0 and not published
    fail["on"] = False
    db.assert_link(Link("c", "d", LinkStatus.INFERRED, LinkKind.DUPLICATE,
                        0.8, timestamp=2000))
    db.commit()
    assert [seq for seq, _ in published] == [1]
    assert len(published[0][1]) == 2  # the failed batch rode along
    replica = ReplicaLinkDatabase()
    replica.apply_ops(*published[0])
    assert replica.count() == 2


def test_leader_alive_probe_tells_eviction_from_death():
    server = socket.create_server(("127.0.0.1", 0))
    host, port = server.getsockname()
    try:
        assert dispatch._leader_alive(host, port, timeout=5.0) is True
    finally:
        server.close()
    assert dispatch._leader_alive(host, port, timeout=2.0) is False


def test_zero_byte_send_failure_retries_then_heals(monkeypatch):
    g = HaGroup(DEDUP_XML, backend="device")
    try:
        real = dispatch.Dispatcher._send_tracked
        fails = {"n": 2}

        def flaky(conn, frame):
            if fails["n"] > 0:
                fails["n"] -= 1
                e = OSError("transient reset")
                e.frame_sent = 0
                raise e
            return real(conn, frame)

        monkeypatch.setattr(dispatch.Dispatcher, "_send_tracked",
                            staticmethod(flaky))
        monkeypatch.setattr(dispatch, "_RETRY_BASE_S", 0.001)
        g.ingest(_seeded_batch(6))
        assert fails["n"] == 0
        assert g.dispatcher._failed is None
        assert len(g.dispatcher.live_followers()) == 1  # NOT evicted
        g.wait_applied()
        assert g.replica_feed() == g.leader_feed()
    finally:
        g.close()
