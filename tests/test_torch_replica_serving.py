"""The port's replicated link feed against the leader's and the JAX
package's.

A REAL port ``Dispatcher`` drives real ``_FollowerSession`` replay loops
over loopback sockets -- framed ops with epoch and sequence fencing, the
commit digest handshake, the published link stream, and the follower's
HTTP read plane -- on the single-device ``device`` and ``ann`` backends
(the replica machinery is backend-generic; the two-process mesh runs in
tests/test_torch_multihost_serving.py).  The counterpart of
tests/test_replica_serving.py.

The bar: a follower's replica link DB, fed only by the bootstrap
``link_state`` and the ``links`` op stream, serves ``?since=`` rows
bit-identical to the leader's at the same watermark -- with retractions,
with one-to-one rewrites, page by page at a cursor -- and equal to the
JAX package's feed rows on the same batches (link clocks are counters,
one per package).  Watermark duplicates drop, a gap raises, stale epochs
are fenced, a follower's death evicts it and the survivors keep
replicating.  The journal's streaming reads (``head_seq``, ``retained``,
``batches_after``) are held against the JAX journal.
"""

import itertools
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from sesam_duke_microservice_tpu.core.config import parse_config as jparse
from sesam_duke_microservice_tpu.engine.workload import (
    build_workload as jbuild,
)
from sesam_duke_microservice_tpu.links import base as jlinkbase
from sesam_duke_microservice_tpu.links import journal as JJ
from sesam_duke_microservice_tpu.links import replica as JRep
from sesam_duke_microservice_tpu_torch import telemetry
from sesam_duke_microservice_tpu_torch.core.config import parse_config
from sesam_duke_microservice_tpu_torch.engine.workload import build_workload
from sesam_duke_microservice_tpu_torch.links import base as tlinkbase
from sesam_duke_microservice_tpu_torch.links import journal as TJ
from sesam_duke_microservice_tpu_torch.links import replica as TRep
from sesam_duke_microservice_tpu_torch.links.replica import (
    ReplicaGap,
    ReplicaLinkDatabase,
    links_feed_page,
)
from sesam_duke_microservice_tpu_torch.parallel import dispatch
from sesam_duke_microservice_tpu_torch.utils import faults

from test_sharded_service import DEDUP_XML, LINKAGE_XML, _seeded_batch
from torch_jax_cache import jax_cache_off  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

KEY = ("deduplication", "people")
ONE_TO_ONE_XML = LINKAGE_XML.replace('link-mode="many-to-many"',
                                     'link-mode="one-to-one"')
ENV = {"MIN_RELEVANCE": "0.05"}


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    """No env fault plan; one counter link clock per package (both make
    the same links in the same order, so their timestamps agree)."""
    faults.configure("")
    monkeypatch.setenv("MIN_RELEVANCE", "0.05")
    for base in (jlinkbase, tlinkbase):
        ticks = itertools.count(1_700_000_000_000)
        monkeypatch.setattr(base, "now_millis", lambda t=ticks: next(t))
    yield
    faults.configure(None)


class LoopbackFollower:
    """One follower replay loop over a socketpair: real framed ops, real
    digest handshake answers, the production ``handle_frame`` fencing."""

    def __init__(self, idx: int = 0):
        self.leader_sock, self.sock = socket.socketpair()
        self.session = dispatch._FollowerSession(self.sock.sendall,
                                                 follower_idx=idx,
                                                 device="cpu")
        self.error = None
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _loop(self) -> None:
        try:
            while True:
                op, epoch, seq = dispatch._recv_op(self.sock)
                if not self.session.handle_frame(op, epoch, seq):
                    return
        except (EOFError, OSError):
            return
        except BaseException as e:  # a crash: die hard, like the process
            self.error = e
            try:
                self.sock.close()
            except OSError:
                pass

    def close(self) -> None:
        for s in (self.sock, self.leader_sock):
            try:
                s.close()
            except OSError:
                pass
        self.thread.join(timeout=10)
        self.session.close()


class HaGroup:
    """Leader workloads, a dispatcher and N loopback followers,
    bootstrapped as ``Dispatcher.start()`` does it (minus the job's
    rendezvous)."""

    def __init__(self, xml, backend="device", n_followers=1):
        sc = parse_config(xml, env=ENV)
        self.sc = sc
        build = lambda wc: build_workload(  # noqa: E731
            wc, sc, backend=backend, device="cpu", persistent=False)
        app = type("App", (), {})()
        app.backend = backend
        app.config_string = sc.config_string
        app.deduplications = {n: build(wc)
                              for n, wc in sc.deduplications.items()}
        app.record_linkages = {n: build(wc)
                               for n, wc in sc.record_linkages.items()}
        self.app = app
        self.dispatcher = dispatch.Dispatcher(app)
        self.followers = [LoopbackFollower(i) for i in range(n_followers)]
        self.dispatcher._conns = [f.leader_sock for f in self.followers]
        self._prev = dispatch._DISPATCHER
        dispatch._DISPATCHER = self.dispatcher
        try:
            self.dispatcher._tag_workloads(app.deduplications,
                                           app.record_linkages)
            self.dispatcher._bootstrap_followers()
        except BaseException:
            self.close()
            raise

    def workload(self, name="people", kind="deduplication"):
        return (self.app.deduplications if kind == "deduplication"
                else self.app.record_linkages)[name]

    def ingest(self, batch, dataset="crm", name="people",
               kind="deduplication") -> None:
        wl = self.workload(name, kind)
        with wl.lock:
            wl.process_batch(dataset, batch)

    def wait_applied(self, follower=0, key=KEY, timeout=60) -> None:
        """Until the follower's replica watermark reaches the leader
        publisher's sequence (links ops carry no handshake)."""
        want = self.workload(key[1], key[0]).link_database.seq
        session = self.followers[follower].session
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.followers[follower].error is not None:
                raise AssertionError(
                    f"follower died: {self.followers[follower].error!r}")
            db = session.link_replicas.get(key)
            if db is not None and db.applied_seq >= want:
                return
            time.sleep(0.01)
        raise AssertionError(f"the replica never reached watermark {want}")

    def replica_feed(self, follower=0, key=KEY, since=0):
        session = self.followers[follower].session
        db = session.link_replicas[key]
        index = session.replicas[key].index
        rows, cursor = [], since
        while True:
            page, cursor = links_feed_page(db, index, cursor, 5000)
            rows.extend(page)
            if not page:
                return rows

    def leader_feed(self, name="people", kind="deduplication", since=0):
        wl = self.workload(name, kind)
        with wl.lock:
            return wl.links_since(since)

    def close(self) -> None:
        dispatch._DISPATCHER = self._prev
        try:
            self.dispatcher.close()
        finally:
            for f in self.followers:
                f.close()
            for registry in (self.app.deduplications,
                             self.app.record_linkages):
                for wl in registry.values():
                    try:
                        wl.close()
                    except Exception:
                        pass


@pytest.fixture
def group(request):
    g = HaGroup(DEDUP_XML, backend=getattr(request, "param", "device"))
    try:
        yield g
    finally:
        g.close()


def jax_feed(xml, backend, steps, name="people", kind="deduplications"):
    """The JAX package's single-process feed of ``steps`` ((dataset,
    batch) pairs) through one workload."""
    sc = jparse(xml, env=ENV)
    wl = jbuild(getattr(sc, kind)[name], sc, backend=backend,
                persistent=False)
    try:
        with wl.lock:
            for dataset, batch in steps:
                wl.process_batch(dataset, batch)
            return wl.links_since(0)
    finally:
        wl.close()


# -- feed parity --------------------------------------------------------------


@pytest.mark.parametrize("group", ["device", "ann"], indirect=True)
def test_replica_feed_parity_with_retractions(group):
    """Leader feed, follower replica feed and the JAX package's feed:
    equal rows (timestamps, ids, confidences) through ingest with
    duplicates, a second batch and a deletion (link retraction)."""
    steps = [("crm", _seeded_batch(24)), ("crm", _seeded_batch(12, "b")),
             ("crm", [{"_id": "1", "_deleted": True}])]
    for dataset, batch in steps:
        group.ingest(batch, dataset)
    group.wait_applied()
    leader_rows = group.leader_feed()
    assert group.replica_feed() == leader_rows
    assert any(r["_deleted"] for r in leader_rows), "no retraction"
    session = group.followers[0].session
    assert (session.link_replicas[KEY].applied_seq
            == group.workload().link_database.seq)
    assert session.link_replicas[KEY].lag_ops() == 0
    assert jax_feed(DEDUP_XML, group.app.backend, steps) == leader_rows


def test_replica_feed_parity_one_to_one_rewrites():
    """One-to-one record linkage: the conflict resolution retracts weaker
    links and rewrites winners across batches; the churn replicates
    bit-identically, and equals the JAX package's feed."""
    g = HaGroup(ONE_TO_ONE_XML, backend="device")
    key = ("recordlinkage", "pairing")
    steps = [("left", [{"_id": f"L{i}", "name": f"acme systems {i}"}
                       for i in range(6)]),
             ("right", [{"_id": f"R{i}", "name": f"acme systems {i % 3}"}
                        for i in range(6)]),
             ("right", [{"_id": "R9", "name": "acme systems 0"}])]
    try:
        for dataset, batch in steps:
            g.ingest(batch, dataset=dataset, name="pairing",
                     kind="recordlinkage")
        g.wait_applied(key=key)
        leader_rows = g.leader_feed(name="pairing", kind="recordlinkage")
        assert leader_rows
        assert g.replica_feed(key=key) == leader_rows
    finally:
        g.close()
    assert jax_feed(ONE_TO_ONE_XML, "device", steps, name="pairing",
                    kind="record_linkages") == leader_rows


def test_replica_pages_at_a_cursor_and_take_no_leader_lock(group):
    """Paged replica reads honour the leader's strictly-greater-than
    cursor, and the replica serves while the leader's workload lock is
    HELD."""
    group.ingest(_seeded_batch(24))
    group.wait_applied()
    leader_rows = group.leader_feed()
    assert len(leader_rows) >= 2
    mid = leader_rows[len(leader_rows) // 2 - 1]["_updated"]
    assert group.replica_feed(since=mid) == group.leader_feed(since=mid)
    wl = group.workload()
    assert wl.lock.acquire(timeout=5)
    try:
        t0 = time.monotonic()
        rows = group.replica_feed()
        elapsed = time.monotonic() - t0
    finally:
        wl.lock.release()
    assert rows == leader_rows and elapsed < 1.0


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def test_replica_http_read_plane(group):
    from sesam_duke_microservice_tpu_torch.service.replica_plane import (
        serve_replica_plane,
    )

    group.ingest(_seeded_batch(24))
    group.wait_applied()
    server = serve_replica_plane(group.followers[0].session, port=0,
                                 host="127.0.0.1")
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, headers, body = _get(base + "/deduplication/people?since=0")
        assert status == 200 and headers.get("X-Replica-Lag") == "0"
        assert json.loads(body) == group.leader_feed()
        status, _, body = _get(base + "/healthz")
        health = json.loads(body)
        assert status == 200 and health["role"] == "replica"
        assert health["replication_lag_ops"] == 0 and health["epoch"] == 1
        assert _get(base + "/readyz")[0] == 200
        stats = json.loads(_get(base + "/stats")[2])
        row = stats["workloads"][0]
        assert row["applied_seq"] == group.workload().link_database.seq
        assert row["lag_ops"] == 0 and row["links_rows"] > 0
        assert row["records_indexed"] == 24
        text = _get(base + "/metrics")[2].decode()
        assert "duke_replica_lag_ops" in text and 'workload="people"' in text
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/recordlinkage/nope?since=0")
        assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()


# -- stream discipline --------------------------------------------------------


def test_replica_watermark_drops_dups_and_raises_on_gap():
    rows1 = [("a", "b", "inferred", "duplicate", 0.9, 1000)]
    rows2 = [("c", "d", "inferred", "duplicate", 0.8, 2000)]
    for db in (ReplicaLinkDatabase(), JRep.ReplicaLinkDatabase()):
        gap = ReplicaGap if isinstance(db, ReplicaLinkDatabase) \
            else JRep.ReplicaGap
        assert db.apply_ops(1, rows1) is True
        assert db.apply_ops(1, rows1) is False  # duplicate delivery
        assert db.count() == 1
        db.note_head(3)
        assert db.lag_ops() == 2
        with pytest.raises(gap):
            db.apply_ops(3, rows2)  # seq 2 never arrived
        assert db.apply_ops(2, rows2) is True and db.lag_ops() == 1
    # the wire rows and their checksum are the JAX package's
    link = tlinkbase.Link("x", "y", tlinkbase.LinkStatus.RETRACTED,
                          tlinkbase.LinkKind.DUPLICATE, 0.25, timestamp=7)
    jlink = jlinkbase.Link("x", "y", jlinkbase.LinkStatus.RETRACTED,
                           jlinkbase.LinkKind.DUPLICATE, 0.25, timestamp=7)
    assert TRep.encode_link(link) == JRep.encode_link(jlink)
    assert TRep.encode_link(TRep.decode_link(TRep.encode_link(link))) \
        == TRep.encode_link(link)
    rows = rows1 + rows2 + [TRep.encode_link(link)]
    assert TRep.rows_checksum(rows) == JRep.rows_checksum(rows)


def test_epoch_fencing_and_fresh_seq_space():
    session = dispatch._FollowerSession(lambda frame: None, device="cpu")
    assert session.handle_frame(("bootstrap_end",), 1, 1)
    session.adopt_epoch(2)  # a promotion happened elsewhere
    assert session.handle_frame(("bootstrap_end",), 1, 2)  # zombie: drop
    assert session.stale_rejected == 1
    assert session.handle_frame(("bootstrap_end",), 2, 2)
    assert session.handle_frame(("bootstrap_end",), 2, 2)  # dup: drop
    with pytest.raises(RuntimeError, match="stream gap"):
        session.handle_frame(("bootstrap_end",), 2, 9)
    # a new leader's stream starts its own seq space
    assert session.handle_frame(("bootstrap_end",), 3, 1)
    assert session.epoch == 3 and session.last_seq == 1
    session.close()


def test_follower_eviction_degrades_not_latches(monkeypatch):
    """One follower's death evicts IT: duke_dispatch_down stays 0,
    duke_follower_evictions_total moves, and the survivor keeps
    replicating bit-identically."""
    monkeypatch.setattr(dispatch, "_CONNECT_TIMEOUT_S", 10.0)
    g = HaGroup(DEDUP_XML, backend="device", n_followers=2)
    evictions0 = telemetry.FOLLOWER_EVICTIONS.single().value
    try:
        g.ingest(_seeded_batch(12))
        g.wait_applied(follower=0)
        g.wait_applied(follower=1)
        g.followers[0].sock.close()  # follower 0 dies
        g.ingest(_seeded_batch(6, prefix="b"))
        assert g.dispatcher._failed is None
        assert telemetry.DISPATCH_DOWN.single().value == 0
        assert telemetry.FOLLOWER_EVICTIONS.single().value == evictions0 + 1
        assert len(g.dispatcher.live_followers()) == 1
        g.ingest(_seeded_batch(3, prefix="c"))
        g.wait_applied(follower=1)
        assert g.replica_feed(follower=1) == g.leader_feed()
    finally:
        g.close()


# -- the journal's streaming reads ----------------------------------------------


def test_journal_streaming_equals_jax(tmp_path, monkeypatch):
    """``head_seq``, ``retained`` and ``batches_after`` of both packages'
    journals over the same appends: equal at every step; a pinned journal
    keeps its frames through a compaction, an unpinned one drops them; a
    torn tail ends the walk silently."""
    for mod in (JJ, TJ):
        monkeypatch.setattr(mod, "_COMPACT_BYTES", 0)
    journals = [mod.LinkJournal(str(tmp_path / f"{name}.journal"))
                for mod, name in ((JJ, "jax"), (TJ, "port"))]
    batches = [[["a", "b", "inferred", "duplicate", 0.5, 1]],
               [["c", "d", "retracted", "duplicate", 0.25, 2],
                ["e", "f", "inferred", "duplicate", 0.75, 3]],
               [["g", "h", "inferred", "duplicate", 0.9, 4]]]

    def state(j):
        return (j.head_seq(), j.applied_watermark(),
                [list(j.batches_after(k)) for k in range(4)])

    try:
        for batch in batches:
            seqs = [j.append_batch(batch) for j in journals]
            assert seqs[0] == seqs[1]
            assert state(journals[0]) == state(journals[1])
        assert [s for s, _ in journals[1].batches_after(1)] == [2, 3]
        for j in journals:
            with j.retained(), j.retained():  # reentrant
                j.mark_applied(3)  # caught up: compaction is pinned off
                assert [s for s, _ in j.batches_after(0)] == [1, 2, 3]
            j.compact()
        assert state(journals[0]) == state(journals[1])
        assert list(journals[1].batches_after(0)) == []
        for j in journals:
            j.append_batch(batches[0])
            os.write(j._fd, b"B\x00torn")  # a torn frame at the tail
        assert state(journals[0]) == state(journals[1])
        assert [s for s, _ in journals[1].batches_after(0)] == [4]
    finally:
        for j in journals:
            j.close()
