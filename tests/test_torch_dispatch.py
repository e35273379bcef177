"""The port's dispatch wire and op stream against the JAX package's.

``parallel/dispatch.py`` of both packages, driven over loopback sockets
in one process (no job needed):

  * the raw frames -- the ``SDMT1`` join hello and the ``SDMD2`` commit
    digest -- and the op frame header are byte-equal to the JAX
    package's for the same token, follower index, digest and span blob;
    the fault plan's hashed draws hit the same sites;
  * the join handshake authenticates before any pickle: a crafted pickle
    is never executed, a wrong token is refused, the follower's index
    comes from the frame;
  * a frontend commit or scoring failure after the broadcast latches the
    dispatcher; a corrupt follower mirror, a failed replay and a dead
    follower each evict that follower instead;
  * the chained mirror digest equals the JAX package's for the same
    batches, bit for bit;
  * the bootstrap state stream is chunk-bounded, a follower assembles an
    equivalent replica from it (and again on a reload), and an empty
    corpus streams no payload -- on the port's ``sharded`` backend over
    a four-shard CPU mesh.
"""

import pickle
import socket
import struct
import threading

import pytest
import torch

from sesam_duke_microservice_tpu.parallel import dispatch as JD
from sesam_duke_microservice_tpu.utils import faults as JF
from sesam_duke_microservice_tpu_torch import telemetry as TT
from sesam_duke_microservice_tpu_torch.core.config import parse_config
from sesam_duke_microservice_tpu_torch.engine import sharded_matcher as TSM
from sesam_duke_microservice_tpu_torch.engine.device_matcher import (
    DeviceProcessor,
)
from sesam_duke_microservice_tpu_torch.engine.workload import build_workload
from sesam_duke_microservice_tpu_torch.parallel import dispatch as TD
from sesam_duke_microservice_tpu_torch.store.records import EMPTY_CONTENT_HASH
from sesam_duke_microservice_tpu_torch.utils import faults as TF

from test_sharded_service import DEDUP_XML, _seeded_batch
from test_torch_growth import JAX, PORT
from torch_jax_cache import jax_cache_off  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

KEY = ("deduplication", "t")
PEOPLE = ("deduplication", "people")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def no_faults():
    """An explicit empty plan: an env DUKE_FAULTS spec cannot distort the
    exact eviction and latch behaviour asserted here."""
    TF.configure("")
    yield
    TF.configure(None)


# -- the wire -------------------------------------------------------------------


@pytest.mark.parametrize("token, idx", [("secret-token", 0), ("x", 3),
                                        ("x" * 500, 2**40), ("", 1)],
                         ids=["token", "short", "long", "empty"])
def test_hello_frames_byte_equal_to_jax(token, idx):
    assert TD._hello_frame(token, idx) == JD._hello_frame(token, idx)
    assert len(TD._hello_frame(token, idx)) == TD._HELLO_LEN == JD._HELLO_LEN


@pytest.mark.parametrize("ok, digest, spans", [
    (True, bytes(range(32)), b""),
    (False, b"", b""),
    (True, b"\xff" * 32, b'[{"name":"follower:commit"}]'),
    (True, b"short", b"x" * (5 << 20)),  # oversized blob is dropped
], ids=["ok", "replay_failed", "with_spans", "short_digest_big_blob"])
def test_digest_frames_byte_equal_to_jax(ok, digest, spans):
    assert (TD._digest_frame(ok, digest, spans)
            == JD._digest_frame(ok, digest, spans))


def test_op_header_and_constants_equal_jax():
    assert TD._HDR.format == JD._HDR.format
    assert TD._HDR.pack(123, 2, 7) == JD._HDR.pack(123, 2, 7)
    for name in ("_HELLO_MAGIC", "_DIGEST_MAGIC", "_DIGEST_LEN",
                 "_SPAN_BLOB_MAX", "_KV_ADDR_KEY", "_SNAP_CHUNK",
                 "_REC_BATCH"):
        assert getattr(TD, name) == getattr(JD, name), name


def test_fault_plan_hits_the_jax_sites():
    """One spec injects the same faults at the same ops in both
    packages: the draws hash the same coordinates."""
    spec = "seed=7;drop=0.3@commit;dup=0.2;delay=0.1:0@score"
    tp, jp = TF.FaultPlan(spec), JF.FaultPlan(spec)
    for op in range(1, 40):
        for f in (0, 1):
            for tag in ("commit", "score"):
                assert tp.dup_send(tag, f, op) == jp.dup_send(tag, f, op)
                dropped = []
                for plan in (tp, jp):
                    try:
                        plan.before_send(tag, f, op, 0)
                        dropped.append(False)
                    except OSError:
                        dropped.append(True)
                assert dropped[0] == dropped[1]
    tp = TF.FaultPlan("partition=1:3:5;crash_leader=4;crash_follower=0:2")
    with pytest.raises(TF.InjectedSendFailure):
        tp.before_send("commit", 1, 3, 2)
    tp.before_send("commit", 0, 3, 2)
    with pytest.raises(TF.LeaderCrash):
        tp.check_leader_crash(4)
    assert tp.follower_crash(0, 2) and not tp.follower_crash(1, 2)


# -- the join handshake -----------------------------------------------------------

PWNED = {"hit": False}


def _set_pwned():
    PWNED["hit"] = True
    return ()


class _Evil:
    def __reduce__(self):
        return (_set_pwned, ())


def _accept_in_thread(n, token, monkeypatch):
    monkeypatch.setattr(TD, "_CONNECT_TIMEOUT_S", 10.0)
    d = TD.Dispatcher(app=None)
    d._server = socket.create_server(("127.0.0.1", 0))
    port = d._server.getsockname()[1]
    t = threading.Thread(target=d._accept_followers, args=(n, token),
                         daemon=True)
    t.start()
    return d, port, t


def test_crafted_pickle_rejected_without_execution(monkeypatch):
    PWNED["hit"] = False
    d, port, t = _accept_in_thread(1, "secret-token", monkeypatch)
    try:
        evil = pickle.dumps(("hello", _Evil()))
        attacker = socket.create_connection(("127.0.0.1", port), timeout=5)
        attacker.sendall(struct.pack(">Q", len(evil)) + evil)
        attacker.shutdown(socket.SHUT_WR)
        attacker.settimeout(5)
        assert attacker.recv(1) == b""  # refused: the server hung up
        attacker.close()
        assert not PWNED["hit"], "a crafted pickle ran before the handshake"
        assert d._conns == []
        good = socket.create_connection(("127.0.0.1", port), timeout=5)
        good.sendall(JD._hello_frame("secret-token"))  # the JAX frame too
        t.join(timeout=10)
        assert not t.is_alive() and len(d._conns) == 1
        good.close()
    finally:
        d._server.close()
        for c in d._conns:
            c.close()


def test_wrong_token_refused_and_index_from_the_frame(monkeypatch):
    d, port, t = _accept_in_thread(2, "right", monkeypatch)
    conns = []
    try:
        bad = socket.create_connection(("127.0.0.1", port), timeout=5)
        bad.sendall(TD._hello_frame("wrong"))
        bad.settimeout(5)
        assert bad.recv(1) == b""
        bad.close()
        # connect in REVERSE process order: the index comes from the frame
        for idx in (1, 0):
            c = socket.create_connection(("127.0.0.1", port), timeout=5)
            c.sendall(TD._hello_frame("right", idx))
            conns.append(c)
        t.join(timeout=10)
        assert not t.is_alive()
        assert [f.idx for f in d._followers] == [1, 0]
    finally:
        d._server.close()
        for c in conns + d._conns:
            c.close()


def test_preshared_token_env(monkeypatch):
    monkeypatch.setenv("DUKE_DISPATCH_TOKEN", "psk")
    assert TD._join_token() == "psk"
    monkeypatch.delenv("DUKE_DISPATCH_TOKEN")
    assert TD._join_token() is None


# -- latch and evict ----------------------------------------------------------------


class _StubDispatcher:
    """Records broadcasts and the failure latch (no sockets)."""

    def __init__(self):
        self.ops = []
        self.failed = None

    def broadcast(self, op):
        self.ops.append(op[0])

    def mark_failed(self, reason):
        self.failed = reason

    def verify_mirror_digest(self, key, digest):
        pass


def _tiny_index(pkg=PORT):
    schema = pkg.schema([("name", "Levenshtein", 0.3, 0.9)])
    return pkg.index(schema), schema


def _rec(rid, name, pkg=PORT):
    return pkg.record(rid, name=name)


@pytest.mark.parametrize("site", ["commit", "score"])
def test_frontend_failure_after_broadcast_latches(monkeypatch, site):
    """A frontend that fails to apply an op it already broadcast leaves
    the followers ahead: the dispatcher latches."""
    idx, schema = _tiny_index()
    idx._dispatch_key = KEY
    stub = _StubDispatcher()
    monkeypatch.setattr(TD, "_DISPATCHER", stub)
    boom = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom"))  # noqa: E731
    if site == "commit":
        idx.index(_rec("a", "acme"))
        monkeypatch.setattr(idx, "_append_records", boom)
        with pytest.raises(RuntimeError, match="boom"):
            idx.commit()
        assert stub.ops == ["commit"]
        assert "commit failed" in stub.failed
    else:
        proc = DeviceProcessor(schema, idx)
        monkeypatch.setattr(proc, "_score_blocks", boom)
        with pytest.raises(RuntimeError, match="boom"):
            proc.deduplicate([_rec("a", "acme"), _rec("b", "acme")])
        assert stub.ops == ["commit", "score"]
        assert "scoring pass aborted" in stub.failed


class _LoopbackFollower:
    """Replays commit ops into a real port replica index and answers the
    digest handshake -- optionally corrupting the replay."""

    def __init__(self, sock, drop_record_at=None, fail_at=None):
        self.sock = sock
        self.index, _ = _tiny_index()
        self.drop_record_at = drop_record_at
        self.fail_at = fail_at
        self.commits = 0
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        last_seq = 0
        while True:
            try:
                op, _epoch, seq = TD._recv_op(self.sock)
            except (EOFError, OSError):
                return
            if seq <= last_seq or op[0] != "commit":
                last_seq = max(seq, last_seq)
                continue
            last_seq = seq
            records = op[2]
            self.commits += 1
            if self.fail_at == self.commits:
                self.sock.sendall(TD._digest_frame(False, b""))
                continue
            if self.drop_record_at == self.commits:
                records = records[1:]  # the corruption: one record lost
            for r in records:
                self.index.index(r)
            self.index.commit()
            self.sock.sendall(TD._digest_frame(True,
                                               self.index._mirror_digest))


def _wired(monkeypatch, **follower_kw):
    a, b = socket.socketpair()
    d = TD.Dispatcher(app=None)
    d._conns = [a]
    follower = _LoopbackFollower(b, **follower_kw)
    idx, _ = _tiny_index()
    idx._dispatch_key = KEY
    monkeypatch.setattr(TD, "_DISPATCHER", d)
    return d, follower, idx, (a, b)


BATCHES = (["a", "b"], ["c"], ["a"])  # a re-index included


def test_matching_mirrors_pass_and_chain_like_jax(monkeypatch):
    d, follower, idx, socks = _wired(monkeypatch)
    jidx, _ = _tiny_index(JAX)
    try:
        for batch in BATCHES:
            for rid in batch:
                idx.index(_rec(rid, f"name-{rid}"))
                jidx.index(_rec(rid, f"name-{rid}", JAX))
            idx.commit()
            jidx.commit()
            # the chain is the JAX package's formula, bit for bit
            assert idx._mirror_digest == jidx._mirror_digest
        assert d._failed is None and len(d.live_followers()) == 1
        assert idx._mirror_digest == follower.index._mirror_digest
        assert idx._mirror_digest != EMPTY_CONTENT_HASH
    finally:
        for s in socks:
            s.close()


@pytest.mark.parametrize("fault", ["corrupt_mirror", "replay_failed",
                                   "dead_follower"])
def test_follower_faults_evict_and_never_latch(monkeypatch, fault):
    monkeypatch.setattr(TD, "_CONNECT_TIMEOUT_S", 5.0)
    kw = {"corrupt_mirror": {"drop_record_at": 2},
          "replay_failed": {"fail_at": 1}}.get(fault, {})
    d, follower, idx, socks = _wired(monkeypatch, **kw)
    evictions0 = TT.FOLLOWER_EVICTIONS.single().value
    try:
        if fault == "dead_follower":
            socks[1].close()
        idx.index(_rec("a", "acme"))
        idx.commit()
        if fault == "corrupt_mirror":
            assert d.live_followers()  # commit 1: the mirrors agree
            idx.index(_rec("b", "globex"))
            idx.index(_rec("c", "initech"))
            idx.commit()  # commit 2: the follower lost "b"
        assert d._failed is None, "a follower fault must not latch"
        assert d.live_followers() == []
        assert TT.FOLLOWER_EVICTIONS.single().value == evictions0 + 1
        assert TT.DISPATCH_DOWN.single().value == 0
        # the dispatcher keeps serving with no follower left
        d.broadcast(("score", KEY, []))
        idx.index(_rec("d", "umbrella"))
        idx.commit()
    finally:
        for s in socks:
            s.close()


def test_verify_disabled_skips_the_handshake(monkeypatch):
    monkeypatch.setenv("DUKE_DISPATCH_VERIFY", "0")
    a, b = socket.socketpair()
    d = TD.Dispatcher(app=None)
    d._conns = [a]
    monkeypatch.setattr(TD, "_DISPATCHER", d)
    try:
        idx, _ = _tiny_index()
        idx._dispatch_key = KEY
        idx.index(_rec("a", "acme"))
        idx.commit()  # no follower answer needed: must not block
        assert d._failed is None
        assert TD._env_fingerprint()["verify"] is False
    finally:
        a.close()
        b.close()


# -- the bootstrap stream -------------------------------------------------------------


@pytest.fixture
def mesh4():
    mesh = TSM.set_serving_devices([CPU] * 4)
    yield mesh
    TSM.set_serving_devices(None)


def _sharded_workload(n=60):
    sc = parse_config(DEDUP_XML, env={"MIN_RELEVANCE": "0.05"})
    wl = build_workload(sc.deduplications["people"], sc, backend="sharded",
                        device="cpu", persistent=False)
    if n:
        with wl.lock:
            wl.process_batch("crm", _seeded_batch(n))
    return sc, wl


def _frames(wl, monkeypatch, snap_chunk, rec_batch):
    monkeypatch.setattr(TD, "_SNAP_CHUNK", snap_chunk)
    monkeypatch.setattr(TD, "_REC_BATCH", rec_batch)
    d = TD.Dispatcher(app=None)
    frames = []
    d.broadcast = frames.append
    d._stream_state(PEOPLE, wl.index)
    return frames


def _session(sc, frames, sent=None):
    sess = TD._FollowerSession((sent if sent is not None else []).append,
                               device="cpu")
    sess.handle(("bootstrap_begin", "sharded", sc.config_string,
                 TD._env_fingerprint()))
    for op in frames:
        sess.handle(op)
    sess.handle(("bootstrap_end",))
    return sess


def test_stream_is_chunk_bounded_and_carries_the_digest(mesh4, monkeypatch):
    _, wl = _sharded_workload()
    try:
        frames = _frames(wl, monkeypatch, 1024, 16)
        kinds = [op[0] for op in frames]
        assert kinds[0] == "state_begin" and kinds[-1] == "state_end"
        assert frames[0][2]["mirror_digest"] == wl.index._mirror_digest
        assert frames[0][2]["has_snapshot"] is True
        assert kinds.count("snap") >= 2, "the snapshot was not chunked"
        for op in frames:
            if op[0] == "snap":
                assert len(op[2]) <= 1024
            elif op[0] == "recs":
                assert len(op[2]) <= 16
            assert len(pickle.dumps(op)) <= 8192 + 65536
    finally:
        wl.close()


def test_follower_assembles_an_equivalent_replica(mesh4, monkeypatch):
    sc, wl = _sharded_workload()
    sent = []
    try:
        frames = _frames(wl, monkeypatch, 8192, 16)
        sess = _session(sc, frames, sent)
        try:
            replica = sess.replicas[PEOPLE]
            assert replica.index.corpus.size == wl.index.corpus.size
            assert replica.index.id_to_row == wl.index.id_to_row
            assert replica.index._mirror_digest == wl.index._mirror_digest
            assert set(replica.index.records) == set(wl.index.records)
            some = next(iter(wl.index.records))
            assert (replica.index.records[some].get_values("NAME")
                    == wl.index.records[some].get_values("NAME"))
            # a post-bootstrap commit on both sides keeps the chain equal,
            # and the handshake frame says so
            batch = wl.datasources["crm"].records_for_batch(
                _seeded_batch(8, prefix="post"))
            sess.handle(("commit", PEOPLE, batch))
            for r in batch:
                wl.index.index(r)
            wl.index.commit()
            assert sent[-1] == TD._digest_frame(True, wl.index._mirror_digest)
            # a reload streams the state again: the replicas swap whole
            sess.handle(("reload_begin", "sharded", sc.config_string))
            for op in _frames(wl, monkeypatch, 8192, 16):
                sess.handle(op)
            sess.handle(("bootstrap_end",))
            assert sess.replicas[PEOPLE] is not replica
            assert (sess.replicas[PEOPLE].index.corpus.size
                    == wl.index.corpus.size)
        finally:
            sess.close()
    finally:
        wl.close()


def test_empty_corpus_streams_no_payload(mesh4, monkeypatch):
    sc, wl = _sharded_workload(0)
    try:
        frames = _frames(wl, monkeypatch, 8192, 16)
        assert [op[0] for op in frames] == ["state_begin", "state_end"]
        sess = _session(sc, frames)
        try:
            assert sess.replicas[PEOPLE].index.corpus.size == 0
        finally:
            sess.close()
    finally:
        wl.close()
