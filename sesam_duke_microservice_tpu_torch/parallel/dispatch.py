"""The multi-process serving group: single-controller dispatch of mesh
operations.

Counterpart of the JAX package's ``parallel/dispatch.py``, on a
``torch.distributed`` job (``parallel.multihost``):

  * **Frontend** (process 0): serves the full REST surface and owns every
    host-side subsystem -- ingest, link databases, listeners, durable
    stores, feeds.  Each mesh operation (a corpus commit, a scoring pass,
    a ring rematch) is broadcast to the followers *before* the frontend
    executes it.
  * **Followers** (processes 1..N-1): no HTTP, no link writes -- each
    holds a replica of every workload's sharded index (the corpus host
    mirror and this process's shards of it) and replays the frontend's
    op stream in order, entering the same device programs in lockstep so
    the merge's ``all_gather`` / ``all_reduce`` (and the ring's hops)
    meet across processes.  A follower also keeps a replica of each link
    database, fed by the published link stream, and may serve it read
    only (``service/replica_plane.py``) and take over as leader when the
    leader dies (``promote_follower``).

Correctness rests on two invariants:

  1. **Bit-identical host mirrors.**  Every process places its shards of
     the global corpus from its own host mirror, so the mirrors must
     match exactly.  Followers bootstrap from the frontend's corpus state
     (the snapshot format of ``DeviceIndex.snapshot_save`` plus the
     record mirror) and then apply the same deterministic mutations in
     the same order (op ``commit``); the chained mirror digest is
     compared after every commit.
  2. **Identical device-program order.**  Collectives deadlock if two
     processes enter them in different orders.  The frontend holds
     ``Dispatcher.op_lock`` across every broadcast+execute section
     (serializing across workloads and threads), and followers replay the
     one op stream sequentially.  Escalation re-runs are decided on
     merged (replicated) counts, so every process widens at the same
     point -- including the lookahead dispatch order of
     ``DeviceProcessor``, whose loop the follower shares
     (``_score_blocks``).

The op channel is a plain length-prefixed-pickle TCP stream from the
frontend to each follower, opened only after a fixed-format raw-bytes join
handshake (no pickle ever touches unauthenticated bytes); the frontend's
address is published through the job's ``TCPStore`` (rendezvous only --
the data path never rides the store).  The hello (``SDMT1``) and digest
(``SDMD2``) frames and the op frame header are the JAX package's, byte
for byte.  A follower whose stream tears or whose mirror diverges is
evicted, and the group degrades to the survivors; on a mesh that spans
the evicted process the dispatcher latches instead (the next collective
could never meet), and a collective that times out
(``multihost.COLLECTIVE_TIMEOUT_S``) fails its request loudly.
"""

from __future__ import annotations

import contextlib
import logging
import os
import pickle
import socket
import struct
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import telemetry
from ..env import env_flag, env_float, env_int, env_str
from ..utils import faults, lockcheck

logger = logging.getLogger("dispatch")

# rendezvous key in the job's TCPStore
_KV_ADDR_KEY = "sesam_duke/dispatch/addr"
_CONNECT_TIMEOUT_S = env_float("DUKE_DISPATCH_TIMEOUT", 600.0)

# Per-follower send discipline: every send is bounded by a timeout (a dead
# follower mid-bootstrap must not park the leader on a full send buffer),
# and transient failures retry with exponential backoff + jitter before
# the follower is EVICTED -- the group degrades to the survivors instead
# of latching down.
_SEND_TIMEOUT_S = env_float("DUKE_DISPATCH_SEND_TIMEOUT", 120.0)
_SEND_RETRIES = env_int("DUKE_DISPATCH_SEND_RETRIES", 4)
_RETRY_BASE_S = env_float("DUKE_DISPATCH_RETRY_BASE_MS", 50.0) / 1000.0


def _backoff_delay(attempt: int) -> float:
    from ..utils.backoff import full_jitter_delay

    return full_jitter_delay(attempt, _RETRY_BASE_S, 2.0)


# Cached registry children: op tags are a small closed set, so each child
# resolves through the family lock at most once per process.
_OP_CHILDREN: Dict[str, object] = {}
_REPLAY_CHILDREN: Dict[str, object] = {}
_BYTES_CHILD = telemetry.DISPATCH_BYTES.single()


def _op_child(tag: str):
    child = _OP_CHILDREN.get(tag)
    if child is None:
        child = telemetry.DISPATCH_OPS.labels(op=tag)
        _OP_CHILDREN[tag] = child
    return child


def _replay_child(tag: str):
    child = _REPLAY_CHILDREN.get(tag)
    if child is None:
        child = telemetry.FOLLOWER_REPLAY_SECONDS.labels(op=tag)
        _REPLAY_CHILDREN[tag] = child
    return child


_DISPATCHER: Optional["Dispatcher"] = None


def current() -> Optional["Dispatcher"]:
    """The active frontend dispatcher, or None (single-process serving and
    follower processes both see None -- the broadcast hooks no-op)."""
    return _DISPATCHER


@contextlib.contextmanager
def latch_on_failure(d: Optional["Dispatcher"], reason_prefix: str):
    """THE post-broadcast execution guard: once an op has been broadcast,
    a frontend that fails to execute it locally leaves followers ahead on
    the op stream (a mirror divergence, or collectives only they enter),
    so any exception latches the dispatcher before propagating, and every
    further mesh op refuses loudly instead of hanging a desynced
    collective.  ``d=None`` (single process) passes exceptions through.
    One helper for every broadcast site (commit, score, rematch)."""
    if d is None:
        yield
        return
    try:
        yield
    except BaseException as e:
        d.mark_failed(f"{reason_prefix}: {e!r}")
        raise


# -- wire format -------------------------------------------------------------

# Join handshake: a FIXED-FORMAT raw-bytes frame -- magic + sha256
# hexdigest of the join token + 8-byte big-endian follower index -- sent by
# the follower before anything else.  The frontend authenticates it with
# hmac.compare_digest BEFORE any pickle touches bytes from the socket
# (unpickling attacker bytes is arbitrary code execution).  The index is
# the follower's stable identity (its rank - 1), not the accept order.
_HELLO_MAGIC = b"SDMT1"
_HELLO_TOKEN_LEN = len(_HELLO_MAGIC) + 64
_HELLO_LEN = _HELLO_TOKEN_LEN + 8

# Commit digest handshake: after replaying each ("commit", ...) op the
# follower answers with ONE raw frame -- magic + ok byte + its 32-byte
# chained mirror digest, then a 4-byte length-prefixed tracing blob (the
# replay's remote spans as JSON; empty when no trace context rode the
# op).  The magic is checked BEFORE the length prefix is read, so a
# mixed-version group halts with a protocol error instead of blocking.
_DIGEST_MAGIC = b"SDMD2"
_DIGEST_LEN = len(_DIGEST_MAGIC) + 1 + 32
# a corrupt length prefix must not allocate unbounded memory
_SPAN_BLOB_MAX = 4 << 20

# Streamed bootstrap granularity: snapshot bytes per message / records per
# message -- both sides' transient memory stays O(chunk) at any scale.
_SNAP_CHUNK = env_int("DUKE_DISPATCH_SNAP_CHUNK", 16 << 20)
_REC_BATCH = env_int("DUKE_DISPATCH_REC_BATCH", 2048)


def _digest_frame(ok: bool, digest: bytes, spans: bytes = b"") -> bytes:
    payload = digest if len(digest) == 32 else bytes(32)
    if len(spans) > _SPAN_BLOB_MAX:
        spans = b""  # never let an oversized trace wedge the handshake
    return (_DIGEST_MAGIC + (b"\x01" if ok else b"\x00") + payload
            + struct.pack(">I", len(spans)) + spans)


def _verify_enabled() -> bool:
    return env_flag("DUKE_DISPATCH_VERIFY", True)


def _hello_frame(token: str, idx: int = 0) -> bytes:
    import hashlib

    return (_HELLO_MAGIC
            + hashlib.sha256(token.encode()).hexdigest().encode()
            + struct.pack(">Q", idx))


def with_trace_ctx(op: tuple) -> tuple:
    """Append the active trace context to a mesh op: followers replay it
    as remote child spans of the leader's request trace.  No active trace
    appends nothing."""
    tc = telemetry.tracing.propagation_context()
    return op if tc is None else op + (tc,)


def _op_trace_ctx(op: tuple, index: int) -> Optional[dict]:
    """The optional trailing trace context of a replayed op."""
    if len(op) > index and isinstance(op[index], dict):
        return op[index]
    return None


def _join_token() -> Optional[str]:
    """Operator-provided pre-shared secret, if any.  Set on BOTH sides it
    replaces the per-run random token (the only way the
    DUKE_DISPATCH_ADDR rendezvous bypass can authenticate)."""
    return env_str("DUKE_DISPATCH_TOKEN") or None


# Op frame header: payload length, leadership epoch, per-follower frame
# sequence number.  The epoch fences zombie ex-leaders; the sequence number
# makes the stream idempotent under duplicate delivery (seq <= last drops)
# and LOUD under loss (a gap raises).
_HDR = struct.Struct(">QIQ")


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise EOFError("dispatch channel closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_op(sock: socket.socket):
    """One framed op off the dispatch stream: (op, epoch, frame_seq)."""
    n, epoch, seq = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return pickle.loads(_recv_exact(sock, n)), epoch, seq


def _store():
    """The job's TCPStore (the rendezvous KV store)."""
    from . import multihost

    j = multihost.job()
    if j is None:
        raise RuntimeError(
            "no multi-process job is joined (the serving group needs the "
            "job's store, or set DUKE_DISPATCH_ADDR)")
    return j.store


def _env_fingerprint() -> dict:
    """Shape-relevant configuration that must match across processes (a
    mismatch would run different programs and deadlock a collective)."""
    import torch

    from ..engine import device_matcher as DM
    from . import multihost

    j = multihost.job()
    return {
        "torch": torch.__version__,
        "shards": (j.local_shards * j.world) if j is not None else 1,
        "chunk": DM._CHUNK,
        "buckets": DM._QUERY_BUCKETS,
        "update_slice": DM._UPDATE_SLICE,
        "value_slots_max": DM._VALUE_SLOTS_MAX,
        "initial_top_k": DM._INITIAL_TOP_K,
        "ann_dim": env_str("DEVICE_ANN_DIM", "256"),
        "ann_c": env_str("DEVICE_ANN_CANDIDATES", "64"),
        # retrieval knobs: a one-sided setting takes another route (fused
        # kernel or scan, other bins) and changes the merged candidates
        "ann_fused": env_str("DEVICE_ANN_FUSED", "1"),
        "ann_seg": env_str("DEVICE_ANN_SEG", "64"),
        "ann_exact": env_str("DEVICE_ANN_EXACT_TOPK", "0"),
        "ann_recall": env_str("DEVICE_ANN_RECALL_TARGET", "0.99"),
        "ann_chunk": env_str("DEVICE_ANN_RETRIEVAL_CHUNK", "65536"),
        "initial_capacity": env_str("DEVICE_INITIAL_CAPACITY", ""),
        # every knob that sizes a feature tensor
        "max_chars": env_str("DEVICE_MAX_CHARS", ""),
        "max_chars_cap": env_str("DEVICE_MAX_CHARS_CAP", ""),
        "demote_chars": env_str("DEVICE_DEMOTE_CHARS", ""),
        "max_grams": env_str("DEVICE_MAX_GRAMS", ""),
        "max_tokens": env_str("DEVICE_MAX_TOKENS", ""),
        "value_slots": env_str("DEVICE_VALUE_SLOTS", ""),
        # not shape-relevant, but a one-sided setting deadlocks the
        # digest handshake (unread frames fill the follower's buffer)
        "verify": _verify_enabled(),
    }


# -- frontend ----------------------------------------------------------------


class _Follower:
    """Per-follower health and stream state: ``alive`` flips false on
    eviction; ``seq`` is the per-follower frame sequence number."""

    __slots__ = ("idx", "conn", "peer", "alive", "seq")

    def __init__(self, idx: int, conn: socket.socket, peer="?"):
        self.idx = idx
        self.conn = conn
        self.peer = peer
        self.alive = True
        self.seq = 0


class Dispatcher:
    """Frontend-side op broadcaster (process 0 of a serving group)."""

    def __init__(self, app, epoch: int = 1):
        self.app = app
        # leadership epoch, stamped into every frame header: followers
        # reject ops from a lower epoch
        self.epoch = epoch
        # serializes every broadcast+execute section across workloads so
        # all processes enter device programs in one global order
        self.op_lock = threading.RLock()
        self._send_lock = threading.Lock()
        # single writer: the accept loop (startup) appends; broadcasts
        # iterate under self._send_lock and eviction only flips flags
        self._followers: List[_Follower] = []
        self._op_index = 0  # broadcast ordinal (fault-plan coordinates)
        self._server: Optional[socket.socket] = None
        self._closed = False
        # latched only on a FRONTEND-side desync (latch_on_failure) or an
        # eviction from a mesh that spans the evicted process; a follower
        # fault alone evicts it.  Recovery from the latch = restart.
        self._failed: Optional[str] = None

    @property
    def _conns(self) -> List[socket.socket]:
        """Live follower connections."""
        return [f.conn for f in self._followers if f.alive]

    @_conns.setter
    def _conns(self, conns: List[socket.socket]) -> None:
        self._followers = [_Follower(i, c) for i, c in enumerate(conns)]

    def live_followers(self) -> List[_Follower]:
        return [f for f in self._followers if f.alive]

    # - lifecycle -

    def start(self) -> None:
        import secrets

        from . import multihost

        n_followers = multihost.process_count() - 1
        if n_followers <= 0:
            raise RuntimeError("Dispatcher.start() needs a multi-process job")
        bind_host = env_str("DUKE_DISPATCH_BIND", "0.0.0.0")
        advertise = env_str("DUKE_DISPATCH_HOST")
        port = env_int("DUKE_DISPATCH_PORT", 0)
        self._server = socket.create_server((bind_host, port))
        actual_port = self._server.getsockname()[1]
        if advertise is None:
            advertise = socket.gethostname()
        # join token: the pre-shared DUKE_DISPATCH_TOKEN when set, else
        # per-run random, published only through the job's store -- a
        # follower slot needs the secret or store access
        psk = _join_token()
        token = psk or secrets.token_hex(16)
        addr = f"{advertise}:{actual_port}"
        # a long-lived pre-shared secret never goes into the store: the
        # address alone, and followers bring the secret from their env
        _store().set(_KV_ADDR_KEY, addr if psk else f"{addr}/{token}")
        logger.info("dispatch: waiting for %d follower(s) on %s",
                    n_followers, addr)
        self._accept_followers(n_followers, token)
        self._tag_workloads(self.app.deduplications, self.app.record_linkages)
        self._bootstrap_followers()
        telemetry.DISPATCH_EPOCH.set(self.epoch)
        global _DISPATCHER
        _DISPATCHER = self

    def _accept_followers(self, n_followers: int, token: str) -> None:
        """Accept exactly ``n_followers`` authenticated connections: a
        FIXED-LENGTH raw frame compared in constant time -- pickle.loads
        never sees bytes from a socket that has not presented the join
        token."""
        import hmac

        expected_token = _hello_frame(token)[:_HELLO_TOKEN_LEN]
        self._server.settimeout(_CONNECT_TIMEOUT_S)
        while len(self._followers) < n_followers:
            conn, peer = self._server.accept()
            try:
                conn.settimeout(30.0)
                hello = _recv_exact(conn, _HELLO_LEN)
                if not hmac.compare_digest(hello[:_HELLO_TOKEN_LEN],
                                           expected_token):
                    raise ValueError("bad join token")
                conn.settimeout(None)
            except Exception as e:
                logger.warning("dispatch: rejected connection from %s (%s)",
                               peer, e)
                conn.close()
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            (idx,) = struct.unpack(">Q", hello[_HELLO_TOKEN_LEN:])
            if any(f.idx == idx for f in self._followers):
                logger.warning(
                    "dispatch: duplicate follower index %d from %s "
                    "(misconfigured JAX_PROCESS_ID?)", idx, peer)
            self._followers.append(_Follower(idx, conn, peer))
            telemetry.DISPATCH_FOLLOWERS.set(len(self._followers))
            logger.info("dispatch: follower connected from %s", peer)

    def _bootstrap_followers(self) -> None:
        self.broadcast(("bootstrap_begin", self.app.backend,
                        self.app.config_string, _env_fingerprint()))
        self._stream_states(self.app.deduplications, self.app.record_linkages)
        self.broadcast(("bootstrap_end",))

    def close(self) -> None:
        global _DISPATCHER
        if self._closed:
            return
        self._closed = True
        try:
            self.broadcast(("shutdown",))
        except Exception:
            pass
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass
        telemetry.DISPATCH_FOLLOWERS.set(0)
        if self._server is not None:
            self._server.close()
        if _DISPATCHER is self:
            _DISPATCHER = None

    # - ops -

    def broadcast(self, op: tuple) -> None:
        """Send one op to every LIVE follower (in one global order).

        A send failure does not latch the dispatcher: transient failures
        retry with exponential backoff + jitter; a follower that stays
        unreachable is EVICTED (``duke_follower_evictions_total``).  Only
        a frontend-side desync (``mark_failed``) halts every mesh op."""
        if self._failed is not None:
            raise RuntimeError(
                "multi-host dispatch is down (frontend desynced from its "
                f"own op stream: {self._failed}); restart the job to "
                "recover")
        data = pickle.dumps(op, protocol=pickle.HIGHEST_PROTOCOL)
        tag = str(op[0])
        self._op_index += 1
        plan = faults.active()
        if plan is not None:
            plan.check_leader_crash(self._op_index)
        live = self.live_followers()
        _op_child(tag).inc()
        _BYTES_CHILD.inc((_HDR.size + len(data)) * len(live))
        # lockcheck visibility: which locks are held across this blocking
        # network broadcast (the mesh op lock is expected)
        lockcheck.note_blocking("dispatch.broadcast")
        with self._send_lock:
            for f in live:
                self._send_frame(f, tag, data, plan)

    @staticmethod
    def _send_tracked(conn: socket.socket, frame: bytes) -> None:
        """``sendall`` with a byte cursor: an ``OSError`` is re-raised
        carrying how much of the frame hit the wire (``e.frame_sent``),
        so the caller can tell a retry-safe failure (0 bytes) from a torn
        frame."""
        sent = 0
        try:
            while sent < len(frame):
                sent += conn.send(frame[sent:])
        except OSError as e:
            e.frame_sent = sent
            raise

    def _send_frame(self, f: _Follower, tag: str, data: bytes,
                    plan) -> bool:
        """One framed send to one follower, with bounded retry +
        exponential backoff + jitter before eviction.  Only failures with
        ZERO bytes of the frame on the wire are retried (the stream is
        still frame-aligned); after a partial write the only recovery is
        eviction.  A fault-injected dup re-sends the SAME seq, which the
        follower drops."""
        err: Optional[BaseException] = None
        attempts = 0
        while True:
            header = _HDR.pack(len(data), self.epoch, f.seq + 1)
            try:
                if plan is not None:
                    plan.before_send(tag, f.idx, self._op_index, attempts)
                f.conn.settimeout(_SEND_TIMEOUT_S)
                try:
                    self._send_tracked(f.conn, header + data)
                    f.seq += 1
                    if plan is not None and plan.dup_send(
                            tag, f.idx, self._op_index):
                        # the dup rides the SAME seq and never re-enters
                        # the retry loop
                        try:
                            self._send_tracked(f.conn, header + data)
                        except OSError as e:
                            if getattr(e, "frame_sent", 0):
                                self._evict(f, f"dup send tore: {e!r}")
                                return False
                finally:
                    try:
                        f.conn.settimeout(None)
                    except OSError:
                        pass
                return True
            except faults.InjectedSendFailure as e:
                err = e
            except OSError as e:
                if getattr(e, "frame_sent", 0) or isinstance(
                        e, socket.timeout):
                    # a torn frame (or a peer stalled past the timeout):
                    # the stream cannot recover
                    self._evict(f, f"send failed: {e!r}")
                    return False
                err = e  # zero bytes sent: frame-aligned, retry safe
            attempts += 1
            if attempts > _SEND_RETRIES:
                self._evict(f, f"{attempts} send attempts failed: {err!r}")
                return False
            time.sleep(_backoff_delay(attempts))

    def _evict(self, f: _Follower, reason: str) -> None:
        """Remove one follower from the serving group (idempotent): its
        stream is torn or it stopped answering, so it can never catch up
        -- but the survivors keep serving, so only the eviction counter
        moves."""
        if not f.alive:
            return
        f.alive = False
        try:
            f.conn.close()
        except OSError:
            pass
        telemetry.FOLLOWER_EVICTIONS.inc()
        survivors = len(self.live_followers())
        telemetry.DISPATCH_FOLLOWERS.set(survivors)
        logger.error(
            "dispatch: evicted follower %d at %s (%s); serving degrades "
            "to %d survivor(s)%s", f.idx, f.peer, reason, survivors,
            "" if survivors else
            " -- single-process serving until the job re-forms")
        backend = getattr(self.app, "backend", None)
        if backend in ("sharded", "sharded-brute"):
            # the op stream and the replica read tier stay up, but THIS
            # mesh's collectives span the evicted process: the next one
            # could never meet.  Latch mesh ops loudly instead (restart
            # the job to re-form the mesh).
            self.mark_failed(
                f"follower {f.idx} evicted from a {backend} mesh "
                f"({reason}); cross-process collectives cannot run "
                "without it")

    def verify_mirror_digest(self, key, digest: bytes) -> None:
        """Read one digest frame per live follower for the commit just
        applied and compare it with the frontend's own chained mirror
        digest.  A mismatch, a replay failure or a dead / slow follower
        EVICTS that follower; the frontend's state is authoritative and
        the commit stands.  Called with ``op_lock`` held (the commit runs
        inside the broadcast+execute section), so frames never interleave
        across commits."""
        if not _verify_enabled():
            return
        for f in self.live_followers():
            conn = f.conn
            try:
                conn.settimeout(_CONNECT_TIMEOUT_S)
                frame = _recv_exact(conn, _DIGEST_LEN)
                if frame[: len(_DIGEST_MAGIC)] != _DIGEST_MAGIC:
                    raise EOFError(
                        f"bad digest-frame magic "
                        f"{frame[: len(_DIGEST_MAGIC)]!r} (mixed-version "
                        f"group? expected {_DIGEST_MAGIC!r})")
                (blob_len,) = struct.unpack(">I", _recv_exact(conn, 4))
                if blob_len > _SPAN_BLOB_MAX:
                    raise EOFError(
                        f"span blob length {blob_len} exceeds the "
                        f"{_SPAN_BLOB_MAX}-byte cap (corrupt frame?)")
                blob = _recv_exact(conn, blob_len) if blob_len else b""
            except (OSError, EOFError) as e:
                self._evict(f, f"no commit digest for {key}: {e!r}")
                continue
            finally:
                try:
                    conn.settimeout(None)
                except OSError:
                    pass
            # the follower's replay spans ride the handshake home: splice
            # them into the request's live trace
            telemetry.tracing.graft_remote(blob)
            ok = frame[len(_DIGEST_MAGIC)] == 1
            theirs = frame[len(_DIGEST_MAGIC) + 1:]
            if not ok or theirs != digest:
                self._evict(
                    f, f"mirror diverged on commit for {key}: "
                    + ("replay failed" if not ok else
                       f"digest {theirs.hex()} != {digest.hex()}"))

    def mark_failed(self, reason: str) -> None:
        """Latch the dispatcher down after an op-stream desync: every
        further mesh op raises instead of hanging on a desynced
        collective."""
        if self._failed is None:
            self._failed = reason
            telemetry.DISPATCH_DOWN.set(1)
            # the connected-follower gauge drops with the latch: the mesh
            # cannot serve another op
            telemetry.DISPATCH_FOLLOWERS.set(0)
            logger.error("dispatch: halting mesh ops (%s) -- restart the "
                         "job", reason)

    def on_reload(self, sc, new_dedups: Dict, new_linkages: Dict) -> None:
        """Called by ``DukeApp.apply_config`` after building the
        replacement workloads (old locks held, nothing in flight): re-tags
        the new indexes and streams followers the new config and corpus
        states."""
        self._tag_workloads(new_dedups, new_linkages)
        self.broadcast(("reload_begin", self.app.backend, sc.config_string))
        self._stream_states(new_dedups, new_linkages)
        self.broadcast(("bootstrap_end",))

    # - helpers -

    def _tag_workloads(self, dedups: Dict, linkages: Dict) -> None:
        for kind, registry in (("deduplication", dedups),
                               ("recordlinkage", linkages)):
            for name, wl in registry.items():
                wl.index._dispatch_key = (kind, name)
                self._install_link_publisher((kind, name), wl)

    def _install_link_publisher(self, key, wl) -> None:
        """Wrap the workload's link database so every committed link
        batch (scoring matches, one-to-one retractions and rewrites,
        delete retractions -- in arrival order) broadcasts as a ``links``
        op; followers fold them into replica link DBs."""
        from ..links.replica import PublishingLinkDatabase

        if isinstance(wl.link_database, PublishingLinkDatabase):
            return

        def publish(seq: int, rows) -> None:
            self.broadcast(("links", key, seq, rows))

        wl.replace_link_database(
            PublishingLinkDatabase(wl.link_database, publish))

    def _stream_states(self, dedups: Dict, linkages: Dict) -> None:
        for kind, registry in (("deduplication", dedups),
                               ("recordlinkage", linkages)):
            for name, wl in registry.items():
                self._stream_state((kind, name), wl.index,
                                   getattr(wl, "link_database", None))

    def _stream_state(self, key, index, link_db=None) -> None:
        """Stream one workload's corpus bootstrap in O(chunk)-bounded
        messages: the snapshot file in ``DUKE_DISPATCH_SNAP_CHUNK``
        chunks, the record mirror and the link state in
        ``DUKE_DISPATCH_REC_BATCH`` batches -- never a whole-corpus
        message."""
        has_snapshot = (getattr(index, "corpus", None) is not None
                        and index.corpus.size > 0)
        self.broadcast(("state_begin", key, {
            "has_snapshot": has_snapshot,
            # followers chain their commit digests from this point
            "mirror_digest": index._mirror_digest,
            # replica link DBs resume the published stream here: the
            # link_state rows below ARE the state at this watermark
            "link_seq": getattr(link_db, "seq", 0),
        }))
        if link_db is not None:
            # every current row, asserted AND retracted (the replica
            # serves the full ?since= history); get_all_links drains any
            # write-behind buffer first
            from ..links.replica import encode_link

            batch: List = []
            for link in link_db.get_all_links():
                batch.append(encode_link(link))
                if len(batch) >= _REC_BATCH:
                    self.broadcast(("link_state", key, batch))
                    batch = []
            if batch:
                self.broadcast(("link_state", key, batch))
        if has_snapshot:
            fd, tmp = tempfile.mkstemp(suffix=".npz")
            os.close(fd)
            try:
                index.snapshot_save(tmp)
                with open(tmp, "rb") as f:
                    while True:
                        chunk = f.read(_SNAP_CHUNK)
                        if not chunk:
                            break
                        self.broadcast(("snap", key, chunk))
            finally:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            batch = []
            values = getattr(index.records, "bulk_values",
                             index.records.values)
            for record in values():
                batch.append(record)
                if len(batch) >= _REC_BATCH:
                    self.broadcast(("recs", key, batch))
                    batch = []
            if batch:
                self.broadcast(("recs", key, batch))
        self.broadcast(("state_end", key))


# -- follower ----------------------------------------------------------------


class FollowerProcessor:
    """Device-program replayer for one workload replica: the scoring side
    of ``DeviceProcessor`` with host finalization off.  It reuses
    ``DeviceProcessor._score_blocks``, so the dispatch order (lookahead
    blocks, escalation re-runs) is the frontend's -- drift there
    deadlocks the collectives (invariant 2)."""

    def __init__(self, schema, index, *, group_filtering: bool):
        from ..engine.device_matcher import DeviceProcessor

        self._proc = DeviceProcessor(schema, index,
                                     group_filtering=group_filtering)
        self._proc.finalize_survivors = False

    def score(self, records) -> None:
        self._proc._score_blocks(records)


class _StateAssembly:
    """Follower-side accumulator for one workload's streamed bootstrap:
    snapshot chunks append to a temp file, record batches land in a local
    SQLite store -- O(chunk) transient memory at any corpus scale."""

    def __init__(self, key, meta: dict):
        import shutil

        self.key = key
        self.meta = meta
        self.dir = tempfile.mkdtemp(prefix="duke-follower-")
        self._rm = shutil.rmtree
        self.snap_path = os.path.join(self.dir, "bootstrap.npz")
        self._snap_f = (open(self.snap_path, "wb")
                        if meta["has_snapshot"] else None)
        if meta["has_snapshot"]:
            from ..store.records import SqliteRecordStore

            self.store = SqliteRecordStore(
                os.path.join(self.dir, "records.db"))
        else:
            self.store = None

    def add_snapshot_chunk(self, data: bytes) -> None:
        self._snap_f.write(data)

    def add_records(self, records) -> None:
        self.store.put_many(records)

    def finish(self) -> None:
        if self._snap_f is not None:
            self._snap_f.close()
            self._snap_f = None

    def discard(self) -> None:
        self.finish()
        if self.store is not None:
            self.store.close()
            self.store = None
        self._rm(self.dir, ignore_errors=True)


class _Replica:
    """One workload's follower-side state: its index and processor.

    The record mirror is a ``LazyRecordMap`` over the assembly's local
    SQLite store, which commit replay keeps current (``apply_commit``
    writes the batch store-first, the Workload's persist-before-index
    order)."""

    def __init__(self, sc, kind: str, name: str, backend: str,
                 asm: _StateAssembly, device):
        registry = (sc.deduplications if kind == "deduplication"
                    else sc.record_linkages)
        wc = registry[name]
        # backend-generic: groups serve the mesh backends, but the
        # replica machinery (link DBs, fencing, failover) runs on the
        # single-device backends too
        if backend == "sharded-brute":
            from ..engine.sharded_matcher import ShardedDeviceIndex as cls
        elif backend == "sharded":
            from ..engine.sharded_matcher import ShardedAnnIndex as cls
        elif backend == "device":
            from ..engine.device_matcher import DeviceIndex as cls
        elif backend == "ann":
            from ..engine.ann_matcher import AnnIndex as cls
        else:
            raise RuntimeError(f"follower replicas need a device-family "
                               f"backend (got {backend!r})")
        self.index = cls(wc.duke, device=device)
        self.processor = FollowerProcessor(
            wc.duke, self.index, group_filtering=wc.is_record_linkage)
        self._asm = asm
        if asm.meta["has_snapshot"]:
            self._adopt(asm)
        # AFTER adoption: snapshot_load replays nothing through commit(),
        # so the digest chain starts exactly at the frontend's point
        self.index._mirror_digest = asm.meta["mirror_digest"]

    def _adopt(self, asm: _StateAssembly) -> None:
        import numpy as np

        from ..store.records import LazyRecordMap

        # a trusted bootstrap from the live frontend: the content check
        # takes the snapshot's own stamp
        with np.load(asm.snap_path) as data:
            content = str(data["__content"])
        if not self.index.snapshot_load(
                asm.snap_path, LazyRecordMap(asm.store),
                content_hash=content):
            raise RuntimeError(
                "follower bootstrap: corpus state rejected (plan/env "
                "mismatch with the frontend?)")
        try:
            os.unlink(asm.snap_path)
        except OSError:
            pass

    def apply_commit(self, records) -> None:
        """Replay one commit op: local store first (the mirror reads
        through it), then index + commit -- the frontend's own order."""
        if self._asm.store is not None:
            self._asm.store.put_many(records)
        for record in records:
            self.index.index(record)
        self.index.commit()

    def close(self) -> None:
        self.index.close()
        self._asm.discard()


class _FollowerSession:
    """The follower's op-stream state machine, socket-free so tests can
    drive it op by op: ``handle(op)`` returns False on shutdown.
    ``send`` is the response channel (digest frames); ``device`` is where
    the replicas' indexes live.

    Framed transports go through ``handle_frame``, which applies the
    stream discipline first: ops from a lower epoch are dropped
    (``stale_rejected``), a frame seq <= the last applied one is a
    duplicate and drops, a seq gap raises."""

    def __init__(self, send, follower_idx: int = 0, device="cuda"):
        from ..core.config import parse_config

        self._parse_config = parse_config
        self._send = send
        self.follower_idx = follower_idx
        self.device = device
        self.replicas: Dict[Tuple[str, str], _Replica] = {}
        # replica link DBs, one per workload: fed by link_state + links
        # ops on the replay thread, read by the replica HTTP plane
        self.link_replicas: Dict[Tuple[str, str], object] = {}
        self._pending: Dict[Tuple[str, str], _StateAssembly] = {}
        self._pending_links: Dict[Tuple[str, str], List] = {}
        self._incoming: Optional[Tuple[str, str]] = None  # (backend, cfg)
        self.epoch = 0
        self.last_seq = 0
        self.stale_rejected = 0  # ops dropped from a fenced-out epoch
        self._op_count = 0  # ops handled (fault-plan coordinates)
        # promotion hand-over: the promoted app owns the replica indexes
        # and link DBs from then on, so close() must not release them
        self.promoted = False

    def adopt_epoch(self, epoch: int) -> None:
        """Raise the fencing epoch (promotion): frames still in flight
        from the deposed leader carry a lower epoch and are rejected."""
        self.epoch = max(self.epoch, epoch)

    def handle_frame(self, op: tuple, epoch: int, seq: int) -> bool:
        """One framed op with the stream discipline applied; returns
        False on shutdown."""
        if epoch < self.epoch:
            self.stale_rejected += 1
            logger.warning(
                "follower: rejected %r op from fenced-out epoch %d "
                "(adopted epoch is %d) -- zombie ex-leader?",
                op[0], epoch, self.epoch)
            return True
        if epoch > self.epoch:
            # a NEW leader's stream: adopt it and restart the seq space
            self.epoch = epoch
            self.last_seq = seq - 1
        if seq <= self.last_seq:
            return True  # duplicate delivery: drop
        if seq != self.last_seq + 1:
            raise RuntimeError(
                f"dispatch stream gap: frame seq {seq} arrived after "
                f"{self.last_seq} (missed {seq - self.last_seq - 1} "
                "frame(s)); this follower must resync")
        self.last_seq = seq
        return self.handle(op)

    def close(self) -> None:
        if not self.promoted:
            for replica in self.replicas.values():
                try:
                    replica.close()
                except Exception:
                    pass
        self.replicas.clear()
        self.link_replicas.clear()
        for asm in self._pending.values():
            asm.discard()
        self._pending.clear()
        self._pending_links.clear()

    def _begin(self, backend: str, config_string: str) -> None:
        # release the old replicas (device memory) before new states
        for replica in self.replicas.values():
            replica.close()
        self.replicas.clear()
        self.link_replicas.clear()
        self._pending_links.clear()
        self._incoming = (backend, config_string)

    def handle(self, op: tuple) -> bool:
        self._op_count += 1
        plan = faults.active()
        if plan is not None and plan.follower_crash(self.follower_idx,
                                                    self._op_count):
            # an injected hard death, mid-stream, with no farewell frame
            raise RuntimeError(
                f"injected follower crash at op {self._op_count} "
                "(DUKE_FAULTS crash_follower)")
        t0 = time.monotonic()
        try:
            return self._handle(op)
        finally:
            _replay_child(str(op[0])).observe(time.monotonic() - t0)

    def _handle(self, op: tuple) -> bool:
        tag = op[0]
        if tag == "bootstrap_begin":
            _, backend, config_string, fingerprint = op
            mine = _env_fingerprint()
            if fingerprint != mine:
                raise RuntimeError(
                    "follower env/shape fingerprint mismatch vs frontend: "
                    f"{fingerprint} != {mine} -- all processes must run "
                    "identical DEVICE_*/schema configuration")
            self._begin(backend, config_string)
        elif tag == "reload_begin":
            _, backend, config_string = op
            self._begin(backend, config_string)
        elif tag == "state_begin":
            _, key, meta = op
            self._pending[key] = _StateAssembly(key, meta)
            self._pending_links[key] = []
        elif tag == "snap":
            _, key, data = op
            self._pending[key].add_snapshot_chunk(data)
        elif tag == "recs":
            _, key, records = op
            self._pending[key].add_records(records)
        elif tag == "link_state":
            _, key, rows = op
            self._pending_links[key].extend(rows)
        elif tag == "state_end":
            _, key = op
            asm = self._pending.pop(key)
            asm.finish()
            backend, config_string = self._incoming
            sc = self._parse_config(config_string)
            kind, name = key
            try:
                self.replicas[key] = _Replica(sc, kind, name, backend, asm,
                                              self.device)
            except BaseException:
                # a rejected bootstrap must not leak its temp dir
                asm.discard()
                raise
            from ..links.replica import ReplicaLinkDatabase

            replica_db = ReplicaLinkDatabase()
            replica_db.load_snapshot(self._pending_links.pop(key, []),
                                     asm.meta.get("link_seq", 0))
            self.link_replicas[key] = replica_db
        elif tag == "links":
            # one committed link batch in the leader's arrival order: a
            # duplicate drops, a gap raises (the frame discipline upstream
            # makes one impossible on a framed transport)
            _, key, seq, rows = op[:4]
            db = self.link_replicas.get(key)
            if db is None:
                raise RuntimeError(
                    f"links op for {key} before its bootstrap link state")
            db.note_head(seq)
            db.apply_ops(seq, rows)
        elif tag == "bootstrap_end":
            logger.info("follower: %d workload replica(s) ready",
                        len(self.replicas))
        elif tag == "commit":
            _, key, records = op[:3]
            cap = telemetry.tracing.capture_remote(
                "follower:commit", _op_trace_ctx(op, 3),
                {"records": len(records), "process": "follower"})
            try:
                with cap:
                    self.replicas[key].apply_commit(records)
            except Exception:
                # deterministic engine errors raise on the frontend too
                # (same code, same inputs), so surviving them keeps the
                # mirrors consistent; an asymmetric failure answers
                # ok=False and the frontend evicts this follower
                logger.exception("follower: commit replay failed")
                if _verify_enabled():
                    self._send(_digest_frame(False, b"", cap.wire()))
            else:
                # gated on the flag the frontend reads (fingerprinted): an
                # unread frame per commit would fill the TCP buffer
                if _verify_enabled():
                    self._send(_digest_frame(
                        True, self.replicas[key].index._mirror_digest,
                        cap.wire()))
        elif tag == "score":
            _, key, records = op[:3]
            try:
                # no response channel: the replay span lands in this
                # process's flight recorder under the leader's trace id
                with telemetry.tracing.capture_remote(
                        "follower:score", _op_trace_ctx(op, 3),
                        {"records": len(records), "process": "follower"},
                        recorder=telemetry.tracing.RECORDER):
                    self.replicas[key].processor.score(records)
            except Exception:
                logger.exception("follower: score replay failed")
        elif tag == "explain":
            _, key, record, group_filtering = op[:4]
            from ..engine.device_matcher import resolve_block

            index = self.replicas[key].index
            try:
                with telemetry.tracing.capture_remote(
                        "follower:explain", _op_trace_ctx(op, 4),
                        {"process": "follower"},
                        recorder=telemetry.tracing.RECORDER):
                    resolve_block(index.scorer_cache.dispatch_block(
                        [record], group_filtering=group_filtering))
            except Exception:
                logger.exception("follower: explain replay failed")
        elif tag == "rematch":
            _, key, block_rows = op[:3]
            from ..engine.rematch import replay_rematch

            replica = self.replicas[key]
            try:
                with telemetry.tracing.capture_remote(
                        "follower:rematch", _op_trace_ctx(op, 3),
                        {"process": "follower"},
                        recorder=telemetry.tracing.RECORDER):
                    replay_rematch(replica.index, replica.processor._proc,
                                   query_block_rows=block_rows)
            except Exception:
                logger.exception("follower: rematch replay failed")
        elif tag == "shutdown":
            logger.info("follower: shutdown op received; exiting")
            return False
        else:
            raise RuntimeError(f"unknown dispatch op {tag!r}")
        return True


def _leader_alive(host: str, port: int, timeout: float = 5.0) -> bool:
    """Split-brain guard: before self-promoting on stream loss, probe
    whether the leader's dispatch server still accepts connections.  A
    follower the leader EVICTED sees the same EOF a leader death
    produces; a leader that answers is alive, and the follower must exit,
    not promote."""
    try:
        probe = socket.create_connection((host, int(port)), timeout=timeout)
        probe.close()
        return True
    except OSError:
        return False


def promote_follower(session: _FollowerSession):
    """Promote this follower's replicas into a serving leader.

    The replica corpus (bootstrap snapshot + replayed commits) and the
    replicated link DB (bootstrap link state + the published stream up
    to the applied watermark) ARE the promoted leader's state.  This
    builds serving workloads around them (processors with host
    finalization, match listeners writing into the replica link DBs) and
    returns a ``DukeApp`` the caller binds an HTTP server to.

    The session's fencing epoch rises BEFORE the hand-over: any frame
    still in flight from the deposed leader carries the old epoch and is
    rejected."""
    from ..engine.workload import adopt_workload
    from ..links.replica import ReplicaLinkDatabase
    from ..service.app import DukeApp

    if not session.replicas:
        raise RuntimeError("nothing to promote: no bootstrapped replicas")
    backend, config_string = session._incoming
    sc = session._parse_config(config_string)
    session.adopt_epoch(session.epoch + 1)
    dedups: Dict[str, object] = {}
    linkages: Dict[str, object] = {}
    for (kind, name), replica in session.replicas.items():
        wc = (sc.deduplications if kind == "deduplication"
              else sc.record_linkages)[name]
        link_db = session.link_replicas.get((kind, name))
        if link_db is None:
            link_db = ReplicaLinkDatabase()
        wl = adopt_workload(
            wc, sc, backend=backend, index=replica.index,
            link_database=link_db,
            # the follower-local bootstrap store keeps backing the lazy
            # record mirror, and the promoted write path persists new
            # batches into it store-first
            record_store=replica._asm.store)
        (dedups if kind == "deduplication" else linkages)[name] = wl
    session.promoted = True  # the app owns the indexes and link DBs now
    telemetry.DISPATCH_EPOCH.set(session.epoch)
    logger.warning(
        "follower %d PROMOTED to leader at epoch %d (%d workload(s), "
        "link watermark(s) %s)", session.follower_idx, session.epoch,
        len(session.replicas),
        {k[1]: getattr(db, "applied_seq", 0)
         for k, db in session.link_replicas.items()})
    return DukeApp(sc, backend=backend, device=session.device,
                   persistent=False, prebuilt=(dedups, linkages))


def follower_main(device="cuda", poll_timeout_s: Optional[float] = None
                  ) -> None:
    """Follower process entry point: connect to the frontend's dispatch
    stream and replay mesh ops until shutdown or EOF.  Call after
    ``multihost.initialize()`` in a process of rank > 0; returns when the
    job ends.  ``device`` is the replicas' device (the mesh backends use
    the serving mesh's).

    Both off unless configured:

      * ``DUKE_REPLICA_HTTP_PORT`` -- serve the replica read plane
        (``?since=`` feeds, /stats, /metrics, /healthz with the
        replication lag) from this follower while it replays;
      * ``DUKE_PROMOTE_PORT`` -- on leader loss (stream EOF after a
        completed bootstrap, without a shutdown op), promote this
        follower's replicas to a serving leader and bind the full HTTP
        frontend on that port instead of exiting.
    """
    import datetime

    from . import multihost

    addr = env_str("DUKE_DISPATCH_ADDR")
    via_addr_env = addr is not None
    if addr is None:
        store = _store()
        store.wait([_KV_ADDR_KEY], datetime.timedelta(
            seconds=poll_timeout_s or _CONNECT_TIMEOUT_S))
        addr = store.get(_KV_ADDR_KEY).decode()
    addr, _, token = addr.partition("/")
    # a pre-shared secret wins over the store-published token; it is the
    # ONLY way the DUKE_DISPATCH_ADDR bypass can authenticate
    token = _join_token() or token
    if not token:
        raise RuntimeError(
            "no join token is available -- set DUKE_DISPATCH_TOKEN on this "
            "follower"
            + (" (required with DUKE_DISPATCH_ADDR)" if via_addr_env else
               " (the frontend published a bare address, meaning it runs "
               "with DUKE_DISPATCH_TOKEN set)"))
    host, _, port = addr.rpartition(":")
    logger.info("follower: connecting to dispatch stream at %s", addr)
    sock = socket.create_connection((host, int(port)),
                                    timeout=_CONNECT_TIMEOUT_S)
    follower_idx = multihost.process_index() - 1
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.sendall(_hello_frame(token, follower_idx))
    sock.settimeout(None)  # ops arrive whenever the frontend has work

    session = _FollowerSession(sock.sendall, follower_idx=follower_idx,
                               device=device)
    plane = None
    replica_port = env_int("DUKE_REPLICA_HTTP_PORT", 0)
    any_op = False
    clean_shutdown = False
    try:
        while True:
            try:
                op, epoch, seq = _recv_op(sock)
            except (EOFError, OSError):
                if not any_op:
                    # EOF before the first op: the frontend dropped us at
                    # the handshake -- almost always a join-token mismatch
                    raise RuntimeError(
                        "dispatch stream closed before any op arrived -- "
                        "the frontend likely rejected this follower's "
                        "join token (is DUKE_DISPATCH_TOKEN set "
                        "identically on both sides?)")
                logger.info("follower: dispatch stream closed")
                break
            any_op = True
            if plane is None and replica_port and session.replicas:
                from ..service.replica_plane import serve_replica_plane

                plane = serve_replica_plane(session, port=replica_port)
            if not session.handle_frame(op, epoch, seq):
                clean_shutdown = True
                break
        if not clean_shutdown and session.replicas:
            promote_port = env_int("DUKE_PROMOTE_PORT", 0)
            if promote_port and _leader_alive(host, int(port)):
                # the stream died but the leader still answers: WE were
                # evicted.  Promoting would split the group's brain.
                raise RuntimeError(
                    "dispatch stream lost but the leader still accepts "
                    "connections -- this follower was evicted; refusing "
                    "to promote (split-brain guard). Restart to rejoin.")
            if promote_port:
                if plane is not None:
                    plane.shutdown()
                    plane = None
                from ..service.app import serve

                app = promote_follower(session)
                server = serve(app, port=promote_port)
                logger.warning("promoted frontend serving on port %d",
                               promote_port)
                server.serve_forever()
    finally:
        if plane is not None:
            plane.shutdown()
        session.close()
        sock.close()


# -- frontend entry ----------------------------------------------------------


def start_dispatcher(app) -> Dispatcher:
    """Create and start the frontend dispatcher of a multi-process job."""
    if app.backend not in ("sharded", "sharded-brute"):
        raise RuntimeError(
            "multi-host serving requires --backend sharded or sharded-brute "
            f"(got {app.backend!r}); single-device backends cannot span "
            "processes")
    d = Dispatcher(app)
    d.start()
    return d
