"""Durable link journal -- the redo log behind crash-consistent ingest
(a copy of the JAX package's ``links/journal.py``, byte for byte on disk).

The write-behind wrapper acknowledges HTTP 200 while the batch's link
upserts are still in volatile memory; without a journal a crash between
the ack and the background flush loses confirmed matches (the reference
never has this window: its H2 link DB commits synchronously,
App.java:566-611).  ``LinkJournal`` closes the window without giving up
the write-behind overlap: the sealed batch is appended here -- durably,
per the configured sync policy -- *before* the ack, turning the
background flusher into a redo-log applier.  On restart, recovery
(``WriteBehindLinkDatabase.recover``) replays any journaled batch the
flusher never applied through the idempotent ``assert_links`` path, so
an acked batch survives a crash at ANY point after the append.

On-disk format (append-only, length-framed, CRC-guarded)::

    frame    := kind(1) seq(u64 LE) length(u32 LE) crc(u32 LE) payload
    kind     := b"B" (sealed batch) | b"A" (applied watermark)
    payload  := JSON array of 6-element link rows (links.replica
                encode_link order: id1, id2, status, kind, confidence,
                timestamp); empty for b"A" frames
    crc      := crc32 over kind+seq+length+payload

``b"B"`` frames carry a strictly monotonic batch sequence; ``b"A"``
frames advance the applied watermark (appended by the flusher AFTER the
durable store committed the batch, never synced -- losing one only means
re-replaying an applied batch, which the idempotent assert absorbs).
The startup scan truncates a torn tail (a crash mid-append) at the first
incomplete or CRC-failing frame: counted in ``LinkJournal.torn_tails``
and logged, never fatal -- everything
before the tear is intact by construction.  Once the watermark catches
the head, the journal compacts back to zero bytes (bounded disk, and a
cleanly-shut-down service restarts with nothing to replay).

Sync policy (``DUKE_JOURNAL_SYNC``): ``fsync`` (data + metadata),
``fdatasync`` (data only -- the default; the file is preallocated-free
but append-mostly, and fdatasync bounds the loss window identically for
our replay purposes), or ``none`` (OS page cache only: a *process* crash
loses nothing, an OS/power crash can lose the tail -- still strictly
better than no journal).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import struct
import threading
import zlib
from typing import List, Optional, Sequence, Tuple

from .. import telemetry
from ..env import env_str
from ..utils import faults

logger = logging.getLogger("links-journal")

_PREFIX = struct.Struct("<cQI")  # kind, seq, payload length
_CRC = struct.Struct("<I")
_HDR_BYTES = _PREFIX.size + _CRC.size
_KIND_BATCH = b"B"
_KIND_APPLIED = b"A"
# corruption guard: no sane batch payload approaches this, so a garbage
# length field is classified as a torn tail instead of a giant allocation
_MAX_FRAME_BYTES = 256 * 1024 * 1024
# compact (truncate to zero) once the watermark has caught the head and
# the file has grown past this -- keeps steady-state disk bounded without
# paying a truncate per batch
_COMPACT_BYTES = 256 * 1024

SYNC_POLICIES = ("fsync", "fdatasync", "none")
DEFAULT_SYNC_POLICY = "fdatasync"


def sync_policy() -> str:
    """The configured ``DUKE_JOURNAL_SYNC`` policy (fail-to-default)."""
    raw = (env_str("DUKE_JOURNAL_SYNC") or DEFAULT_SYNC_POLICY).strip().lower()
    return raw if raw in SYNC_POLICIES else DEFAULT_SYNC_POLICY


# -- recovery visibility (consumed by the HTTP layer's X-Recovering) ---------
#
# Scoped per journal owner (the workload's data folder) rather than one
# process-global counter: with several apps in one process, one app's
# startup replay must mark only ITS OWN responses as recovering.  The
# anonymous scope ("") is process-wide: it matches every query, for
# callers that have no scope to name.

_RECOVERY_LOCK = threading.Lock()
_recovering: dict = {}  # scope -> entry depth; guarded by: _RECOVERY_LOCK [writes]


def recovery_begin(scope: str = "") -> None:
    """Mark startup journal replay active for ``scope``.  Split from the
    context manager so overlapped recovery can enter the
    scope on the CONSTRUCTING thread -- before the factory returns a
    serving wrapper -- and exit it from the background replay thread; a
    response can then never observe the gap between the wrapper existing
    and the replay thread having started."""
    with _RECOVERY_LOCK:
        _recovering[scope] = _recovering.get(scope, 0) + 1


def recovery_end(scope: str = "") -> None:
    with _RECOVERY_LOCK:
        depth = _recovering.get(scope, 0) - 1
        if depth <= 0:
            _recovering.pop(scope, None)
        else:
            _recovering[scope] = depth


@contextlib.contextmanager
def recovery_in_progress(scope: str = ""):
    """Marks startup journal replay as active for ``scope`` (the owning
    workload's data folder; "" = process-wide) until every entered
    context for it exits."""
    recovery_begin(scope)
    try:
        yield
    finally:
        recovery_end(scope)


def recovery_active(scope: Optional[str] = None) -> bool:
    """Whether a journal replay is running -- for ``scope`` (plus the
    anonymous process-wide scope), or anywhere when ``scope`` is None.
    Lock-free read: membership checks on the dict are GIL-atomic and the
    per-response ``X-Recovering`` check must never contend with a
    replay."""
    active = _recovering
    if scope is None:
        return bool(active)
    return scope in active or "" in active


def _frame(kind: bytes, seq: int, payload: bytes) -> bytes:
    prefix = _PREFIX.pack(kind, seq, len(payload))
    return prefix + _CRC.pack(zlib.crc32(prefix + payload)) + payload


# streaming read granularity: one pread per chunk, carry buffer compacts
# back to at most one in-progress frame + a chunk
_READ_CHUNK = 1 << 20


class _TornTail(Exception):
    """Internal: frame walk hit a torn/corrupt tail.  ``good`` is the
    byte offset of the last intact frame boundary."""

    def __init__(self, reason: str, good: int):
        super().__init__(reason)
        self.reason = reason
        self.good = good


def _iter_frames(fd: int, end: int):
    """Yield ``(kind, seq, payload, end_offset)`` for every intact frame
    in ``fd[0:end]``, streaming in bounded chunks -- O(n) in file bytes
    with memory bounded by one frame + one read chunk, never the whole
    file (the old scan's ``buf += chunk`` whole-file accumulation was
    quadratic in the worst case and unbounded always).  Raises
    ``_TornTail`` at the first incomplete or CRC-failing frame; a clean
    EOF just stops."""
    buf = bytearray()
    base = 0  # file offset of buf[0]
    pos = 0   # parse cursor, relative to buf
    read_off = 0  # next file offset to pread

    def _fill(need: int) -> bool:
        # ensure buf holds >= need bytes past pos (or EOF); True if it does
        nonlocal read_off
        while len(buf) - pos < need and read_off < end:
            chunk = os.pread(fd, min(_READ_CHUNK, end - read_off), read_off)
            if not chunk:
                break  # file shorter than fstat said (concurrent truncate)
            buf.extend(chunk)
            read_off += len(chunk)
        return len(buf) - pos >= need

    while base + pos < end:
        # compact the consumed prefix so the carry buffer stays bounded
        if pos >= _READ_CHUNK:
            del buf[:pos]
            base += pos
            pos = 0
        good = base + pos
        if not _fill(_HDR_BYTES):
            raise _TornTail("incomplete frame header", good)
        kind, seq, length = _PREFIX.unpack_from(buf, pos)
        (crc,) = _CRC.unpack_from(buf, pos + _PREFIX.size)
        if kind not in (_KIND_BATCH, _KIND_APPLIED) or length > _MAX_FRAME_BYTES:
            raise _TornTail(
                f"corrupt frame header (kind={kind!r}, len={length})", good)
        if not _fill(_HDR_BYTES + length):
            raise _TornTail("incomplete frame payload", good)
        payload = bytes(buf[pos + _HDR_BYTES:pos + _HDR_BYTES + length])
        if zlib.crc32(bytes(buf[pos:pos + _PREFIX.size]) + payload) != crc:
            raise _TornTail("frame CRC mismatch", good)
        pos += _HDR_BYTES + length
        yield kind, seq, payload, base + pos


def _write_all(fd: int, data: bytes) -> None:
    """Write every byte or raise.  ``os.write`` may return a short count
    (ENOSPC mid-frame, signal) WITHOUT raising -- treating that as the
    durability point would ack a batch whose frame the startup scan will
    truncate as a torn tail, silently reopening the loss window."""
    view = memoryview(data)
    while view:
        n = os.write(fd, view)
        if n <= 0:
            raise OSError(
                f"journal write made no progress ({len(view)} bytes left)")
        view = view[n:]


class LinkJournal:
    """Append-only redo log for sealed write-behind link batches.

    Thread model: ``append_batch`` runs on the ingest path (under the
    write-behind buffer's condition, itself under the workload lock),
    ``mark_applied`` on the background flusher, readers of the plain int
    counters go lock-free.  ``self._lock`` serializes every file
    mutation; the only lock ever taken under it is the fault plan's
    crash counter (crash tests only).
    """

    def __init__(self, path: str, sync: Optional[str] = None):
        self.path = path
        self._sync = sync if sync in SYNC_POLICIES else sync_policy()
        self._lock = threading.Lock()
        # writes (the close() -1 sentinel) serialize under the lock; the
        # fd VALUE is read lock-free by the pre-publication startup scan
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)  # guarded by: self._lock [writes]
        self._last_seq = 0  # guarded by: self._lock [writes]
        self._applied_seq = 0  # guarded by: self._lock [writes]
        # batches scanned at open with seq > the applied watermark, in
        # file order -- recovery's replay set (cleared by unapplied())
        self._unapplied: List[Tuple[int, List]] = []  # guarded by: self._lock [writes]
        # lock-free scrape mirrors (plain ints; exact under self._lock)
        self.pending_batches = 0  # guarded by: self._lock [writes]
        self.size_bytes = 0  # guarded by: self._lock [writes]
        # batch frame bytes appended since open (never reset by
        # compaction): the append path's running count, read lock-free
        self.appended_bytes = 0  # guarded by: self._lock [writes]
        # compaction pins held by batches_after walks (retained())
        self._pins = 0  # guarded by: self._lock [writes]
        # torn tails truncated by the startup scan (0 or 1 per open)
        self.torn_tails = 0
        self._scan()

    # -- startup scan ---------------------------------------------------------

    def _scan(self) -> None:
        """Parse every frame via the streaming iterator (O(n) bytes,
        memory bounded by the UNAPPLIED batches -- applied batches are
        pruned as their watermark frames stream past, so a large mostly-
        applied journal never materializes in RAM); truncate a torn/
        corrupt tail (counted, logged, never fatal) and collect unapplied
        batches for replay."""
        from collections import deque

        size = os.fstat(self._fd).st_size
        good = 0
        pending: deque = deque()  # (seq, rows), insertion = seq order
        applied = 0
        last = 0
        torn = None
        try:
            for kind, seq, payload, end in _iter_frames(self._fd, size):
                if kind == _KIND_BATCH:
                    try:
                        rows = json.loads(payload.decode("utf-8"))
                    except ValueError:
                        torn = "undecodable batch payload"
                        break
                    pending.append((seq, rows))
                    last = max(last, seq)
                else:
                    applied = max(applied, seq)
                    while pending and pending[0][0] <= applied:
                        pending.popleft()
                good = end
        except _TornTail as tear:
            torn, good = tear.reason, tear.good
        if torn is not None:
            self.torn_tails += 1
            telemetry.JOURNAL_TORN_TAILS.inc()
            logger.warning(
                "truncating torn journal tail in %s at byte %d (%s; %d "
                "byte(s) dropped) -- everything before the tear is intact",
                self.path, good, torn, size - good,
            )
            os.ftruncate(self._fd, good)
        with self._lock:
            self._last_seq = max(last, applied)
            self._applied_seq = applied
            self._unapplied = [(s, rows) for s, rows in pending
                               if s > applied]
            self.pending_batches = len(self._unapplied)
            self.size_bytes = good

    def unapplied(self) -> List[Tuple[int, List]]:
        """The startup scan's replay set: (seq, encoded rows) for every
        journaled batch past the applied watermark, in append order.
        Consumed once -- recovery replays then marks each applied."""
        with self._lock:
            out, self._unapplied = self._unapplied, []
        return out

    # -- streaming the stable prefix ------------------------------------------

    def head_seq(self) -> int:
        with self._lock:
            return self._last_seq

    def applied_watermark(self) -> int:
        with self._lock:
            return self._applied_seq

    @contextlib.contextmanager
    def retained(self):
        """Pin the journal against compaction for the duration: a walk of
        ``batches_after`` streams frames from the file, and a concurrent
        flusher catching up to the head must not truncate them under the
        walk.  Reentrant (pin counted)."""
        with self._lock:
            self._pins += 1
        try:
            yield self
        finally:
            with self._lock:
                self._pins -= 1

    def batches_after(self, after_seq: int):
        """Stream ``(seq, encoded rows)`` for every journaled batch frame
        with seq > ``after_seq``, in append order.  Lock-free walk of the
        stable append-only prefix (the startup scan's discipline); call
        under ``retained()`` so compaction cannot truncate the frames
        mid-walk.  A torn tail ends the walk silently: frames past a tear
        are untrusted, and the startup scan owns counting and truncating
        them."""
        fd = self._fd
        if fd < 0:
            return
        size = os.fstat(fd).st_size
        try:
            for kind, seq, payload, _end in _iter_frames(fd, size):
                if kind != _KIND_BATCH or seq <= after_seq:
                    continue
                try:
                    rows = json.loads(payload.decode("utf-8"))
                except ValueError:
                    return
                yield seq, rows
        except _TornTail:
            return

    # -- append path (ingest thread) ------------------------------------------

    def append_batch(self, rows: Sequence) -> int:
        """Durably append one sealed batch; returns its sequence number.
        Called BEFORE the batch is acknowledged -- this write (plus the
        configured sync) IS the durability point."""
        payload = json.dumps(rows, separators=(",", ":")).encode("utf-8")
        with self._lock:
            seq = self._last_seq + 1
            frame = _frame(_KIND_BATCH, seq, payload)
            plan = faults.active()
            if plan is not None and plan.crash_hit("mid_journal_write"):
                # torn-tail synthesis: half the frame reaches the disk,
                # then the process dies mid-write (no partial-write
                # cleanup can run -- that is the point)
                os.write(self._fd, frame[: max(1, len(frame) // 2)])
                os.fsync(self._fd)
                plan.crash_now("mid_journal_write")
            _write_all(self._fd, frame)
            if self._sync == "fsync":
                os.fsync(self._fd)
            elif self._sync == "fdatasync":
                getattr(os, "fdatasync", os.fsync)(self._fd)
            self._last_seq = seq
            self.pending_batches = seq - self._applied_seq
            self.size_bytes += len(frame)
            self.appended_bytes += len(frame)
        return seq

    @property
    def sync_policy(self) -> str:
        """How ``append_batch`` syncs: ``fsync``, ``fdatasync`` or
        ``none`` (``DUKE_JOURNAL_SYNC``)."""
        return self._sync

    # -- apply path (background flusher) --------------------------------------

    def mark_applied(self, seq: int) -> None:
        """Advance the applied watermark past ``seq`` (called after the
        durable store committed the batch).  Unsynced by design: losing
        the marker re-replays an applied batch, which is idempotent.
        Compacts once the watermark catches the head."""
        with self._lock:
            if seq <= self._applied_seq:
                return
            frame = _frame(_KIND_APPLIED, seq, b"")
            _write_all(self._fd, frame)
            self._applied_seq = seq
            self.pending_batches = self._last_seq - seq
            self.size_bytes += len(frame)
            if (self._applied_seq == self._last_seq
                    and self.size_bytes >= _COMPACT_BYTES):
                self._compact_locked()

    def _compact_locked(self) -> None:
        # called with self._lock held
        if self._pins > 0:
            return  # a batches_after walk is reading the file; keep frames
        os.ftruncate(self._fd, 0)
        self.size_bytes = 0
        self.pending_batches = 0

    def compact(self) -> None:
        """Truncate to empty iff every journaled batch has been applied
        (recovery's epilogue and the graceful-shutdown path -- a drained
        shutdown leaves an empty journal)."""
        with self._lock:
            if self._applied_seq == self._last_seq:
                self._compact_locked()

    def close(self) -> None:
        with self._lock:
            if self._fd < 0:
                return
            if self._applied_seq == self._last_seq:
                self._compact_locked()
            os.close(self._fd)
            self._fd = -1
