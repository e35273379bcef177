"""Live range migration -- crash-consistent rebalancing (the JAX
package's ``federation/migrate.py`` on torch).

Moving a digest range between serving groups with zero lost and zero
duplicated links, while everything else keeps serving.  The state
machine composes primitives that already shipped:

  1. **freeze** -- the partition map marks the range frozen and bumps the
     epoch (persisted atomically, tmp + ``os.replace``); the source
     group's write fence rises, so a stale router can never land a
     write in the range's old owner (the serving group's epoch fencing,
     generalized).
     Writes to the range answer 429 + Retry-After at the router until
     cutover; reads and every other range are untouched.
  2. **snapshot** -- the range's record rows (source store) and link rows
     (source durable link store) are captured with CRC32 checksums and
     shipped to the target through the same load-state shape as the
     follower bootstrap (encoded link rows + watermark), applied
     through the target's idempotent ``assert_links``.  The snapshot
     deliberately does NOT drain the source's write-behind flusher: the
     capture is consistent as of the journal's applied watermark, and
     everything past the watermark rides step 3 -- so a wedged flusher
     cannot wedge a migration.
  3. **journal-slice replay** -- the source journal's batches past the
     snapshot watermark (the link journal's redo log, pinned against
     compaction for the walk) are filtered to the moving range and
     replayed at the target; idempotent re-application makes at-least-once delivery
     exactly-once in effect.
  4. **cutover** -- one atomic partition-map persist flips the owner and
     thaws the range.  Before it the source owns the range; after it the
     target does; a crash can never expose an in-between state.
  5. **drain** -- the source's now-stale copies are retired: record rows
     tombstone out of its retrieval index (values kept, so link-endpoint
     resolution for rows that STAY at the source still works) and the
     migration state file is removed.  Stale link rows at the source are
     harmless by construction -- the router's ownership filter is the
     one-place dedup rule.

Crash consistency: the ONLY durable decision points are the state file,
the two map persists (freeze, cutover) and the target's own journaled
writes.  Resume re-derives everything else: interrupted before cutover →
redo freeze/snapshot/replay from scratch (all idempotent, and the frozen
range guarantees the source view is stable); interrupted after cutover →
finish the drain.  ``utils.faults`` kill sites (``pre_freeze``,
``post_snapshot``, ``mid_replay``, ``pre_cutover``, ``post_cutover``)
let the chaos differential SIGKILL a real process at each decision
boundary and prove the recovered federation bit-identical to an
unmigrated control (tests/test_federation_chaos.py).
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..core.records import DELETED_PROPERTY_NAME, Record
from ..links.replica import decode_link, encode_link, rows_checksum
from ..store.records import serialize_record
from ..telemetry import tracing
from ..telemetry.env import env_int
from ..utils import faults
from .ranges import route_key

logger = logging.getLogger("federation-migrate")

MIGRATION_STATE_FILE = "migration.json"

# phase codes for the duke_fed_migration_phase gauge (0 = idle)
PHASE_CODES = {"idle": 0, "frozen": 1, "copied": 2, "cutover": 3,
               "drain": 4}

# journal-slice replay applies in bounded chunks so the mid_replay kill
# site sits between real durable steps, not after an all-or-nothing apply
_REPLAY_CHUNK_ROWS = 256

# retained phase timelines for GET /debug/migrations:
# bounded ring, in-memory only -- restart starts an empty ring and the
# resumed migration writes a fresh timeline with resumed=True
DEFAULT_TIMELINE_RING = 64


def _timeline_ring() -> int:
    return max(1, env_int("DUKE_MIGRATION_RING", DEFAULT_TIMELINE_RING))


def _record_rows_checksum(rows: List[list]) -> int:
    """CRC32 chained over ``[rid, serialized]`` record rows (the record
    half of the snapshot integrity stamp; link rows use
    ``links.replica.rows_checksum``)."""
    import zlib

    crc = 0
    for rid, data in rows:
        crc = zlib.crc32(data.encode("utf-8", "surrogatepass"),
                         zlib.crc32(rid.encode("utf-8", "surrogatepass"),
                                    crc))
    return crc


class SnapshotIntegrityError(RuntimeError):
    """The shipped range snapshot failed its checksum -- the load refuses
    (a half-applied corrupt snapshot would be silent row loss; the
    migration re-snapshots instead)."""


class RangeMigrator:
    """Drives (and resumes) one range migration over a ``Federation``."""

    def __init__(self, federation):
        self.fed = federation
        self.state_path = os.path.join(federation.data_folder,
                                       MIGRATION_STATE_FILE)
        # status snapshot for /stats and the phase gauge: whole-dict
        # replacement, read lock-free by scrapes
        self._status: Dict = {"active": False, "phase": "idle"}
        # outcome counters for duke_fed_migrations_total (single writer:
        # migrations are serialized by Federation._admin_lock)
        self.outcomes = {"completed": 0, "resumed": 0, "failed": 0}
        # phase-timeline ring for /debug/migrations: appended by the one
        # serialized migration's ``_drive``, read lock-free by the plane
        # (list() copy -- the _status whole-value stance)
        self.timelines: Deque[dict] = deque(maxlen=_timeline_ring())

    # -- phase timeline --------------------------------------------

    def timelines_snapshot(self) -> List[dict]:
        """Newest-first copies of the retained migration timelines."""
        return [dict(t, phases=list(t["phases"]))
                for t in reversed(list(self.timelines))]

    @staticmethod
    def _log_phase(timeline: dict, phase: str, start_unix: float,
                   duration_ns: int, **attrs) -> None:
        """One completed phase: a retained timeline row plus (when the
        migration runs under a trace) a ``migrate.<phase>`` span laid out
        from its accumulated duration (the add_phase_spans precedent)."""
        row = {"phase": phase, "start_unix": round(start_unix, 6),
               "duration_ms": round(duration_ns / 1e6, 3)}
        row.update(attrs)
        timeline["phases"].append(row)
        end_ns = time.monotonic_ns()
        tracing.add_span(f"migrate.{phase}", end_ns - duration_ns, end_ns,
                         dict(attrs) or None)

    # -- status ---------------------------------------------------------------

    def status(self) -> dict:
        return dict(self._status)

    def phase_code(self) -> int:
        return PHASE_CODES.get(self._status.get("phase", "idle"), 0)

    def _set_phase(self, state: dict, phase: str) -> None:
        self._status = {
            "active": phase not in ("idle", "done"),
            "phase": phase if phase != "done" else "idle",
            "range": state.get("range"),
            "source": state.get("source"),
            "target": state.get("target"),
        }

    # -- state file -----------------------------------------------------------

    def _write_state(self, state: dict) -> None:
        from ..utils.atomicio import atomic_write_json

        atomic_write_json(self.state_path, state)

    def _load_state(self) -> Optional[dict]:
        if not os.path.exists(self.state_path):
            return None
        with open(self.state_path, "r", encoding="utf-8") as f:
            return json.load(f)

    def _clear_state(self) -> None:
        try:
            os.remove(self.state_path)
        except FileNotFoundError:
            pass

    # -- entry points ---------------------------------------------------------

    def migrate(self, range_id: str, target_group: int) -> dict:
        pmap = self.fed.map
        r = pmap.find(range_id)  # raises KeyError for an unknown range
        if not (0 <= target_group < len(self.fed.groups)):
            raise ValueError(f"unknown target group {target_group}")
        if r.group == target_group and not r.frozen:
            return {"range": range_id, "source": r.group,
                    "target": target_group, "moved_records": 0,
                    "moved_links": 0, "replayed_slices": 0,
                    "already_owned": True}
        state = {"range": range_id, "source": r.group,
                 "target": target_group}
        self._write_state(state)
        # kill site: intent durable, map untouched -- restart resumes and
        # performs the whole migration
        faults.check_crash("pre_freeze")
        return self._drive(state)

    def resume(self) -> Optional[dict]:
        """Finish a migration a crash interrupted (called by the
        Federation constructor before serving starts)."""
        state = self._load_state()
        if state is None:
            return None
        self.outcomes["resumed"] += 1
        logger.warning(
            "resuming interrupted migration of range %s: group %d -> %d",
            state["range"], state["source"], state["target"])
        return self._drive(state, resumed=True)

    # -- the state machine ----------------------------------------------------

    def _drive(self, state: dict, resumed: bool = False) -> dict:
        range_id = state["range"]
        source, target = int(state["source"]), int(state["target"])
        pmap = self.fed.map
        # the retained timeline rides the ring from the start so a
        # migration that dies in flight still shows its completed phases
        timeline = {
            "range": range_id, "source": source, "target": target,
            "resumed": resumed, "started_unix": round(time.time(), 6),
            "trace_id": tracing.current_trace_id(),
            "outcome": "in-flight", "phases": [],
        }
        self.timelines.append(timeline)
        try:
            r = pmap.find(range_id)
            if r.group == target and not r.frozen:
                # crash landed after the cutover persisted: only the
                # drain is left
                logger.warning("range %s already cut over to group %d; "
                               "finishing drain", range_id, target)
                moved = {"records": 0, "links": 0, "slices": 0}
            else:
                # freeze (idempotent on resume) and fence the source so
                # stale routers bounce off the old owner
                t0, m0 = time.time(), time.monotonic_ns()
                epoch = pmap.freeze(range_id)
                self.fed.groups[source].fence(epoch)
                self._set_phase(state, "frozen")
                self._log_phase(timeline, "freeze", t0,
                                time.monotonic_ns() - m0, epoch=epoch)
                moved = self._copy_range(range_id, source, target, timeline)
                self._set_phase(state, "copied")
                # rebalanced ranges start hot: the copy may have grown
                # the target's corpus past a capacity doubling, so make
                # it resident on the card BEFORE the cutover points
                # traffic at it.  Best-effort: a cold target serves
                # correctly, just slower.
                self._warm_target(target)
                # kill site: target complete and durable, map still
                # names the source -- restart redoes the copy (idempotent)
                faults.check_crash("pre_cutover")
                t0, m0 = time.time(), time.monotonic_ns()
                epoch = pmap.assign(range_id, target)
                self.fed.groups[source].fence(epoch)
                self.fed.groups[target].fence(epoch)
                self._set_phase(state, "cutover")
                self._log_phase(timeline, "cutover", t0,
                                time.monotonic_ns() - m0, epoch=epoch)
                # kill site: ownership flipped, drain pending
                faults.check_crash("post_cutover")
            t0, m0 = time.time(), time.monotonic_ns()
            self._drain_source(range_id, source)
            self._set_phase(state, "drain")
            self._log_phase(timeline, "drain", t0,
                            time.monotonic_ns() - m0)
            self._clear_state()
            self.outcomes["completed"] += 1
            timeline["outcome"] = "completed"
            self._set_phase(state, "done")
            logger.info(
                "range %s migrated: group %d -> %d (%d record(s), %d "
                "link row(s), %d journal slice batch(es))", range_id,
                source, target, moved["records"], moved["links"],
                moved["slices"])
            return {"range": range_id, "source": source, "target": target,
                    "moved_records": moved["records"],
                    "moved_links": moved["links"],
                    "replayed_slices": moved["slices"]}
        except BaseException:
            # the state file stays: the migration is still in flight and
            # MUST complete (resume) -- the frozen range keeps rejecting
            # writes until it does, which is the safe failure mode
            self.outcomes["failed"] += 1
            timeline["outcome"] = "failed"
            self._set_phase(state, "idle")
            raise

    def _warm_target(self, target: int) -> None:
        """Make every target workload's device corpus resident on its card
        before cutover (no-op for the host backend).  The JAX package
        warms a compiled scorer ladder here; the port compiles nothing
        per shape (each hand kernel builds once per process), so what is
        cold after the load is the copy: the rows the snapshot appended
        and the mirrors' tombstone bits reach the card here, under the
        arena's lease like any append, instead of inside the first query
        after cutover.  Best-effort: an arena refusal leaves the corpus
        on the host, and the first query re-admits it (or answers 503)."""
        from ..ops.arena import ArenaAdmissionError

        for (kind, name), wl in self.fed.groups[target].workloads.items():
            corpus = getattr(wl.index, "corpus", None)
            if corpus is None:
                continue
            try:
                corpus.device_arrays()
            except ArenaAdmissionError:
                logger.warning("target %s/%s corpus not made resident "
                               "before cutover (arena refused)", kind,
                               name, exc_info=True)

    # -- copy: snapshot + ship + journal slice --------------------------------

    def _copy_range(self, range_id: str, source: int, target: int,
                    timeline: Optional[dict] = None) -> Dict[str, int]:
        r = self.fed.map.find(range_id)
        span = (r.lo, r.hi)
        totals = {"records": 0, "links": 0, "slices": 0}
        src_group = self.fed.groups[source]
        tgt_group = self.fed.groups[target]
        # per-workload snapshot/replay intervals interleave, so the
        # timeline rows carry ACCUMULATED durations (the add_phase_spans
        # stance) with row/byte attributes summed across workloads
        copy_start = time.time()
        snapshot_ns = replay_ns = 0
        mirrors = record_bytes = 0
        for wl_key in src_group.workloads:
            t = time.monotonic_ns()
            snapshot = self._snapshot_workload(src_group, wl_key, span)
            # kill site: snapshot captured, nothing shipped
            faults.check_crash("post_snapshot")
            journal = snapshot.pop("journal")
            try:
                self._load_snapshot(tgt_group, wl_key, snapshot)
                totals["records"] += len(snapshot["records"])
                totals["links"] += len(snapshot["links"])
                mirrors += len(snapshot["mirrors"])
                record_bytes += sum(len(data)
                                    for _rid, data in snapshot["records"])
                snapshot_ns += time.monotonic_ns() - t
                t = time.monotonic_ns()
                totals["slices"] += self._replay_slice(
                    journal, snapshot["watermark"], span, src_group,
                    tgt_group, wl_key)
                replay_ns += time.monotonic_ns() - t
            finally:
                if snapshot["pin"] is not None:
                    snapshot["pin"].__exit__(None, None, None)
            # the target's write-behind flush is drained per workload so
            # cutover never points readers at a store that is still
            # catching up on the shipped rows
            tgt_group.workloads[wl_key].link_database.drain()
        if timeline is not None:
            self._log_phase(timeline, "snapshot", copy_start, snapshot_ns,
                            records=totals["records"],
                            links=totals["links"], mirrors=mirrors,
                            record_bytes=record_bytes)
            self._log_phase(timeline, "replay",
                            copy_start + snapshot_ns / 1e9, replay_ns,
                            slices=totals["slices"])
        return totals

    def _snapshot_workload(self, src_group, wl_key: Tuple[str, str],
                           span: Tuple[int, int]) -> dict:
        """Checksummed range snapshot of one workload at the source.

        Captured under the source workload lock for a stable view.  The
        journal watermark is read BEFORE the link rows: a batch applied
        after the watermark read lands in the slice too -- re-applying it
        is idempotent, while the reverse order could lose a batch that
        applied (and compacted) between the two reads."""
        lo, hi = span
        wl = src_group.workloads[wl_key]
        with wl.lock:
            journal = getattr(wl.link_database, "journal", None)
            pin = journal.retained() if journal is not None else None
            if pin is not None:
                pin.__enter__()
            try:
                watermark = (journal.applied_watermark()
                             if journal is not None else 0)
                records = []
                if wl.record_store is not None:
                    for rec in wl.record_store.all_records():
                        rid = rec.record_id
                        if rid is not None and lo <= route_key(rid) < hi:
                            records.append([rid, serialize_record(rec)])
                # the durable store view (NOT the drain barrier -- see
                # class docstring): everything this misses is past the
                # watermark and rides the journal slice
                inner = getattr(wl.link_database, "inner",
                                wl.link_database)
                links = [list(encode_link(l)) for l in inner.get_all_links()
                         if lo <= route_key(l.id1) < hi]
                # resolution mirrors: moved links whose OTHER endpoint
                # lives outside the range need that endpoint resolvable
                # at the target for feed materialization -- shipped as
                # index tombstones (resolvable, never retrievable, so
                # they can't seed target-local matches the map would
                # filter)
                mirrors = self._collect_mirrors(wl, links, span)
            except BaseException:
                if pin is not None:
                    pin.__exit__(None, None, None)
                raise
        return {
            "workload": wl_key,
            "span": span,
            "watermark": watermark,
            "records": records,
            "links": links,
            "mirrors": mirrors,
            "records_checksum": _record_rows_checksum(records),
            "links_checksum": rows_checksum(links),
            "mirrors_checksum": _record_rows_checksum(mirrors),
            "journal": journal,
            "pin": pin,
        }

    @staticmethod
    def _collect_mirrors(wl, link_rows, span: Tuple[int, int]) -> List[list]:
        """``[rid, serialized]`` for every out-of-range endpoint of the
        given encoded link rows that the source store can resolve."""
        lo, hi = span
        need = set()
        for row in link_rows:
            for endpoint in (row[0], row[1]):
                if not (lo <= route_key(endpoint) < hi):
                    need.add(endpoint)
        if not need or wl.record_store is None:
            return []
        out = []
        get_many = getattr(wl.record_store, "get_many", None)
        if get_many is not None:
            found = get_many(sorted(need))
        else:
            found = {rid: wl.record_store.get(rid) for rid in sorted(need)}
        for rid in sorted(need):
            rec = found.get(rid)
            if rec is not None:
                out.append([rid, serialize_record(rec)])
        return out

    def _load_snapshot(self, tgt_group, wl_key: Tuple[str, str],
                       snapshot: dict) -> None:
        """Apply a shipped range snapshot at the target (the follower
        bootstrap shape: verify checksums, then idempotent loads)."""
        if (_record_rows_checksum(snapshot["records"])
                != snapshot["records_checksum"]
                or rows_checksum(snapshot["links"])
                != snapshot["links_checksum"]
                or _record_rows_checksum(snapshot["mirrors"])
                != snapshot["mirrors_checksum"]):
            raise SnapshotIntegrityError(
                f"range snapshot for {wl_key} failed its checksum; "
                "refusing to load")
        wl = tgt_group.workloads[wl_key]
        with wl.lock:
            records = [Record(json.loads(data))
                       for _rid, data in snapshot["records"]]
            if records:
                if wl.record_store is not None:
                    wl.record_store.put_many(records)
                for rec in records:
                    wl.index.index(rec)
                wl.index.commit()
            self._load_mirrors_locked(wl, snapshot["mirrors"])
            links = [decode_link(row) for row in snapshot["links"]]
            if links:
                # timestamps ride verbatim; identical re-asserts are
                # no-ops (the idempotence contract recovery relies on)
                wl.link_database.assert_links(links)
                wl.link_database.commit()

    @staticmethod
    def _load_mirrors_locked(wl, mirrors: List[list]) -> int:
        """Fold resolution mirrors into the target: records the moved
        links reference but some other range owns, landed as index
        TOMBSTONES (resolvable by ``find_record_by_id`` -- values intact
        -- but excluded from retrieval, so no target-local match can form
        against a row the map routes elsewhere).  Rows already
        resolvable at the target (live residents, earlier mirrors) are
        left alone."""
        # dukecheck: holds wl.lock
        dead: List[Record] = []
        for rid, data in mirrors:
            if wl.index.find_record_by_id(rid) is not None:
                continue
            values = json.loads(data)
            values[DELETED_PROPERTY_NAME] = ["true"]
            dead.append(Record(values))
        if dead:
            if wl.record_store is not None:
                wl.record_store.put_many(dead)
            for rec in dead:
                wl.index.index(rec)
            wl.index.commit()
        return len(dead)

    def _replay_slice(self, journal, watermark: int,
                      span: Tuple[int, int], src_group, tgt_group,
                      wl_key: Tuple[str, str]) -> int:
        """Replay the source journal's post-watermark batches, filtered
        to the moving range, into the target -- in bounded chunks, with
        the ``mid_replay`` kill site between chunk commits."""
        if journal is None:
            return 0
        lo, hi = span
        src_wl = src_group.workloads[wl_key]
        wl = tgt_group.workloads[wl_key]
        replayed = 0
        chunk: List = []

        def apply(rows) -> None:
            # slice rows can reference out-of-range endpoints the
            # snapshot never saw -- mirror them like the snapshot path
            mirrors = self._collect_mirrors(src_wl, rows, span)
            with wl.lock:
                self._load_mirrors_locked(wl, mirrors)
                wl.link_database.assert_links(
                    [decode_link(r) for r in rows])
                wl.link_database.commit()

        for _seq, rows in journal.batches_after(watermark):
            for row in rows:
                if lo <= route_key(row[0]) < hi:
                    chunk.append(row)
            if len(chunk) >= _REPLAY_CHUNK_ROWS:
                apply(chunk)
                replayed += 1
                chunk = []
                # kill site: part of the slice durably applied at the
                # target, the rest not -- restart re-copies idempotently
                faults.check_crash("mid_replay")
        if chunk:
            apply(chunk)
            replayed += 1
        # kill site (also for an empty slice, the frozen-range common
        # case): snapshot durably loaded at the target, replay done,
        # cutover not yet reached
        faults.check_crash("mid_replay")
        return replayed

    # -- drain: retire the source's stale copies ------------------------------

    def _drain_source(self, range_id: str, source: int) -> None:
        """Tombstone the moved records out of the source's retrieval
        index so no FUTURE source-local match can mint a link against a
        record the range's new owner now serves (such a link would be
        filtered from every feed -- silent loss).  Values are preserved
        in the tombstone, so link rows that STAY at the source keep
        resolving their endpoints.  Idempotent (resume re-runs it).  The
        source's stale link rows stay put: the router's ownership filter
        already excludes them from every federated read."""
        r = self.fed.map.find(range_id)
        lo, hi = r.lo, r.hi
        src_group = self.fed.groups[source]
        for wl_key, wl in src_group.workloads.items():
            with wl.lock:
                if wl.record_store is None:
                    continue
                dead: List[Record] = []
                for rec in wl.record_store.all_records():
                    rid = rec.record_id
                    if (rid is None or not (lo <= route_key(rid) < hi)
                            or rec.is_deleted()):
                        continue
                    values = rec.to_dict()
                    values[DELETED_PROPERTY_NAME] = ["true"]
                    dead.append(Record(values))
                if not dead:
                    continue
                wl.record_store.put_many(dead)
                for rec in dead:
                    wl.index.index(rec)
                wl.index.commit()
                logger.info(
                    "drained %d migrated record(s) out of group %d's "
                    "%s/%s index", len(dead), source, *wl_key)
