"""Scatter-gather partition router over N serving groups (the JAX
package's ``federation/router.py`` on torch).

Ingest batches partition by the owner group of each entity's routing key
and fan out concurrently with per-group timeouts and bounded full-jitter
retries (``utils.backoff`` -- the ONE policy copy).  Link feeds merge
across groups under the composite per-range cursor from
``federation.ranges`` (the opaque federated ``?since=`` token).

Degradation contract (the robustness point of the tier): a dead group
takes down only ITS ranges.  Ingest touching a dead range surfaces 503
with a Retry-After (the max across contacted groups' hints) and the
degraded-range list in the error body; everything owned by live ranges
keeps succeeding, and the merged feed keeps serving every live group's
links while the dead ranges' cursors simply stop advancing (the client
resumes them loss-free once the group returns).

``LocalGroup`` is the in-process stand-in for a group's leader endpoint
-- the seam where a real deployment slots an RPC client.  It enforces
the epoch fence: a router presenting an epoch below the group's fence
(its map predates a freeze/cutover) is refused with
``StaleRouterEpoch`` and must refresh its map, so a stale router can
never write into a range's old owner.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..engine.workload import Workload
from ..links.replica import feed_row
from ..telemetry import heat, slo, tracing
from ..telemetry.decisions import _MonitorHist
from ..telemetry.env import env_flag, env_float, env_int
from ..telemetry.registry import DEFAULT_LATENCY_BUCKETS
from ..utils import faults
from ..utils.backoff import full_jitter_delay
from .ranges import (
    PartitionMap,
    Range,
    StaleRouterEpoch,
    decode_cursor,
    encode_cursor,
    route_key,
)

logger = logging.getLogger("federation-router")

# scatter knobs: per-group call budget and transient-failure retries --
# resolved per call (the failure path is rare; the env read is not hot)
DEFAULT_FED_TIMEOUT_S = 30.0
DEFAULT_FED_RETRIES = 2
_RETRY_BASE_S = 0.05
_RETRY_CAP_S = 1.0
# Retry-After floor when a dead group offers no hint of its own
DEFAULT_FED_RETRY_AFTER_S = 2


def _fed_timeout() -> float:
    return max(0.1, env_float("DUKE_FED_TIMEOUT", DEFAULT_FED_TIMEOUT_S))


def _fed_retries() -> int:
    return max(0, env_int("DUKE_FED_RETRIES", DEFAULT_FED_RETRIES))


class GroupUnavailable(RuntimeError):
    """The group could not be reached (dead process, injected
    ``fed_down``, closed workload, scatter timeout)."""

    def __init__(self, message: str,
                 retry_after: int = DEFAULT_FED_RETRY_AFTER_S):
        super().__init__(message)
        self.retry_after = retry_after


class GroupBusy(GroupUnavailable):
    """The group is alive but its workload lock did not yield within the
    read timeout -- carries the group's own write-hold Retry-After
    hint."""


class UnknownFederatedWorkload(KeyError):
    pass


class FrozenRange(RuntimeError):
    """The batch touches a range frozen by a live migration: the whole
    batch answers 429 + Retry-After (partial admission would make the
    client's at-least-once resend semantics range-dependent)."""

    def __init__(self, range_ids: List[str], retry_after: int):
        super().__init__(
            f"range(s) {', '.join(range_ids)} frozen by a live "
            "migration; retry the batch shortly")
        self.range_ids = range_ids
        self.retry_after = retry_after


class PartialIngestFailure(RuntimeError):
    """Scatter-gather partial failure: the live groups' sub-batches
    applied; the dead groups' did not.  Carries the degraded-range list
    and the max Retry-After across contacted groups (backpressure
    propagates through the router)."""

    def __init__(self, degraded_ranges: List[str], retry_after: int,
                 errors: Dict[int, str]):
        super().__init__(
            f"{len(errors)} group(s) unavailable; degraded ranges: "
            f"{', '.join(degraded_ranges) or '(none touched)'}")
        self.degraded_ranges = degraded_ranges
        self.retry_after = retry_after
        self.errors = errors


class LocalGroup:
    """In-process handle on one serving group's leader.

    Holds the group's workloads (each a full ``build_workload`` stack
    over the group's own data folder) and the group-side half of the
    epoch fence.  All methods are transport-shaped: plain values in,
    plain values out, failures as exceptions -- an RPC client drops into
    the same seam."""

    READ_LOCK_TIMEOUT_S = 1.0

    def __init__(self, idx: int, workloads: Dict[Tuple[str, str], Workload],
                 epoch: int = 1):
        self.idx = idx
        self.workloads = workloads
        # the write fence: the highest map epoch at which this group's
        # ownership changed.  Plain int, GIL-atomic single writer (the
        # migrator); read on every ingest.
        self.fence_epoch = epoch
        self.closed = False

    # -- plumbing -------------------------------------------------------------

    def _check_reachable(self) -> None:
        if self.closed:
            raise GroupUnavailable(f"group {self.idx} is closed")
        plan = faults.active()
        if plan is not None and plan.fed_group_down(self.idx):
            raise GroupUnavailable(
                f"group {self.idx} unreachable (injected fed_down)")

    def workload(self, kind: str, name: str) -> Workload:
        wl = self.workloads.get((kind, name))
        if wl is None:
            raise UnknownFederatedWorkload(f"{kind}/{name}")
        return wl

    def fence(self, epoch: int) -> None:
        """Raise the write fence (migrator, at freeze and cutover)."""
        if epoch > self.fence_epoch:
            self.fence_epoch = epoch

    def _check_epoch(self, epoch: int) -> None:
        if epoch < self.fence_epoch:
            raise StaleRouterEpoch(self.fence_epoch, epoch)

    # -- ingest ---------------------------------------------------------------

    def ingest(self, kind: str, name: str, dataset_id: str,
               entities: List[dict], *, epoch: int,
               trace_ctx: Optional[dict] = None) -> bytes:
        """Apply one routed sub-batch; returns the group-side remote
        span tree as wire bytes (``b""`` untraced -- the exact shape an
        RPC response would carry back, per the dispatch.py precedent)."""
        # the capture opens a DETACHED trace continuing the router's ids
        # in this scatter thread (threads inherit no contextvars), so the
        # engine spans the scheduler attaches land in the same tree;
        # with trace_ctx None every span inside stays a no-op.
        with tracing.capture_remote(
                "group.ingest", trace_ctx,
                {"group": self.idx, "entities": len(entities)}) as cap:
            t0 = time.monotonic()
            self._check_reachable()
            self._check_epoch(epoch)
            wl = self.workload(kind, name)
            if dataset_id not in wl.datasources:
                raise UnknownFederatedWorkload(f"{kind}/{name}/{dataset_id}")
            if wl.submit_batch(dataset_id, entities) is None:
                raise GroupUnavailable(
                    f"group {self.idx} workload {kind}/{name} was replaced "
                    "mid-batch")
            # fence RE-CHECK after the write: the pre-write check is
            # check-then-act -- a freeze can land between it and the batch
            # taking the workload lock, and a write completing after the
            # migration's locked snapshot walk would be acked yet invisible
            # (its range's rows filtered at the old owner forever).  Raising
            # HERE withholds the ack instead: the client resends, the
            # refreshed router routes to the live owner, and the idempotent
            # assert absorbs any rows the snapshot DID capture.  Sound
            # because the freeze fences BEFORE its snapshot takes the
            # workload lock: if this read still sees the old fence, the
            # write completed before any snapshot could have started.
            self._check_epoch(epoch)
            # always-on ingest SLO: group ingest bypasses the
            # service scheduler, so the group boundary is its
            # scheduler-arrival equivalent -- lock-wait (the queueing
            # here) included.  Leaf tracker lock, no other lock held.
            done = time.monotonic()
            slo.tracker("ingest", kind, name).record(
                done - t0, done, tracing.sampled_trace_id())
            slo.feed_meter(kind, name).note_write()
        return cap.wire()

    # -- feed walk ------------------------------------------------------------

    def links_walk(self, kind: str, name: str, since: int, limit: int,
                   trace_ctx: Optional[dict] = None
                   ) -> Tuple[List[tuple], bool, bytes]:
        """One bounded page of this group's link stream past ``since``:
        ``([(id1, timestamp, feed_row), ...], drained, span_wire)``.
        Rows carry their owner endpoint id so the ROUTER applies the
        ownership filter (the group does not hold the map).  Takes the
        workload lock with the read timeout -- contention surfaces as
        GroupBusy with the workload's own Retry-After hint, never a
        hang."""
        with tracing.capture_remote(
                "group.links_walk", trace_ctx,
                {"group": self.idx, "since": since}) as cap:
            self._check_reachable()
            wl = self.workload(kind, name)
            if not wl.lock.acquire(timeout=self.READ_LOCK_TIMEOUT_S):
                raise GroupBusy(
                    f"group {self.idx} workload lock busy",
                    retry_after=wl.busy_retry_after())
            try:
                if wl.closed:
                    raise GroupUnavailable(
                        f"group {self.idx} workload {kind}/{name} closed")
                links = wl.link_database.get_changes_page(since, limit)
                prefetch = getattr(getattr(wl.index, "records", None),
                                   "prefetch", None)
                if prefetch is not None and links:
                    prefetch({l.id1 for l in links} | {l.id2 for l in links})
                rows = [(l.id1, l.timestamp,
                         feed_row(l, wl.index.find_record_by_id))
                        for l in links]
            finally:
                wl.lock.release()
        return rows, len(links) < limit, cap.wire()

    def close(self) -> None:
        self.closed = True
        for wl in self.workloads.values():
            with wl.lock:
                wl.close()


class FederationRouter:
    """The scatter-gather tier: routes by the live partition map, keeps
    per-group health, and propagates backpressure.

    Lock discipline: ``_health_lock`` guards only the plain counters --
    it is NEVER held across a group call, so a wedged group can stall
    only its own scatter thread, not the router."""

    def __init__(self, map_provider: Callable[[], PartitionMap],
                 groups: List[LocalGroup]):
        self._map_provider = map_provider
        self.groups = groups
        self._health_lock = threading.Lock()
        # consecutive scatter failures + last error, per group index
        self._failures: Dict[int, int] = {}  # guarded by: self._health_lock [writes]
        self._last_error: Dict[int, str] = {}  # guarded by: self._health_lock [writes]
        self._last_ok: Dict[int, float] = {}  # guarded by: self._health_lock [writes]
        # request outcomes for the duke_fed_requests_total snapshot
        self.outcomes = {"ok": 0, "degraded": 0, "frozen": 0}  # guarded by: self._health_lock [writes]
        # per-range scatter accounting (the hot-range signal)
        # -- written AFTER the scatter returns, so like _health_lock this
        # leaf lock is never held across a group call
        self._range_lock = threading.Lock()
        # range_id -> [ {outcome: count}, _MonitorHist ]
        self._range_stats: Dict[str, list] = {}  # guarded by: self._range_lock [writes]
        # sub-range heat map: fed per routed record in
        # _route_entities with unlocked increments (torn counts
        # tolerated -- the QUERY_BLOCKS stance); DUKE_FED_HEAT=0 turns
        # the bookkeeping off entirely (the bench's attribution-off arm)
        self.heat: Optional[heat.HeatMap] = (
            heat.HeatMap() if env_flag("DUKE_FED_HEAT", True) else None)

    # -- health bookkeeping ---------------------------------------------------

    def _mark(self, group: int, error: Optional[BaseException]) -> None:
        with self._health_lock:
            if error is None:
                self._failures.pop(group, None)
                self._last_error.pop(group, None)
                self._last_ok[group] = time.monotonic()
            else:
                self._failures[group] = self._failures.get(group, 0) + 1
                self._last_error[group] = repr(error)

    def last_contact(self, group: int) -> Optional[float]:
        """Monotonic timestamp of the last successful contact with the
        group, or None (never reached) -- the scatter plane's lag signal
        (duke_fed_group_seconds_since_contact)."""
        with self._health_lock:
            return self._last_ok.get(group)

    def outcomes_snapshot(self) -> Dict[str, int]:
        with self._health_lock:
            return dict(self.outcomes)

    def _count_outcome(self, outcome: str) -> None:
        with self._health_lock:
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1

    def group_health(self) -> List[dict]:
        pmap = self._map_provider()
        with self._health_lock:
            failures = dict(self._failures)
            errors = dict(self._last_error)
        return [
            {
                "group": g.idx,
                "up": failures.get(g.idx, 0) == 0 and not g.closed,
                "consecutive_failures": failures.get(g.idx, 0),
                "last_error": errors.get(g.idx),
                "fence_epoch": g.fence_epoch,
                "ranges": [r.range_id for r in pmap.group_ranges(g.idx)],
            }
            for g in self.groups
        ]

    def _note_range(self, range_ids: List[str], outcome: str,
                    elapsed_s: float) -> None:
        with self._range_lock:
            for rid in range_ids:
                st = self._range_stats.get(rid)
                if st is None:
                    st = self._range_stats[rid] = [
                        {}, _MonitorHist(DEFAULT_LATENCY_BUCKETS)]
                st[0][outcome] = st[0].get(outcome, 0) + 1
                st[1].observe(elapsed_s)

    def range_stats_snapshot(self) -> Dict[str, tuple]:
        """Per-range scatter stats for the fed collector:
        ``{range_id: ({outcome: count}, (bucket_counts, sum, count))}``
        -- plain copies, detached from the lock."""
        with self._range_lock:
            return {
                rid: (dict(st[0]),
                      (list(st[1].counts), st[1].total, st[1].count))
                for rid, st in self._range_stats.items()
            }

    def degraded_range_ids(self) -> List[str]:
        """Ranges owned by groups whose LAST scatter contact failed --
        the live degraded set for /readyz and the gauge."""
        pmap = self._map_provider()
        with self._health_lock:
            down = {g for g, n in self._failures.items() if n > 0}
        out: List[str] = []
        for g in self.groups:
            if g.idx in down or g.closed:
                out.extend(r.range_id for r in pmap.group_ranges(g.idx))
        return sorted(out)

    # -- scatter machinery ----------------------------------------------------

    def _call_group(self, group: LocalGroup, fn: Callable, *args, **kwargs):
        """One group call with bounded transient retries (full jitter).
        GroupBusy/GroupUnavailable retry; anything else propagates."""
        retries = _fed_retries()
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except GroupUnavailable as e:
                if attempt >= retries:
                    raise
                attempt += 1
                delay = full_jitter_delay(attempt, _RETRY_BASE_S,
                                          _RETRY_CAP_S)
                logger.warning(
                    "group %d call failed (attempt %d/%d; retrying in "
                    "%.3f s): %r", group.idx, attempt, retries, delay, e)
                time.sleep(delay)

    def _scatter(self, jobs: Dict[int, Callable]) -> Dict[int, tuple]:
        """Run one callable per group concurrently; returns
        ``{group: (ok, value_or_error)}``.  A job that misses the
        per-group deadline is marked GroupUnavailable (its thread may
        still finish in the background -- the at-least-once/idempotent
        write contract makes that safe, same as any client resend)."""
        results: Dict[int, tuple] = {}
        results_lock = threading.Lock()

        def run(gidx: int, job: Callable) -> None:
            try:
                value = job()
                with results_lock:
                    results[gidx] = (True, value)
            except BaseException as e:  # collected, not propagated
                with results_lock:
                    results[gidx] = (False, e)

        threads = [
            threading.Thread(target=run, args=(gidx, job), daemon=True,
                             name=f"fed-scatter-g{gidx}")
            for gidx, job in jobs.items()
        ]
        for t in threads:
            t.start()
        deadline = time.monotonic() + _fed_timeout()
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        with results_lock:
            for gidx in jobs:
                if gidx not in results:
                    results[gidx] = (False, GroupUnavailable(
                        f"group {gidx} timed out after "
                        f"{_fed_timeout():.1f} s"))
            return dict(results)

    # -- ingest ---------------------------------------------------------------

    def _route_entities(self, kind: str, name: str, dataset_id: str,
                        entities: List[dict], pmap: PartitionMap):
        """Partition a batch by owner group; surfaces frozen ranges."""
        ds_owner = self.groups[0].workload(kind, name)
        datasource = ds_owner.datasources.get(dataset_id)
        if datasource is None:
            raise UnknownFederatedWorkload(f"{kind}/{name}/{dataset_id}")
        ranges = pmap.ranges()
        per_group: Dict[int, List[dict]] = {}
        frozen: List[str] = []
        touched: Dict[int, List[str]] = {}
        for entity in entities:
            rid = datasource.record_id_for_entity(entity)
            key = route_key(rid)
            owner = next(r for r in ranges if r.contains(key))
            if owner.frozen:
                if owner.range_id not in frozen:
                    frozen.append(owner.range_id)
                continue
            if self.heat is not None:
                # counts every routing pass: a record re-routed after a
                # live migration is noted once per attempt -- rare, and
                # irrelevant to where the hot band sits
                self.heat.note(owner, key)
            per_group.setdefault(owner.group, []).append(entity)
            group_touched = touched.setdefault(owner.group, [])
            if owner.range_id not in group_touched:
                group_touched.append(owner.range_id)
        return per_group, frozen, touched

    @staticmethod
    def _group_outcome(ok: bool, err, attempts: int) -> str:
        """The fed.group span / per-range outcome vocabulary."""
        if ok:
            return "retried" if attempts > 1 else "ok"
        if isinstance(err, StaleRouterEpoch):
            return "stale-epoch"
        return "degraded"

    def _ingest_job(self, gidx: int, kind: str, name: str, dataset_id: str,
                    sub: List[dict], epoch: int, ctx: Optional[dict],
                    cell: list) -> Callable:
        """One scatter job that times itself into ``cell`` =
        ``[start_ns, end_ns, attempts, wire]`` -- plain list writes from
        the scatter thread, read by the router thread only after the
        scatter joins (or defaulted on timeout)."""
        group = self.groups[gidx]

        def call():
            cell[2] += 1
            return group.ingest(kind, name, dataset_id, sub, epoch=epoch,
                                trace_ctx=ctx)

        def job():
            cell[0] = time.monotonic_ns()
            try:
                cell[3] = self._call_group(group, call) or b""
                return True
            finally:
                cell[1] = time.monotonic_ns()

        return job

    def _trace_scatter(self, results: Dict[int, tuple], meta: Dict[int, list],
                       ranges_by_group: Dict[int, List[str]]) -> None:
        """Per-group ``fed.group`` spans + remote-tree grafts, emitted in
        the ROUTER thread (the scatter threads have no trace context),
        and the per-range request/latency accounting.  No-cost without
        an active trace except the range bookkeeping."""
        now_ns = time.monotonic_ns()
        for gidx, (ok, value) in results.items():
            start_ns, end_ns, attempts, wire = meta[gidx]
            start_ns = start_ns or now_ns
            end_ns = end_ns or now_ns  # timed out: thread still running
            outcome = self._group_outcome(ok, value, attempts)
            owned = ranges_by_group.get(gidx, [])
            tracing.add_span("fed.group", start_ns, end_ns, {
                "group": gidx, "ranges": owned, "outcome": outcome,
                "attempts": attempts})
            if ok:
                tracing.graft_remote(wire)
            self._note_range(owned, outcome,
                             max(0.0, (end_ns - start_ns) / 1e9))

    def submit(self, kind: str, name: str, dataset_id: str,
               entities: List[dict]) -> dict:
        """Scatter one ingest batch to the owning groups.  Raises
        FrozenRange (whole batch, 429), PartialIngestFailure (503 with
        degraded ranges + max Retry-After), UnknownFederatedWorkload, or
        StaleRouterEpoch (after one map refresh + re-route attempt)."""
        for attempt in ("route", "re-route"):
            pmap = self._map_provider()
            epoch = pmap.epoch
            with tracing.span("fed.partition", {"attempt": attempt,
                                                "entities": len(entities)}):
                per_group, frozen, touched = self._route_entities(
                    kind, name, dataset_id, entities, pmap)
            if frozen:
                self._count_outcome("frozen")
                raise FrozenRange(
                    frozen, retry_after=DEFAULT_FED_RETRY_AFTER_S)
            # [start_ns, end_ns, attempts, wire] per scatter job
            meta = {gidx: [0, 0, 0, b""] for gidx in per_group}
            with tracing.span("fed.fanout", {"groups": len(per_group),
                                             "attempt": attempt}):
                ctx = tracing.propagation_context()
                jobs = {
                    gidx: self._ingest_job(gidx, kind, name, dataset_id,
                                           sub, epoch, ctx, meta[gidx])
                    for gidx, sub in per_group.items()
                }
                results = self._scatter(jobs)
                self._trace_scatter(results, meta, touched)
            if any(not ok and isinstance(err, StaleRouterEpoch)
                   for ok, err in results.values()) and attempt == "route":
                # our map raced a freeze/cutover: refresh and re-route
                # ONCE -- the sub-batches that landed are idempotent under
                # the resend
                logger.warning("stale router epoch during scatter; "
                               "refreshing the partition map and "
                               "re-routing")
                continue
            break
        with tracing.span("fed.merge", {"groups": len(per_group)}):
            failures = {g: err for g, (ok, err) in results.items() if not ok}
            # a stale-epoch refusal is FENCING, not group ill-health: the
            # group is alive and did its job -- never mark it failed (its
            # ranges must not surface as degraded) and surface the stale
            # signal itself so the plane answers the retry-shortly 503
            # instead of a bogus group-unavailable
            stale = [e for e in failures.values()
                     if isinstance(e, StaleRouterEpoch)]
            genuine = {g: e for g, e in failures.items()
                       if not isinstance(e, StaleRouterEpoch)}
            for gidx in per_group:
                self._mark(gidx, genuine.get(gidx))
            if not failures:
                self._count_outcome("ok")
                return {"success": True, "groups": len(per_group)}
            self._count_outcome("degraded")
            if not genuine:
                # every failure was fencing: topology moved twice during
                # this submit -- nothing landed for those sub-batches, the
                # client retries against the settled map
                raise stale[0]
            pmap = self._map_provider()
            degraded: List[str] = []
            for gidx in genuine:
                degraded.extend(r.range_id for r in pmap.group_ranges(gidx))
            retry_after = max(
                [getattr(e, "retry_after", DEFAULT_FED_RETRY_AFTER_S)
                 for e in genuine.values()] + [DEFAULT_FED_RETRY_AFTER_S])
            raise PartialIngestFailure(
                sorted(set(degraded)), retry_after,
                {g: repr(e) for g, e in genuine.items()})

    # -- federated feed -------------------------------------------------------

    def feed_page(self, kind: str, name: str, token: str,
                  limit: int) -> dict:
        """One merged feed page: scatter a bounded walk to every group,
        filter each row by CURRENT range ownership (the one-place dedup
        rule -- a stale copy at a range's old owner can never be emitted
        twice), advance per-range cursors, and merge by timestamp.

        Returns ``{rows, next_since, drained, degraded_ranges,
        retry_after}`` -- a dead group contributes no rows and leaves its
        ranges' cursors untouched (the client resumes them loss-free
        later), while every live group's links keep flowing."""
        # validate the workload exists anywhere before touching cursors
        self.groups[0].workload(kind, name)
        pmap = self._map_provider()
        ranges = pmap.ranges()
        positions = decode_cursor(token)
        legacy = positions.get("*")

        def pos_for(range_id: str) -> int:
            if legacy is not None:
                return max(int(legacy), int(positions.get(range_id, 0)))
            return int(positions.get(range_id, 0))

        by_group: Dict[int, List[Range]] = {}
        for r in ranges:
            by_group.setdefault(r.group, []).append(r)

        def walk(gidx: int, owned: List[Range], ctx: Optional[dict],
                 cell: list):
            group = self.groups[gidx]
            cursor_floor = min(pos_for(r.range_id) for r in owned)
            emitted: List[tuple] = []
            pos = cursor_floor
            drained = False
            cell[0] = time.monotonic_ns()
            try:
                while len(emitted) < limit:
                    rows, drained, wire = self._call_group(
                        group, group.links_walk, kind, name, pos, limit,
                        ctx)
                    cell[2] += 1
                    if wire:
                        cell[3].append(wire)
                    for id1, ts, row in rows:
                        pos = ts
                        key = route_key(id1)
                        owner = next(r for r in ranges if r.contains(key))
                        if owner.group != gidx:
                            continue  # stale copy at the range's old owner
                        if ts <= pos_for(owner.range_id):
                            continue  # consumed before the range moved here
                        emitted.append((ts, owner.range_id, row))
                    if drained:
                        break
            finally:
                cell[1] = time.monotonic_ns()
            return emitted, pos, drained

        # [start_ns, end_ns, pages, wires] per scatter job
        meta = {gidx: [0, 0, 0, []] for gidx in by_group}
        with tracing.span("fed.fanout", {"groups": len(by_group),
                                         "op": "feed"}):
            ctx = tracing.propagation_context()
            jobs = {
                gidx: (lambda g=gidx, owned=owned:
                       walk(g, owned, ctx, meta[g]))
                for gidx, owned in by_group.items()
            }
            results = self._scatter(jobs)
            now_ns = time.monotonic_ns()
            for gidx, (ok, value) in results.items():
                start_ns, end_ns, pages, wires = meta[gidx]
                tracing.add_span("fed.group", start_ns or now_ns,
                                 end_ns or now_ns, {
                                     "group": gidx,
                                     "ranges": [r.range_id
                                                for r in by_group[gidx]],
                                     "outcome": self._group_outcome(
                                         ok, value, 1),
                                     "pages": pages, "op": "feed"})
                for wire in wires:  # pages that landed before a failure
                    tracing.graft_remote(wire)
        with tracing.span("fed.merge", {"groups": len(by_group)}):
            merged: List[tuple] = []
            new_positions: Dict[str, int] = {
                r.range_id: pos_for(r.range_id) for r in ranges}
            degraded: List[str] = []
            retry_hints: List[int] = []
            all_drained = True
            for gidx, (ok, value) in results.items():
                owned = by_group[gidx]
                if not ok:
                    self._mark(gidx, value)
                    degraded.extend(r.range_id for r in owned)
                    retry_hints.append(
                        getattr(value, "retry_after",
                                DEFAULT_FED_RETRY_AFTER_S))
                    all_drained = False
                    continue
                self._mark(gidx, None)
                emitted, walked_to, drained = value
                merged.extend(emitted)
                all_drained = all_drained and drained
                # the group's stream is one timestamp-ordered walk:
                # having processed it to ``walked_to``, EVERY range it
                # owns is consumed to there
                for r in owned:
                    new_positions[r.range_id] = max(
                        new_positions[r.range_id], walked_to)
            merged.sort(key=lambda t: (t[0], t[2].get("_id", "")))
            if len(merged) > limit:
                # bound the MERGED page too (each group walked up to
                # ``limit`` on its own, so the concatenation can reach
                # n_groups × limit): keep a timestamp-tie-extended prefix
                # -- the same tie rule as ``get_changes_page``, since
                # per-range cursors are strictly-greater-than and a cut
                # mid-tie would skip the tied remainder on resume -- and
                # rebuild the cursors from the KEPT rows only (the walked
                # positions would skip every trimmed row)
                cut = limit
                boundary = merged[limit - 1][0]
                while cut < len(merged) and merged[cut][0] == boundary:
                    cut += 1
                merged = merged[:cut]
                all_drained = False
                new_positions = {
                    r.range_id: pos_for(r.range_id) for r in ranges}
                for ts, range_id, _row in merged:
                    new_positions[range_id] = max(
                        new_positions[range_id], ts)
            self._count_outcome("degraded" if degraded else "ok")
            return {
                "rows": [row for _, _, row in merged],
                "next_since": encode_cursor(pmap.version, new_positions),
                "drained": all_drained,
                "degraded_ranges": sorted(set(degraded)),
                "retry_after": max(retry_hints) if retry_hints else None,
            }
