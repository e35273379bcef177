"""Background canary prober: ground-truth synthetic monitoring (the JAX
package's ``service/prober.py`` on torch: ``CanaryProber``, and the
federation plane's per-range ``RangeProber``).

``CanaryProber`` owns one shadow workload per user workload.  The
shadow is built from a clone of the user's ``WorkloadConfig`` that
shares the SAME ``Property`` objects (an identical feature plan, so the
shadow's kernels are the ones the process already built: a shadow build
runs no nvcc or g++) but renames the workload and every dataset id into
the reserved ``__probe__`` namespace and swaps the link database for an
in-memory one.  The shadow runs on the app's device and backend.
Shadows are registered only here -- the HTTP registries never see them
-- so user-visible feed and link rows are byte-identical with the
prober on or off.  Their corpus tensors are real, so they admit through
the device arena like any tenant; being tiny and cold they are never
the victims that starve a user tenant of its residency.

Each cycle stamps fresh entity ids onto the derived canary corpus
(telemetry.probes) and pushes them through the REAL path: the shared
``IngestScheduler`` admission (the prober is just another tenant),
device scoring, finalize, the link store, and the same
``links_feed_page`` materialization that serves ``?since=``.  Observed
verdicts are then checked against the host f64 oracle expectations;
any divergence latches into a ring, turns the ``/healthz`` detail
degraded, and records the offending trace/decision ids for
``GET /debug/probes``.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..core.config import DataSourceConfig, DukeSchema, WorkloadConfig
from ..engine.workload import build_workload
from ..links.base import LinkKind, LinkStatus
from ..telemetry import costs, probes, slo, tracing
from ..telemetry.env import env_int
from ..telemetry.probes import (PROBE_PREFIX, ProbeState, derive_canaries,
                                probe_interval_s, probe_name)
from ..telemetry.rings import LatchedRing
from ..utils import faults

logger = logging.getLogger(__name__)

_MISMATCH_SEQ = itertools.count(1)


def _probe_workload_config(wc: WorkloadConfig) -> WorkloadConfig:
    """Clone a user workload config into the probe namespace.

    Properties are shared BY REFERENCE, so the shadow's feature plan is
    the user workload's.  Dataset configs are cloned with namespaced ids
    (same objects reused between ``data_sources`` and ``groups``,
    mirroring the parser)."""
    # dataset ids are unique within a workload, so they key the clone
    # memo (the parser reuses DataSourceConfig objects between
    # data_sources and groups; the clones must alias the same way)
    memo: Dict[str, DataSourceConfig] = {}

    def clone(ds: DataSourceConfig) -> DataSourceConfig:
        got = memo.get(ds.dataset_id)
        if got is None:
            got = DataSourceConfig(
                dataset_id=PROBE_PREFIX + ds.dataset_id,
                columns=ds.columns,
                group_no=ds.group_no,
            )
            memo[ds.dataset_id] = got
        return got

    duke = wc.duke
    probe_duke = DukeSchema(
        threshold=duke.threshold,
        maybe_threshold=duke.maybe_threshold,
        properties=duke.properties,
        data_sources=[clone(ds) for ds in duke.data_sources],
        groups=[[clone(ds) for ds in grp] for grp in duke.groups],
    )
    return WorkloadConfig(
        name=probe_name(wc.name),
        kind=wc.kind,
        duke=probe_duke,
        link_database_type="in-memory",
        link_mode=wc.link_mode,
        data_folder=None,
    )


class _Shadow:
    """One user workload's probe state: shadow workload + corpus."""

    __slots__ = ("workload", "corpus", "state", "ds_a", "ds_b", "cycle",
                 "compiles_base")

    def __init__(self, workload, corpus, state, ds_a, ds_b, compiles_base):
        self.workload = workload
        self.corpus = corpus
        self.state = state
        self.ds_a = ds_a
        self.ds_b = ds_b
        self.cycle = 0
        self.compiles_base = compiles_base


class CanaryProber:
    """Per-app synthetic monitor (one background thread; ``run_cycle``
    is also directly callable, which is how tests drive it)."""

    def __init__(self, app):
        self.app = app
        self._shadows: Dict[Tuple[str, str], _Shadow] = {}
        # serializes cycles against shutdown and shadow rebuilds
        self._cycle_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ring = LatchedRing(max(1, env_int("DUKE_PROBE_RING", 64)))
        app.metrics.register_collector(self.collect)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="canary-prober", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=30)
            self._thread = None
        with self._cycle_lock:
            for entry in self._shadows.values():
                self._close_shadow(entry)
            self._shadows.clear()

    def _loop(self) -> None:
        while not self._stop.wait(probe_interval_s()):
            try:
                self.run_cycle()
            except Exception:  # the prober must never take the app down
                logger.exception("probe cycle crashed")

    @staticmethod
    def _close_shadow(entry: _Shadow) -> None:
        try:
            entry.workload.close(save_snapshot=False)
        except Exception:
            logger.exception("probe shadow close failed")

    # -- scheduler integration -----------------------------------------------

    def resolve(self, kind: str, name: str):
        """Resolve a ``__probe__``-namespaced workload name for the
        scheduler's dispatch (DukeApp._resolve_workload delegates probe
        names here); None when no shadow exists, like the registries."""
        user = name[len(PROBE_PREFIX):]
        entry = self._shadows.get((kind, user))
        return entry.workload if entry is not None else None

    # -- cycle ----------------------------------------------------------------

    def run_cycle(self) -> Dict[Tuple[str, str], dict]:
        """One synchronous probe pass over every user workload."""
        results: Dict[Tuple[str, str], dict] = {}
        with self._cycle_lock:
            if self._stop.is_set():
                return results
            for kind, registry in (
                ("deduplication", self.app.deduplications),
                ("recordlinkage", self.app.record_linkages),
            ):
                for name, user_wl in list(registry.items()):
                    try:
                        entry = self._ensure_shadow(kind, name, user_wl)
                    except Exception:
                        logger.exception(
                            "probe shadow build failed for %s/%s", kind, name)
                        st = self._state_for(kind, name)
                        st.cycles += 1
                        st.note_failure("build")
                        continue
                    results[(kind, name)] = self._cycle_one(kind, name, entry)
        return results

    def _state_for(self, kind: str, name: str) -> ProbeState:
        entry = self._shadows.get((kind, name))
        if entry is not None:
            return entry.state
        # build failures keep their accounting without a shadow
        st = getattr(self, "_orphan_states", None)
        if st is None:
            st = self._orphan_states = {}
        key = (kind, name)
        if key not in st:
            st[key] = ProbeState(kind, name)
        return st[key]

    def _ensure_shadow(self, kind: str, name: str, user_wl) -> _Shadow:
        entry = self._shadows.get((kind, name))
        if entry is not None:
            max_records = max(16, env_int("DUKE_PROBE_MAX_RECORDS", 512))
            if (entry.cycle + 1) * 2 * len(entry.corpus) <= max_records:
                return entry
            # bounded shadow corpus: rebuild from scratch (cheap -- the
            # kernels stay built) instead of growing forever
            self._close_shadow(entry)
            old_state = entry.state
        else:
            old_state = None

        pwc = _probe_workload_config(user_wl.config)
        sc = dataclasses.replace(
            self.app.config,
            # shadow corpora are tiny; retrieval relevance cutoffs tuned
            # for production-size corpora would starve the host index of
            # canary candidates and fake a scoring failure
            tunables=dataclasses.replace(
                self.app.config.tunables, min_relevance=0.0),
            threads=1,
        )
        compiles_base = costs.compile_count()
        wl = build_workload(pwc, sc, backend=self.app.backend,
                            device=self.app.device, persistent=False,
                            mesh=self._shadow_mesh())
        duke = pwc.duke
        if duke.groups:
            ds_a = wl.datasources[duke.groups[0][0].dataset_id]
            ds_b = wl.datasources[duke.groups[1][0].dataset_id]
        else:
            ds_a = ds_b = wl.datasources[duke.data_sources[0].dataset_id]
        corpus = derive_canaries(duke, ds_a, ds_b, wl.processor.compare)
        state = old_state if old_state is not None else ProbeState(kind, name)
        state.corpus_size = len(corpus)
        entry = _Shadow(wl, corpus, state, ds_a, ds_b, compiles_base)
        self._shadows[(kind, name)] = entry
        return entry

    def _shadow_mesh(self):
        """The mesh a shadow of a mesh backend scores on: the serving
        mesh, but on a mesh that spans processes only this process's
        shards as a mesh of one process -- a shadow is never on the op
        stream, so a collective of its own would wait for followers that
        never enter it.  None for the single-device backends."""
        if self.app.backend not in ("sharded", "sharded-brute"):
            return None
        from ..engine.sharded_matcher import serving_mesh

        return serving_mesh(self.app.device).local()

    def _cycle_one(self, kind: str, name: str, entry: _Shadow) -> dict:
        st = entry.state
        st.cycles += 1
        entry.cycle += 1
        cycle_no = entry.cycle
        pname = probe_name(name)
        summary: dict = {"cycle": cycle_no, "ok": False}

        pairs: List[tuple] = []  # (canary, record_id_a, record_id_b)
        batch_a: List[dict] = []
        batch_b: List[dict] = []
        for canary in entry.corpus:
            ea = dict(canary.values_a)
            ea["_id"] = f"{canary.key}-a-c{cycle_no}"
            eb = dict(canary.values_b)
            eb["_id"] = f"{canary.key}-b-c{cycle_no}"
            batch_a.append(ea)
            batch_b.append(eb)
            pairs.append((canary,
                          entry.ds_a.record_id_for_entity(ea),
                          entry.ds_b.record_id_for_entity(eb)))

        with tracing.start_trace(
            "probe.cycle",
            attributes={"kind": kind, "workload": name, "cycle": cycle_no},
        ) as root:
            summary["trace_id"] = root.trace_id
            t_start = time.monotonic()
            try:
                self._submit(kind, pname,
                             entry.ds_a.config.dataset_id, batch_a)
                if entry.ds_b is not entry.ds_a:
                    self._submit(kind, pname,
                                 entry.ds_b.config.dataset_id, batch_b)
                else:
                    self._submit(kind, pname,
                                 entry.ds_a.config.dataset_id, batch_b)
            except Exception as exc:
                st.note_failure("submit")
                summary["error"] = f"submit: {type(exc).__name__}: {exc}"
                st.stage_hists["ingest"].observe(time.monotonic() - t_start)
                self._finish_cycle(entry, summary)
                return summary
            t_ingest = time.monotonic()
            st.stage_hists["ingest"].observe(t_ingest - t_start)

            try:
                observed = self._observe_links(entry, pairs)
            except Exception as exc:
                st.note_failure("observe")
                summary["error"] = f"observe: {type(exc).__name__}: {exc}"
                self._finish_cycle(entry, summary)
                return summary
            t_score = time.monotonic()
            st.stage_hists["score"].observe(t_score - t_ingest)

            mismatches = self._check_verdicts(
                entry, pairs, observed, summary)

            feed_ok = True
            t_feed0 = time.monotonic()
            try:
                feed_ids = self._feed_ids(entry.workload)
            except Exception as exc:
                st.note_failure("feed")
                summary["error"] = f"feed: {type(exc).__name__}: {exc}"
                feed_ok = False
                feed_ids = set()
            st.stage_hists["feed"].observe(time.monotonic() - t_feed0)
            if feed_ok:
                for canary, id_a, id_b in pairs:
                    if canary.expected_verdict == "reject":
                        continue
                    ids = sorted((id_a, id_b))
                    row_id = f"{ids[0]}_{ids[1]}".replace(":", "_")
                    if row_id not in feed_ids:
                        st.note_failure("feed_missing")
                        feed_ok = False

            total_s = time.monotonic() - t_start
            summary["seconds"] = round(total_s, 6)
            summary["verdicts"] = {
                c.key: {"expected": c.expected_verdict,
                        "observed": observed.get(c.key)}
                for c, _, _ in pairs
            }
            summary["ok"] = feed_ok and not mismatches and "error" not in summary
            slo.tracker("probe", kind, name).record(
                total_s, trace_id=tracing.sampled_trace_id())

        if summary["ok"]:
            st.ok_cycles += 1
            st.last_ok_monotonic = time.monotonic()
        if entry.cycle == 1:
            st.probe_compiles = costs.compile_count() - entry.compiles_base
        self._finish_cycle(entry, summary)
        return summary

    def _finish_cycle(self, entry: _Shadow, summary: dict) -> None:
        summary["time_unix"] = round(time.time(), 3)
        entry.state.last = summary
        entry.state.history.append(summary)

    def _submit(self, kind: str, pname: str, dataset_id: str,
                entities: List[dict]) -> None:
        sched = getattr(self.app, "scheduler", None)
        if sched is not None:
            sched.submit(kind, pname, dataset_id, entities)
            return
        wl = self.resolve(kind, pname)
        if wl is None:
            raise KeyError(pname)
        wl.submit_batch(dataset_id, entities)

    def _observe_links(self, entry: _Shadow, pairs) -> Dict[str, str]:
        """Served verdict per canary from the shadow's link journal."""
        ids = {rid for _, a, b in pairs for rid in (a, b)}
        wl = entry.workload
        with wl.lock:
            links = wl.link_database.get_links_for_ids(ids)
        by_key = {}
        for link in links:
            if link.status == LinkStatus.RETRACTED:
                continue
            by_key[link.key()] = link
        out: Dict[str, str] = {}
        for canary, id_a, id_b in pairs:
            link = by_key.get(tuple(sorted((id_a, id_b))))
            if link is None:
                out[canary.key] = "reject"
            elif link.kind == LinkKind.MAYBE:
                out[canary.key] = "maybe"
            else:
                out[canary.key] = "match"
        return out

    def _check_verdicts(self, entry: _Shadow, pairs,
                        observed: Dict[str, str], summary: dict) -> int:
        st = entry.state
        mismatches = 0
        plan = faults.active()
        for canary, id_a, id_b in pairs:
            verdict = observed.get(canary.key, "reject")
            if plan is not None and plan.probe_flip():
                # fault drill: corrupt this canary's served verdict at
                # the readback seam, as a real finalize corruption would
                verdict = "match" if canary.expected_verdict != "match" \
                    else "reject"
                observed[canary.key] = verdict
            if verdict == canary.expected_verdict:
                continue
            mismatches += 1
            st.mismatches += 1
            record = {
                "id": f"m{next(_MISMATCH_SEQ):06d}",
                "time_unix": round(time.time(), 3),
                "kind": st.kind,
                "workload": st.name,
                "pair": canary.key,
                "id1": id_a,
                "id2": id_b,
                "expected": canary.expected_verdict,
                "expected_prob": canary.expected_prob,
                "observed": verdict,
                "trace_id": tracing.current_trace_id(),
                "decision_ids": self._decision_ids(
                    entry.workload, {id_a, id_b}),
            }
            self.ring.put(record["id"], record, remarkable=True)
            logger.error(
                "probe verdict mismatch %s/%s pair=%s expected=%s observed=%s",
                st.kind, st.name, canary.key, canary.expected_verdict,
                verdict)
        return mismatches

    @staticmethod
    def _decision_ids(wl, record_ids) -> List[str]:
        """Decision-ring entries touching the mismatching pair, for the
        /debug/probes -> /debug/decisions join."""
        ring = getattr(getattr(wl.processor, "decisions", None), "ring", None)
        if ring is None:
            return []
        out = []
        for rec in ring.records():
            if rec.get("query") in record_ids or \
                    rec.get("candidate") in record_ids:
                out.append(rec["id"])
            if len(out) >= 8:
                break
        return out

    @staticmethod
    def _feed_ids(wl) -> set:
        """Non-deleted row ids from a full ``?since=`` walk -- the same
        ``links_feed_page`` materialization HTTP serves."""
        out = set()
        since = 0
        while True:
            rows, nxt = wl.links_page(since, 500)
            if not rows:
                return out
            for row in rows:
                if not row.get("_deleted"):
                    out.add(row["_id"])
                else:
                    out.discard(row["_id"])
            since = nxt

    # -- read surfaces --------------------------------------------------------

    def states(self) -> List[ProbeState]:
        states = [e.state for e in self._shadows.values()]
        states.extend(getattr(self, "_orphan_states", {}).values())
        return states

    def collect(self):
        return probes.probe_families(self.states())

    def health_detail(self) -> Optional[dict]:
        per = {
            f"{st.kind}/{st.name}": st.mismatches
            for st in self.states() if st.mismatches
        }
        if not per:
            return None
        return {"verdict_mismatches": sum(per.values()), "workloads": per}

    def debug_snapshot(self) -> dict:
        mismatches = []
        for rec in self.ring.records():
            row = dict(rec)
            if row.get("trace_id"):
                row["trace"] = f"/debug/traces/{row['trace_id']}"
            row["decisions"] = [
                f"/debug/decisions/{d}" for d in row.get("decision_ids", [])]
            mismatches.append(row)
        return {
            "enabled": True,
            "interval_seconds": probe_interval_s(),
            "workloads": sorted(
                (st.snapshot() for st in self.states()),
                key=lambda s: (s["kind"], s["workload"]),
            ),
            "mismatches": mismatches,
        }


# -- federation range probing -------------------------------------------------

class RangeProber:
    """Black-box per-range reachability probe through the group read
    path.  A range whose owner group is down, busy, or mis-routed fails
    its probe -- surfaced per range on the federation plane before any
    consumer's ``?since=`` poll hits it."""

    def __init__(self, fed):
        self.fed = fed
        self._lock = threading.Lock()
        # guarded by: self._lock [writes]
        self._checks: Dict[str, Dict[str, int]] = {}
        self._groups: Dict[str, int] = {}
        self._errors: Dict[str, str] = {}
        self._cycles = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="range-prober", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=30)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(probe_interval_s()):
            try:
                self.run_cycle()
            except Exception:
                logger.exception("range probe cycle crashed")

    def run_cycle(self) -> Dict[str, str]:
        """Probe every owned range once; returns range_id -> outcome."""
        pmap = self.fed.map
        outcomes: Dict[str, str] = {}
        with self._lock:
            self._cycles += 1
        for rng in pmap.ranges():
            group = self.fed.groups[rng.group]
            workloads = sorted(group.workloads)
            if not workloads:
                continue
            kind, name = workloads[0]
            outcome, err = "ok", None
            try:
                group.links_walk(kind, name, 0, 1)
            except Exception as exc:
                outcome, err = "fail", type(exc).__name__
            outcomes[rng.range_id] = outcome
            with self._lock:
                per = self._checks.setdefault(rng.range_id, {})
                per[outcome] = per.get(outcome, 0) + 1
                self._groups[rng.range_id] = rng.group
                if err is not None:
                    self._errors[rng.range_id] = err
                else:
                    self._errors.pop(rng.range_id, None)
        return outcomes

    def collector_for(self, idx: int):
        """Scrape collector for ONE group's owned ranges -- registered on
        that group's rollup registry so GroupRollup merges the fleet
        view (telemetry.rollup) like every other per-group family."""
        def collect():
            with self._lock:
                checks = {
                    rid: dict(per) for rid, per in self._checks.items()
                    if self._groups.get(rid) == idx
                }
                groups = {rid: idx for rid in checks}
            if not checks:
                return []
            return [probes.range_probe_family(checks, groups)]
        return collect

    def failing_ranges(self) -> List[str]:
        with self._lock:
            return sorted(self._errors)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "interval_seconds": probe_interval_s(),
                "cycles": self._cycles,
                "ranges": {
                    rid: {
                        "group": self._groups.get(rid),
                        "checks": dict(per),
                        "last_error": self._errors.get(rid),
                    }
                    for rid, per in sorted(self._checks.items())
                },
            }
