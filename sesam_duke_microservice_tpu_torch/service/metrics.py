"""Per-app metric families and the workload-walking collector (the port's
share of the JAX package's ``service/metrics.py``).

Each ``DukeApp`` owns a ``MetricRegistry`` (``app.metrics``): the HTTP
families live as registry children written by the handler threads, while
everything the engine already tracks lock-free — ProfileStats,
PhaseRecorders, corpus sizes, link-store rows — is surfaced by a
scrape-time collector that walks the app's LIVE workload registries.
Walking at scrape time (instead of registering per-workload children)
means a hot config reload drops the replaced workloads' series
automatically and the scoring path never writes a registry child.

All collector reads are lock-free snapshots of single-writer state, the
same guarantee the /stats endpoint gives (engine/device_matcher.py
live_records): a scrape takes no workload lock and never syncs the card.
Every family has the JAX package's name, type and label keys; those whose
sources the port does not have yet (mesh, prewarm) are not emitted.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Tuple

import torch

from .. import __version__
from ..ops import encoder as _E
from ..telemetry import (
    DEFAULT_LATENCY_BUCKETS,
    FamilySnapshot,
    MetricRegistry,
)
from ..telemetry import memory as hbm

class HttpMetrics:
    """HTTP-layer families, bound to one app registry."""

    def __init__(self, registry: MetricRegistry):
        self.requests = registry.counter(
            "duke_http_requests_total",
            "HTTP requests by route template, method and status",
            ("route", "method", "status"),
        )
        self.latency = registry.histogram(
            "duke_http_request_seconds",
            "HTTP request wall time by route template and method",
            ("route", "method"),
            buckets=DEFAULT_LATENCY_BUCKETS,
        )
        self.in_flight = registry.gauge(
            "duke_http_requests_in_flight",
            "Requests currently being served",
        )
        self.request_bytes = registry.counter(
            "duke_http_request_bytes_total",
            "Request body bytes received, by route template",
            ("route",),
        )
        self.response_bytes = registry.counter(
            "duke_http_response_bytes_total",
            "Response body bytes sent (including streamed chunks), by "
            "route template",
            ("route",),
        )
        self.busy = registry.counter(
            "duke_http_busy_total",
            "503 busy responses (workload lock unavailable within the "
            "read timeout), by route template",
            ("route",),
        )


def backend_info(device) -> Tuple[str, int]:
    """(platform, device_count) of an app on torch ``device``:
    ``("cuda", torch.cuda.device_count())`` for a CUDA app, ``("cpu", 1)``
    for a CPU one and for the ``host`` backend (``device`` None).  Host
    reads only (the CUDA runtime caches the count)."""
    if device is not None and device.type == "cuda":
        return "cuda", torch.cuda.device_count()
    return "cpu", 1


def make_process_collector(device):
    """Scrape-time build-info + process gauges.

    ``duke_build_info`` carries the identifying labels (service version,
    torch version, backend platform) with a constant value of 1 — the
    Prometheus idiom for joinable build metadata; the process gauges
    read ``resource.getrusage`` / ``/proc`` at scrape time so nothing is
    maintained between scrapes."""
    import resource
    import sys

    def collect():
        labels = (
            ("version", __version__),
            ("torch", torch.__version__),
            ("platform", backend_info(device)[0]),
        )
        out = [FamilySnapshot(
            "duke_build_info", "gauge",
            "Build/runtime identity (value is always 1)",
            [("", labels, 1.0)],
        )]
        ru = resource.getrusage(resource.RUSAGE_SELF)
        # ru_maxrss is KiB on Linux, bytes on macOS
        rss = ru.ru_maxrss * (1 if sys.platform == "darwin" else 1024)
        out.append(FamilySnapshot(
            "duke_process_max_rss_bytes", "gauge",
            "Peak resident set size (resource.getrusage ru_maxrss)",
            [("", (), float(rss))],
        ))
        try:
            fds = len(os.listdir("/proc/self/fd"))
        except OSError:
            fds = None  # non-procfs platform: omit rather than lie
        if fds is not None:
            out.append(FamilySnapshot(
                "duke_process_open_fds", "gauge",
                "Open file descriptors", [("", (), float(fds))],
            ))
        out.append(FamilySnapshot(
            "duke_process_threads", "gauge",
            "Live Python threads (threading.active_count)",
            [("", (), float(threading.active_count()))],
        ))
        # digest-keyed feature cache (ops/feature_cache.py): scrape-time
        # snapshots of the cache's plain counters, so the encode hot path
        # never writes a registry child.  Emitted (at zero) even with the
        # cache disabled — dashboards keep their series across a
        # DUKE_FEATURE_CACHE_MB=0 rollback.
        from ..ops import feature_cache as FC

        hits, misses, evicted, cache_bytes = FC.stats()
        out.append(FamilySnapshot(
            "duke_encode_rows_total", "counter",
            "Feature-encode rows by outcome: served from the digest-keyed "
            "cache (hit), freshly extracted (miss), or evicted from the "
            "cache by the byte budget (evicted)",
            [("", (("outcome", "hit"),), float(hits)),
             ("", (("outcome", "miss"),), float(misses)),
             ("", (("outcome", "evicted"),), float(evicted))],
        ))
        out.append(FamilySnapshot(
            "duke_feature_cache_bytes", "gauge",
            "Bytes held by the digest-keyed feature cache "
            "(DUKE_FEATURE_CACHE_MB bounds this)",
            [("", (), float(cache_bytes))],
        ))
        return out

    return collect


def _workload_iter(app):
    for kind, registry in (("deduplication", app.deduplications),
                           ("recordlinkage", app.record_linkages)):
        for name, wl in list(registry.items()):
            yield kind, name, wl


def make_app_collector(app):
    """Scrape-time collector over ``app``'s live workloads."""

    def collect():
        uptime = [("", (), time.monotonic() - app.started_monotonic)]
        platform, devices = backend_info(app.device)
        info = [("", (
            ("backend", app.backend), ("platform", platform),
            ("devices", str(devices)),
        ), 1.0)]

        phase_samples = []
        counter_samples: Dict[str, list] = {
            "batches": [], "records": [], "candidates": [], "pairs": [],
        }
        rows_samples = []
        capacity_samples = []
        shard_samples = []
        mesh_dd_gather_samples = []
        mesh_dd_row_samples = []
        emb_samples = []
        ivf_cell_samples = []
        ivf_probe_samples = []
        link_samples = []
        journal_batch_samples = []
        journal_byte_samples = []
        queue_samples = []
        hold_samples = []
        finalize_samples = []
        finalize_threads = []
        dd_residue_samples = []
        decision_samples = []
        disagreement_samples = []
        pair_logit_samples = []
        margin_slack_samples = []
        similarity_samples = []
        cost_samples = []
        hbm_samples = []
        for kind, name, wl in _workload_iter(app):
            labels = (("kind", kind), ("workload", name))
            proc = wl.processor
            phases = getattr(proc, "phases", None)
            if phases is not None:
                phase_samples.extend(phases.collect_samples(labels))
                # device-time attribution: the same
                # PhaseRecorder totals, flattened to per-phase counters
                # that reconcile against duke_cost_busy_seconds_total
                for phase, seconds in sorted(
                        phases.phase_seconds().items()):
                    cost_samples.append(
                        ("", labels + (("phase", phase),), seconds))
            # device-byte attribution: this workload's registered
            # device-buffer components from the process-wide ledger
            for comp, nbytes in sorted(hbm.components_for(wl).items()):
                hbm_samples.append(
                    ("", labels + (("component", comp),), nbytes))
            stats = getattr(proc, "stats", None)
            if stats is not None:
                counter_samples["batches"].append(
                    ("", labels, stats.batches))
                counter_samples["records"].append(
                    ("", labels, stats.records_processed))
                counter_samples["candidates"].append(
                    ("", labels, stats.candidates_retrieved))
                counter_samples["pairs"].append(
                    ("", labels, stats.pairs_compared))
            recorder = getattr(proc, "decisions", None)
            if recorder is not None and recorder.enabled:
                # quality-drift monitors: single-writer engine-side
                # state, snapshotted here at scrape time -- the decision
                # path never writes a registry child
                for outcome, value in recorder.outcomes.items():
                    decision_samples.append(
                        ("", labels + (("outcome", outcome),), value))
                disagreement_samples.append(
                    ("", labels, recorder.disagreements))
                pair_logit_samples.extend(
                    recorder.pair_logit_hist.samples(labels))
                margin_slack_samples.extend(
                    recorder.margin_slack_hist.samples(labels))
                for prop, hist in list(recorder.similarity_hists.items()):
                    similarity_samples.extend(
                        hist.samples(labels + (("property", prop),)))
            finalizer = getattr(proc, "finalizer", None)
            if finalizer is not None and stats is not None:
                # finalization split: survivors rescored host-exact vs
                # skipped by the decisive band vs certified-rejected on
                # device by the dd rescore (engine.finalize)
                finalize_samples.append((
                    "", labels + (("outcome", "rescored"),),
                    stats.pairs_rescored))
                finalize_samples.append((
                    "", labels + (("outcome", "skipped"),),
                    stats.pairs_skipped))
                finalize_samples.append((
                    "", labels + (("outcome", "device_certified"),),
                    stats.pairs_device_certified))
                finalize_threads.append(("", labels, finalizer.threads))
                # why rescored pairs could not be device-certified
                dd_residue_samples.append((
                    "", labels + (("reason", "margin"),),
                    stats.dd_residue_margin))
                dd_residue_samples.append((
                    "", labels + (("reason", "kind"),),
                    stats.dd_residue_kind))
                dd_residue_samples.append((
                    "", labels + (("reason", "truncation"),),
                    stats.dd_residue_truncation))
            live = getattr(wl.index, "live_records", None)
            indexed = None
            corpus = getattr(wl.index, "corpus", None)
            if corpus is not None:
                indexed = corpus.size
                capacity_samples.append(("", labels, corpus.capacity))
                mesh = getattr(corpus, "mesh", None)
                if mesh is not None:
                    # record-axis split corpus: each shard's slice of the
                    # capacity (the device-memory figure the split bounds)
                    shard_samples.append(
                        ("", labels, corpus.capacity // mesh.size))
                    # the mesh cache's single-writer plain-int counters,
                    # snapshotted here (the scoring path never writes a
                    # registry child)
                    cache = wl.index.scorer_cache
                    mesh_dd_gather_samples.append(
                        ("", labels, float(getattr(cache, "_dd_gathers", 0))))
                    mesh_dd_row_samples.append(
                        ("", labels,
                         float(getattr(cache, "_dd_gather_rows", 0))))
                # ANN embedding footprint: host-mirror bytes of the
                # embedding tree (the JAX package's definition; the card
                # holds the same bf16 / int8 widths), so the int8 win is
                # scrape-visible
                emb_tree = corpus.feats.get(_E.ANN_PROP)
                if emb_tree is not None:
                    emb_samples.append(("", labels, float(sum(
                        arr.nbytes for arr in emb_tree.values()
                    ))))
            else:
                try:
                    indexed = len(wl.index)
                except TypeError:
                    pass
            ivf = getattr(wl.index, "ivf", None)
            if ivf is not None:
                # DUKE_IVF state (0 cells = enabled but still untrained
                # below DUKE_IVF_MIN_ROWS)
                ivf_cell_samples.append(("", labels, float(ivf.ncells)))
                ivf_probe_samples.append(("", labels, float(ivf.nprobe0)))
            if indexed is not None:
                rows_samples.append(
                    ("", labels + (("state", "indexed"),), indexed))
            rows_samples.append((
                "", labels + (("state", "live"),),
                live if live is not None else (indexed or 0),
            ))
            try:
                link_samples.append(("", labels, wl.link_database.count()))
            except Exception:
                pass  # a closed/raced link DB must never fail the scrape
            # durable link journal: lock-free snapshots of the
            # journal's plain int mirrors — pending (journaled, not yet
            # applied to the durable store) batches and file bytes.  A
            # pending count that grows without draining is the flusher
            # falling behind; bytes that never compact mean the
            # watermark stopped advancing.
            journal = getattr(wl.link_database, "journal", None)
            if journal is not None:
                journal_batch_samples.append(
                    ("", labels, float(journal.pending_batches)))
                journal_byte_samples.append(
                    ("", labels, float(journal.size_bytes)))
            queue_samples.append(("", labels, len(wl._mb_queue)))
            if wl._hold_ewma is not None:
                hold_samples.append(("", labels, wl._hold_ewma))

        # ingest-scheduler families: scrape-time snapshots of
        # the scheduler's single-writer tenant-queue counters — the
        # dispatch path never writes a registry child, and queues for
        # reloaded-away workloads age out with their traffic
        sched_depth = []
        sched_records = []
        sched_admission = []
        sched_batches = []
        sched_merged = []
        sched_wait = []
        sched_fill = []
        sched_throttled = []
        scheduler = getattr(app, "scheduler", None)
        if scheduler is not None:
            for q in scheduler.queues():
                labels = (("kind", q.kind), ("workload", q.name))
                sched_depth.append(("", labels, len(q.pending)))
                sched_records.append(("", labels, q.queued_records()))
                sched_admission.append(
                    ("", labels + (("outcome", "admitted"),), q.admitted))
                sched_admission.append(
                    ("", labels + (("outcome", "rejected"),), q.rejected))
                sched_batches.append(("", labels, q.microbatches))
                sched_merged.append(("", labels, q.merged_requests))
                sched_wait.extend(q.wait_hist.samples(labels))
                sched_fill.extend(q.fill_hist.samples(labels))
                sched_throttled.append(("", labels, float(q.throttled)))

        out = [
            FamilySnapshot("duke_uptime_seconds", "gauge",
                           "Seconds since this DukeApp was constructed",
                           uptime),
            FamilySnapshot("duke_backend_info", "gauge",
                           "Serving backend info (value is always 1)",
                           info),
            FamilySnapshot(
                "duke_engine_phase_seconds", "histogram",
                "Per-batch engine phase durations (encode, retrieve, "
                "score, persist) by workload", phase_samples),
            FamilySnapshot("duke_engine_batches_total", "counter",
                           "Batches processed", counter_samples["batches"]),
            FamilySnapshot("duke_engine_records_processed_total", "counter",
                           "Records matched", counter_samples["records"]),
            FamilySnapshot(
                "duke_engine_candidates_retrieved_total", "counter",
                "Candidates retrieved", counter_samples["candidates"]),
            FamilySnapshot("duke_engine_pairs_compared_total", "counter",
                           "Record pairs scored", counter_samples["pairs"]),
            FamilySnapshot("duke_corpus_rows", "gauge",
                           "Corpus rows by state (indexed includes "
                           "tombstones; live excludes them)", rows_samples),
            FamilySnapshot("duke_ingest_queue_depth", "gauge",
                           "Queued ingest requests awaiting the merged "
                           "device batch", queue_samples),
            FamilySnapshot("duke_links_rows", "gauge",
                           "Rows in the workload's link store",
                           link_samples),
            FamilySnapshot("duke_write_hold_seconds", "gauge",
                           "EWMA of recent write-side workload lock holds "
                           "(the Retry-After hint source; absent until the "
                           "first write)", hold_samples),
            FamilySnapshot(
                "duke_cost_device_seconds_total", "counter",
                "Attributed host busy seconds by workload and engine "
                "phase (host clock); sums to duke_cost_busy_seconds_total "
                "(the ledger reconciliation invariant)", cost_samples),
        ]
        if hbm_samples:
            out.append(FamilySnapshot(
                "duke_device_bytes", "gauge",
                "Registered device-buffer bytes by workload and component "
                "(corpus tensors, embeddings, int8 scales, IVF "
                "membership)", hbm_samples))
        if scheduler is not None:
            out.append(FamilySnapshot(
                "duke_sched_queue_depth", "gauge",
                "Requests pending in the ingest-scheduler queue",
                sched_depth))
            out.append(FamilySnapshot(
                "duke_sched_queue_records", "gauge",
                "Records pending in the ingest-scheduler queue",
                sched_records))
            out.append(FamilySnapshot(
                "duke_sched_admission_total", "counter",
                "Ingest requests admitted to vs rejected (429) by the "
                "scheduler's DUKE_SCHED_QUEUE_MAX bound", sched_admission))
            out.append(FamilySnapshot(
                "duke_sched_microbatches_total", "counter",
                "Coalesced microbatches dispatched to the engine",
                sched_batches))
            out.append(FamilySnapshot(
                "duke_sched_merged_requests_total", "counter",
                "Ingest requests completed through dispatched microbatches",
                sched_merged))
            out.append(FamilySnapshot(
                "duke_sched_wait_seconds", "histogram",
                "Queue wait from request enqueue to microbatch dispatch",
                sched_wait))
            out.append(FamilySnapshot(
                "duke_sched_microbatch_records", "histogram",
                "Records per dispatched microbatch (coalesced fill toward "
                "the query-padding buckets)", sched_fill))
            out.append(FamilySnapshot(
                "duke_tenant_throttled_total", "counter",
                "DRR rounds where the tenant's head request exceeded its "
                "accumulated deficit (quota throttling: delayed to later "
                "rounds, never starved — the DUKE_TENANT_MIN_SHARE floor "
                "keeps earning)", sched_throttled))
        with app._feed_abort_lock:
            abort_counts = dict(app.feed_aborts)
        out.append(FamilySnapshot(
            "duke_feed_aborts_total", "counter",
            "Feed streams aborted mid-response (chunked framing truncated) "
            "by reason: the mid-stream lock-backoff wall-clock deadline "
            "(DUKE_FEED_RETRY_DEADLINE), or workload removal by config "
            "reload (lock_starved is the pre-deadline series, kept for "
            "continuity)",
            [("", (("reason", reason),), float(count))
             for reason, count in sorted(abort_counts.items())],
        ))
        if journal_batch_samples:
            out.append(FamilySnapshot(
                "duke_journal_batches", "gauge",
                "Journaled link batches not yet applied to the durable "
                "store (the crash-recovery replay set if the process "
                "died now)", journal_batch_samples))
            out.append(FamilySnapshot(
                "duke_journal_bytes", "gauge",
                "Bytes in the append-only link journal (compacts to 0 "
                "once the applied watermark catches the head)",
                journal_byte_samples))
        if capacity_samples:
            out.append(FamilySnapshot(
                "duke_corpus_capacity_rows", "gauge",
                "Pre-allocated device corpus capacity", capacity_samples))
        if shard_samples:
            out.append(FamilySnapshot(
                "duke_corpus_capacity_rows_per_shard", "gauge",
                "Per-shard slice of the corpus capacity (sharded "
                "backends)", shard_samples))
        if mesh_dd_gather_samples:
            out.append(FamilySnapshot(
                "duke_mesh_dd_gathers_total", "counter",
                "Replicated dd survivor gathers run on the mesh — the "
                "collective that lets a fully-addressable sharded "
                "backend certify finalize verdicts on device",
                mesh_dd_gather_samples))
            out.append(FamilySnapshot(
                "duke_mesh_dd_gather_rows_total", "counter",
                "Survivor rows moved by dd gathers (queries x top_k "
                "per gather)", mesh_dd_row_samples))
        if emb_samples:
            out.append(FamilySnapshot(
                "duke_emb_bytes", "gauge",
                "Bytes of the ANN embedding tree (codes + int8 scale "
                "vector when DUKE_EMB_INT8) resident per corpus row set",
                emb_samples))
        if ivf_cell_samples:
            out.append(FamilySnapshot(
                "duke_ivf_cells", "gauge",
                "Trained IVF k-means cells (0 = DUKE_IVF on but below "
                "DUKE_IVF_MIN_ROWS, flat scan serving)", ivf_cell_samples))
            out.append(FamilySnapshot(
                "duke_ivf_probe_cells", "gauge",
                "Cells probed per query at the initial candidate width "
                "(escalation widens this in lockstep with top-C)",
                ivf_probe_samples))
        if finalize_samples:
            out.append(FamilySnapshot(
                "duke_finalize_pairs_total", "counter",
                "Device-scored survivors by finalization outcome: "
                "rescored host-exact, skipped by decisive-band pruning, "
                "or certified-rejected on device by the dd rescore",
                finalize_samples))
            out.append(FamilySnapshot(
                "duke_finalize_threads", "gauge",
                "Worker threads in the host-finalization pool "
                "(DUKE_FINALIZE_THREADS)", finalize_threads))
            out.append(FamilySnapshot(
                "duke_dd_residue_total", "counter",
                "Host-rescored survivors the dd rescore could not "
                "certify, by reason: ambiguous margin band, "
                "uncertifiable property kind, or an unsafe pair "
                "(tensor truncation / JW branch-boundary guard)",
                dd_residue_samples))
        if decision_samples:
            out.append(FamilySnapshot(
                "duke_decisions_total", "counter",
                "Match decisions by outcome (match, maybe, reject, "
                "pruned by the decisive band, or device_certified by "
                "the dd rescore)", decision_samples))
            out.append(FamilySnapshot(
                "duke_decision_disagreements_total", "counter",
                "Decisions where the float32 device verdict crossed a "
                "threshold the exact f64 rescore did not (or vice versa)",
                disagreement_samples))
            out.append(FamilySnapshot(
                "duke_pair_logit", "histogram",
                "Distribution of finalized pair logits (log-odds of the "
                "emitted f64 probability)", pair_logit_samples))
            out.append(FamilySnapshot(
                "duke_decisive_margin_slack", "histogram",
                "Slack below the decisive-band prune bound for skipped "
                "survivors (logit units; small slack = near-threshold "
                "skip)", margin_slack_samples))
            if similarity_samples:
                out.append(FamilySnapshot(
                    "duke_property_similarity", "histogram",
                    "Per-property comparator similarity of sampled "
                    "decisions (best value pair)", similarity_samples))
        return out

    return collect


def make_group_collector(group):
    """Scrape-time collector over one federation group's live workloads
   .

    Each group gets its own ``MetricRegistry`` carrying only this
    collector; the federation plane merges all of them through
    ``telemetry.rollup.GroupRollup`` -- counters and histograms summed
    key-wise across groups (lossless: every group shares the family's
    bucket ladder), gauges relabeled with ``group=``.  The collector
    therefore emits the SAME family names the leader app does, so fleet
    dashboards reuse replica queries unchanged.

    Reads are the same lock-free single-writer snapshots the app
    collector takes; nothing here acquires a workload or group lock, so
    a scrape can never stall an ingest (or another group's scrape).
    """

    def collect():
        counter_samples: Dict[str, list] = {
            "batches": [], "records": [], "candidates": [], "pairs": [],
        }
        phase_samples = []
        rows_samples = []
        link_samples = []
        queue_samples = []
        hold_samples = []
        cost_samples = []
        hbm_samples = []
        for (kind, name), wl in list(group.workloads.items()):
            labels = (("kind", kind), ("workload", name))
            proc = wl.processor
            phases = getattr(proc, "phases", None)
            if phases is not None:
                phase_samples.extend(phases.collect_samples(labels))
                for phase, seconds in sorted(
                        phases.phase_seconds().items()):
                    cost_samples.append(
                        ("", labels + (("phase", phase),), seconds))
            for comp, nbytes in sorted(hbm.components_for(wl).items()):
                hbm_samples.append(
                    ("", labels + (("component", comp),), nbytes))
            stats = getattr(proc, "stats", None)
            if stats is not None:
                counter_samples["batches"].append(
                    ("", labels, stats.batches))
                counter_samples["records"].append(
                    ("", labels, stats.records_processed))
                counter_samples["candidates"].append(
                    ("", labels, stats.candidates_retrieved))
                counter_samples["pairs"].append(
                    ("", labels, stats.pairs_compared))
            live = getattr(wl.index, "live_records", None)
            indexed = None
            corpus = getattr(wl.index, "corpus", None)
            if corpus is not None:
                indexed = corpus.size
            else:
                try:
                    indexed = len(wl.index)
                except TypeError:
                    pass
            if indexed is not None:
                rows_samples.append(
                    ("", labels + (("state", "indexed"),), indexed))
            rows_samples.append((
                "", labels + (("state", "live"),),
                live if live is not None else (indexed or 0),
            ))
            try:
                link_samples.append(("", labels, wl.link_database.count()))
            except Exception:
                pass  # a closed/raced link DB must never fail the scrape
            queue_samples.append(("", labels, len(wl._mb_queue)))
            if wl._hold_ewma is not None:
                hold_samples.append(("", labels, wl._hold_ewma))
        return [
            FamilySnapshot(
                "duke_engine_phase_seconds", "histogram",
                "Per-batch engine phase durations (encode, retrieve, "
                "score, persist) by workload", phase_samples),
            FamilySnapshot("duke_engine_batches_total", "counter",
                           "Batches processed", counter_samples["batches"]),
            FamilySnapshot("duke_engine_records_processed_total", "counter",
                           "Records matched", counter_samples["records"]),
            FamilySnapshot(
                "duke_engine_candidates_retrieved_total", "counter",
                "Candidates retrieved", counter_samples["candidates"]),
            FamilySnapshot("duke_engine_pairs_compared_total", "counter",
                           "Record pairs scored", counter_samples["pairs"]),
            FamilySnapshot("duke_corpus_rows", "gauge",
                           "Corpus rows by state (indexed includes "
                           "tombstones; live excludes them)", rows_samples),
            FamilySnapshot("duke_links_rows", "gauge",
                           "Rows in the workload's link store",
                           link_samples),
            FamilySnapshot("duke_ingest_queue_depth", "gauge",
                           "Queued ingest requests awaiting the merged "
                           "device batch", queue_samples),
            FamilySnapshot("duke_write_hold_seconds", "gauge",
                           "EWMA of recent write-side workload lock holds "
                           "(the Retry-After hint source; absent until the "
                           "first write)", hold_samples),
            FamilySnapshot(
                "duke_cost_device_seconds_total", "counter",
                "Attributed host busy seconds by workload and engine "
                "phase (host clock); sums to duke_cost_busy_seconds_total "
                "(the ledger reconciliation invariant)", cost_samples),
            FamilySnapshot(
                "duke_device_bytes", "gauge",
                "Registered device-buffer bytes by workload and component "
                "(corpus tensors, embeddings, int8 scales, IVF "
                "membership)", hbm_samples),
        ]

    return collect
