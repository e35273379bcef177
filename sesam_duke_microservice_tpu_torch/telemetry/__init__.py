"""Telemetry: metrics registry, Prometheus exposition, request ids.

The port's share of the JAX package's ``telemetry/__init__.py``.  Two
registries exist at runtime:

  * ``GLOBAL`` (here) -- process-wide instruments owned by layers that
    have no DukeApp in scope: corpus-growth, query-padding and escalation
    counters (engine/device_matcher.py), the fault, journal and recovery
    counters (utils/faults.py, links/), plus the scrape-time collectors of
    the SLO, cost and device-byte ledgers;
  * a per-``DukeApp`` registry (service/metrics.py) -- HTTP families and
    the workload-walking collector (engine phase histograms, corpus
    gauges, link-store rows).  Per-app so tests and hot reloads never
    leak series across app instances.

``GET /metrics`` renders both (``registry.render(app.metrics, GLOBAL)``).
Every family here has the JAX package's name, type and label keys, and
only families whose writer exists in the port are declared: the JIT /
AOT / prewarm families (XLA compile caches), the dispatch, follower,
epoch and replica families and the mesh families wait for the modules
that write them.

Naming scheme: every family is ``duke_<subsystem>_<metric>[_total]`` with
base units (seconds, bytes, rows); latency histograms share the fixed
log-scale ladder ``DEFAULT_LATENCY_BUCKETS``.
"""

from .registry import (  # noqa: F401
    CONTENT_TYPE,
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    FamilySnapshot,
    Gauge,
    Histogram,
    MetricRegistry,
    PhaseRecorder,
    add_render_hook,
    histogram_snapshot,
    render,
)

GLOBAL = MetricRegistry()

COLD_START_SECONDS = GLOBAL.gauge(
    "duke_cold_start_seconds",
    "Seconds from service construction to the first successfully served "
    "scoring batch (time-to-first-200; 0 until a batch lands)",
)

# -- device corpus growth (engine/device_matcher.py) -------------------------
# Process-wide (not per-corpus) so a corpus rebuild can never reset the
# series mid-scrape.
CORPUS_GROWTHS = GLOBAL.counter(
    "duke_corpus_capacity_growths_total",
    "Corpus capacity-doubling events (each forces a full device re-upload)",
)
CORPUS_FULL_UPLOADS = GLOBAL.counter(
    "duke_corpus_full_uploads_total",
    "Whole-corpus device uploads (growth, restore, or mask-refresh fallback)",
)

# -- query padding buckets (engine/device_matcher.py) ------------------------
# Unlocked: incremented once per dispatched block by the one thread that
# scores (the scheduler's dispatcher, or the lock winner); a rare lost
# count from two workloads' threads racing a child is accepted -- the
# scoring path takes no lock for metrics.
QUERY_BLOCKS = GLOBAL.counter(
    "duke_query_blocks_total",
    "Dispatched query blocks by padded bucket size",
    ("bucket",), locked=False,
)
QUERY_PAD_ROWS = GLOBAL.counter(
    "duke_query_padding_rows_total",
    "Padding rows added to reach the block's bucket size",
    ("bucket",), locked=False,
)
SCORER_ESCALATIONS = GLOBAL.counter(
    "duke_scorer_escalations_total",
    "K/C-escalation re-runs of the device scoring program",
)
# which retrieval stage saturated: brute-force top-K, flat-ANN top-C, or
# the IVF cell probe (ops/ivf.py, engine/ann_matcher.py)
RETRIEVAL_ESCALATIONS = GLOBAL.counter(
    "duke_retrieval_escalations_total",
    "Retrieval-width escalation re-runs by saturated stage "
    "(top_k = brute force, top_c = flat ANN, ivf = cell probe)",
    ("stage",),
)

# -- streamed append (engine/device_matcher.py) ------------------------------
# Unlocked: incremented by the one thread that runs a workload's batch
# (the QUERY_BLOCKS discipline).
STREAM_APPEND_SLICES = GLOBAL.counter(
    "duke_stream_append_slices_total",
    "Device-corpus append slices flushed under the extract/upload overlap "
    "(DUKE_STREAM_APPEND)",
    locked=False,
)

FAULTS_INJECTED = GLOBAL.counter(
    "duke_faults_injected_total",
    "Faults injected by the deterministic DUKE_FAULTS chaos layer, by "
    "kind",
    ("kind",),
)

# -- crash-consistent ingest (links/journal.py, links/write_behind.py) -------
# Written on startup/rare paths only; the journal's per-workload gauges
# (duke_journal_batches, duke_journal_bytes) are scrape-time snapshots in
# the app collector, so the append path never writes a registry child.
JOURNAL_TORN_TAILS = GLOBAL.counter(
    "duke_journal_torn_tails_total",
    "Torn or corrupt link-journal tails truncated by the startup scan "
    "(a crash mid-append; bounded to the final partial frame, logged, "
    "never fatal)",
)
RECOVERY_REPLAYED = GLOBAL.counter(
    "duke_recovery_replayed_total",
    "Journaled link batches replayed into the durable link store by "
    "startup recovery (batches a crash stranded between ack and flush)",
)
# recovery progress: while /readyz says `recovering`, these distinguish
# "almost done" from "wedged" -- remaining counts down chunk by chunk as
# the replay loop applies, applied counts up monotonically.
RECOVERY_REPLAY_REMAINING = GLOBAL.gauge(
    "duke_recovery_replay_remaining_batches",
    "Journaled link batches still awaiting replay by the running "
    "startup recovery (0 when recovery is idle or done)",
)
RECOVERY_REPLAY_APPLIED = GLOBAL.counter(
    "duke_recovery_replay_applied_total",
    "Journaled link batches applied by startup recovery replay loops "
    "since process start (advances chunk by chunk while /readyz still "
    "says recovering)",
)
SNAPSHOT_FALLBACKS = GLOBAL.counter(
    "duke_snapshot_fallbacks_total",
    "Corpus snapshots rejected into a full store replay, by reason "
    "(corrupt = unreadable archive, checksum = stamped content checksum "
    "mismatch, content = store drifted past the snapshot, schema = "
    "plan/tensor-shape mismatch, fingerprint = env/plan fingerprint "
    "mismatch)",
    ("reason",),
)

# -- mesh (engine/sharded_matcher.py) ----------------------------------------
MESH_DEVICES = GLOBAL.gauge(
    "duke_mesh_devices",
    "Devices in the serving mesh (0 until a sharded backend builds one)",
)

# -- runtime SLO signals, cost and device-byte ledgers -----------------------
# Imported last: each needs only .registry (and the package's env), and
# registering their scrape-time collectors here keeps every surface that
# renders GLOBAL serving the burn-rate, feed-lag, busy / utilization and
# device-byte families with no per-surface wiring.
from . import costs, memory, slo  # noqa: E402,F401

GLOBAL.register_collector(slo.collect)
GLOBAL.register_collector(costs.collect)
GLOBAL.register_collector(memory.collect)
