#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build every ``csrc/*.cu`` with nvcc for sm_90a, one nvcc per source,
   all at once, and the C++ host library (``native/duke_native.cpp``)
   with g++ beside them (the build time is printed);
2. slice 1's main path: serve ``DukeApp(device="cuda")`` over HTTP, ingest
   131,072 stresstest records (Levenshtein / Numeric / Exact) in
   2,048-record POSTs, POST one 8,192-record query batch, ingest a second
   workload whose names run 33-120 chars (the 4-word Myers kernel), read
   both ``?since=0`` feeds; the Myers kernels must have launched.  Each
   step prints its host routes (C++ library on or off, parallel
   extraction slabs and worker tasks, broken-pool retries, feature-cache
   hits and misses).  Then the resync: the first 16,384 records re-POSTed
   unchanged in the same POST size, every row a feature-cache hit while
   the cache is on; and the device trace of one block
   (``PROFILE_TRACE_DIR``, which must hold the block's kernels) and of one
   whole POST
   (``torch.profiler``): top device ops, idle share, longest idle gap; and
   one more POST with a clock around every ``Comparator.compare``;
3. the ``mixed`` main path: a schema with a Levenshtein, a Jaro-Winkler, a
   q-gram, a Jaccard and an Exact property and a host-only PersonName
   property (which widens the survivor filter, so the certified dd
   finalization has non-emitting survivors to reject); 65,536 records in
   2,048-record POSTs, every 8th a perturbed copy of an earlier one.  The
   Myers, Jaro-Winkler, set-intersection and gathered Myers kernels must
   all have launched and some pairs must have been certified rejects.
   Then one more POST with a clock around every ``Comparator.compare``
   (host finalization by comparator class), four with the finalize pool
   at 1, n, n and 1 threads, and the device traces as in 2;
4. the final block of each main-path workload is re-scored with the
   kernels and with their plain versions on the same device tensors
   (equal ``count_above``, ``top_index`` and ``top_logit``), and the
   ``mixed`` block's dd program on the card must equal the same program
   on CPU copies of its tensors; a 512-record workload of each schema must
   give the feed of a brute-force host oracle.  The kernel wrappers'
   shapes are recorded on the main paths.  Host parity: the C++ library's
   ``lev_sim``, ``jaro_winkler`` and ``weighted_lev`` equal the Python
   comparators on the string pairs of >= 10,000 pairs of both final
   blocks (survivors first), ``fnv1a64_bytes_batch`` and
   ``gram_set_batch`` equal the numpy / Python paths on one POST's
   records of each schema, and ``embed_batch`` is within
   ``NATIVE_EMBED_ATOL`` of numpy (not run under ``DUKE_TPU_NATIVE=0``).
   Host extraction: serial extraction against the shared-memory process
   pool at slabs of 8,192, 32,768 and 131,072 stresstest records, with
   and without the ``ann`` encoder (the pool's first slab, which starts
   its workers, apart from the next), each pool result bit-identical to
   serial; and the feature cache's miss and hit paths against uncached
   extraction on 16,384 records;
5. the ``ann`` main path: a second app with ``backend="ann"`` and its
   corpus pre-sized to 524,288 rows takes slice 1's 131,072 stresstest
   records in 2,048-record POSTs (the fused retrieval: the segment-max
   kernel must launch once per POST) and its 8,192-record query POST (the
   scan route); every link of its feed must be in slice 1's brute-force
   feed with an equal confidence, and its final block is re-scored with
   the plain functions (retrieval scores within ``4 D 2^-24``, the rows
   equal except where neighbouring scores differ by less than it, logits
   of equal rows within ``certified_f32_margin``);
6. hold every kernel against its plain PyTorch version on the card at
   every shape the main paths gave it (Myers also at L=64 and 256; Myers,
   Jaro-Winkler and gathered Myers at each of their shapes also on the
   wide UTF-16 alphabets of tests/wide_units.py; Myers timed a second
   time on stresstest name rows, the set intersection on the mixed
   workload's own final-block gram and token rows, beside the merge
   count's bound and the torch similarity map's time on its output)
   -- integer results exactly, the segment max within ``4 D 2^-24`` with its
   argmax equal wherever a bin's best leads by more -- and time both with
   CUDA events, one call a timing, beside the kernel's bound (and the
   segment max beside ``torch.matmul`` of its bare bf16 product); each
   kernel's wrapper also back to back (``back_to_back_ms``), gathered
   Myers' C entry point alone too (``entry_ms``);
7. the restart phase (durable state): slice 1's 131,072 records into a
   ``DukeApp(persistent=True)`` at the durability defaults (SQLite record
   store and link database, write-behind, the journal, overlapped
   recovery) in a ``tempfile`` data folder, closed (the journal must be 0
   bytes; the snapshot's bytes and save seconds are printed); a restart
   from the snapshot, whose feed after the 8,192-record query POST (Myers
   W=1 must launch on the restored corpus) must equal phase 2's feed at
   the same point, timestamps aside; a restart by replaying the store
   (the snapshot removed), the same feed again; the same for ``ann`` from
   its snapshot (the feed right after the restart equal to phase 5's
   after its ingest; one fresh 2,048-record POST must launch the segment
   max and gathered Myers); one crash: tests/torch_crash_recovery_child.py
   SIGKILLed at ``crash_at=mid_flush:4``, restarted and the unacked
   batches retried, must give the uncrashed control's link rows; then
   the ``restart`` line (durable against in-memory records/s, restart
   seconds, snapshot bytes, the card).  The other phases keep everything
   in memory (``persistent=False``).  The same durable state is held
   against the JAX package on the CPU by ``JAX_PLATFORMS=cpu python -m
   pytest tests/test_torch_persistence.py tests/test_torch_restart.py
   tests/test_torch_crash_recovery.py -q`` (their data folders are
   pytest tmp dirs too, never ``<cwd>/data``);
8. the control phase (the service's control and read surface): slice
   1's first 65,536 records into a persistent ``DukeApp`` in 2,048-record
   POSTs; ``/metrics`` and ``/stats`` scraped (the scrape wall printed)
   and held against the app: records processed, live corpus rows, link
   rows against the feed, the POST count by route and status, the
   per-phase ``duke_cost_device_seconds_total`` summing to the busy
   seconds this app added within 1e-9 relative, ``duke_device_bytes``
   ``corpus_tensors`` equal to the corpus tensors' ``nbytes`` and at most
   ``torch.cuda.memory_allocated()``, the headroom against
   ``mem_get_info``'s total; the streamed feed at ``FEED_PAGE_SIZE=256``
   byte-identical to the HTTP/1.0 buffered one; a multipart ``POST
   /config`` adding a second workload (seconds to the 302), which must
   restore through the corpus snapshot (no
   ``duke_snapshot_fallbacks_total``), keep the feed, free the old
   corpus (allocated bytes less than half a corpus above the level
   before: a leaked old corpus would add a whole one), and
   launch Myers W=1 on the rebuilt corpus for a 2,048-record query POST
   whose links equal those of a control app that never reloaded; a POST
   to the new workload; a malformed reload (400, ``GET /config``
   unchanged); ``/readyz`` ready, ``/healthz`` ok and a 413 at a 1 KiB
   ``MAX_REQUEST_BYTES``; then the ``control`` line;
8a. the debug phase: slice 1's first 65,536 records in 2,048-record
   POSTs (and, second, one POST of copies of the first's records) into
   four fresh apps, ``DUKE_STREAM_APPEND`` on (the default), at 0, at 0
   and on: ``duke_stream_append_slices_total`` must rise by 4 a POST
   (0 on the cold first POST and on the POSTs whose pre-grow doubles the
   capacity, none at 0), the two feeds byte-identical (link clocks are
   counters), every corpus tensor on the card equal to its twin and to
   the host mirror, Myers W=1 launched on a closing query POST, records/s
   on and off printed; the second POST carries a sampled
   ``traceparent``: its ``/debug/traces/<id>`` must hold the request
   root, ``sched.*``, ``encode`` with ``encode.stream_append``,
   ``retrieve``, ``score``, ``persist`` and ``links:assert_batch``, its
   Chrome export must parse, its reply carry ``X-Trace-Id``, and
   ``/debug/requests`` the unsampled POSTs; the slowest request the tail
   latch kept over the whole script, and the three slowest of the
   concurrent-ingest phase's POSTs, are printed span by span; ``POST
   /debug/profile?seconds=6`` around a query POST another thread sends
   (a second capture must answer 409) must hold Myers W=1 among its
   kernels (its kernels and ``record_function`` ranges are printed);
   then ``POST /explain`` on the mixed schema at 4,096 records of the
   feed's first linked pair and of an unlinked one: ``sigmoid`` of the
   host contributions equal to the explain's probability and the feed's
   confidence bit for bit, the per-property device logits within
   ``certified_f32_margin`` of the same call on CPU copies, the band
   verdict and ``decided_path`` printed with the one-pair launches;
   ``/debug/decisions`` and ``/stats`` ``decisions`` not empty; the same
   for one ``ann`` pair (capacity 524,288), its retrieval route printed;
8b. the selfcheck phase, at production knobs: (a) the device arena:
   three stresstest tenants of 65,536 records in one app, the budget
   (``DUKE_HBM_BUDGET_MB``) set to 2.5 tenants' leased bytes after the
   first, so the third's admission spills the coldest; the spills and
   fault-ins, ``memory_allocated`` around each spill (it must fall by at
   least the spilled bytes), the query POST that faults the spilled
   tenant back in beside the same POST resident; that tenant's feed
   byte-identical to a ``DUKE_ARENA=0`` app's on the same traffic (link
   clocks are counters per traffic); an app whose budget is below one
   2,048-record corpus must answer 503 with ``Retry-After``; (b) the
   canary prober: ``run_cycle`` on a stresstest app holding the spilled
   tenant's corpus, after its ingest and after each query POST, and on
   the first mixed app of (c): every canary verdict equal to its oracle
   verdict, no nvcc or g++ build, each cycle's wall and launches printed;
   the stresstest user feed byte-identical to the ``DUKE_PROBE=0``
   control's; (c) ``DUKE_NUMCHECK``: 32,768 mixed records in four fresh
   apps, on / 0 / 0 / on: checked events (certified events and sampled
   certified rejects), 0 violations, feeds byte-identical, records/s on
   against off; (d) IVF: the ``ann`` phase's corpus (capacity 524,288)
   and traffic with ``DUKE_IVF=1``: the training seconds, the cells and
   ``nprobe`` of the auto policy, the escalations and flat-fallback
   scans, the query POST's wall and device time (``torch.profiler``)
   beside the flat ``ann`` app's, recall against the flat scan and the
   brute-force feed (every IVF link in it with an equal confidence), and
   two k-means trainings on the card equal bit for bit;
8c. the mesh phase (``engine.sharded_matcher.set_serving_devices`` at
   ``[cuda:0] * 4``: four logical shards of the one card, run one after
   the other -- the layout, the global row offsets, the merge, the dd
   survivor gather and the ring on the card, no scaling): (1) slice 1's
   131,072 stresstest records and its query POST through a
   ``sharded-brute`` app and a ``device`` app, feeds byte-identical (link
   clocks are counters per app and traffic), both apps' records/s and
   query-POST walls, the Myers W=1 launches with their local shapes,
   ``duke_mesh_devices`` 4 and ``duke_corpus_capacity_rows_per_shard``;
   then ``POST /deduplication/people/rematch`` on that app: 200 with
   ``devices`` 4 and the live rows as ``queries``, the links it emits
   equal to the device app's feed, the feed unchanged, its wall and
   ``pairs_ranked``; (2) 16,384 mixed records, ``sharded-brute`` against
   ``device``: feeds byte-identical, every scan kernel and gathered Myers
   launched on the shards, ``duke_mesh_dd_gathers_total`` above 0; (3)
   65,536 stresstest records through a ``sharded`` app (capacity 4 x
   524,288, so each shard's local shape takes the fused route) against an
   ``ann`` app (524,288): every ``ann`` link in the sharded feed with an
   equal confidence, the segment-max launches on the shards and the
   retrieval routes; then, measured and not checked, the same traffic
   through a ``sharded`` app at the ``ann`` app's capacity split over the
   shards (131,072 a shard): the ``ann`` links it lacks and the links it
   adds;
8d. the multihost phase: the serving group of ``parallel/dispatch.py``
   as two OS processes on cuda:0 (tests/torch_multihost_serving_child.py,
   ``torch.distributed`` with gloo -- two ranks share the card -- and two
   logical shards a process, a global mesh of 4): 65,536 stresstest
   records (every 16th a copy of an earlier one) through ``sharded-brute``,
   then 16,384 through ``sharded`` (capacity 4 x 524,288), each beside a
   single-process app of the same backend on 4 logical shards of the card
   on the same traffic: the frontend's feed byte-identical to it (link
   clocks are counters in both), the follower's replica read plane
   serving the same bytes at ``X-Replica-Lag: 0``, ``duke_dispatch_
   followers`` 1 and ``duke_follower_evictions_total`` 0, a ``POST
   /deduplication/people/rematch`` through the group (``sharded-brute``)
   re-emitting the feed's links with the feed unchanged, and both
   processes' hand-kernel launch counts equal (the lockstep check,
   printed per process with the collectives each entered); records/s and
   p50 POST of the group beside the twin's, and the collective backend;
8e. the federation phase: three durable ``device`` groups on cuda:0 behind
   the partition router (``phase_federation``): the ingest against three
   standalone twins, a live range migration, the ``fed_down`` and
   scatter-timeout drills;
8f. the conformance phase (``phase_conformance``): the hand-derived goldens
   of ``tests/goldens/comparator_goldens.json`` as tiles through the
   Myers, Jaro-Winkler and intersection kernels (tiles equal to the plain
   versions, distances and counts to the longhand, similarities within
   ``certified_f32_margin`` of the goldens); the example-config flow of
   ``tests/torch_longhand.py`` over HTTP on ``device``, ``sharded-brute``
   and ``sharded`` (``[cuda:0] * 4``) and ``ann``, its links equal to the
   longhand sets with confidences within 1e-9 (``ann``: a subset); a
   durable ``device`` app of 65,536 stresstest records restarted from its
   snapshot: its store-backed mirror walked by ``bulk_values`` (0 point
   reads) and by ``values()`` in turns, ``find_candidate_matches`` for
   64 linked records holding every feed partner, 4,096 deletes through
   the index (live rows down by exactly that, the masks copied
   incrementally) and a query POST of copies of the deleted records
   linking to no deleted id;
9. print the per-kernel JSON line, the card's name and power limit, and
   the result line ``{"ok": true, "device": {...}}`` last.

Every app runs with the canary prober on (the default) and its
background cycle held off (``DUKE_PROBE_INTERVAL_S=3600``), so no
phase's launch counts or feeds depend on when a cycle fires.

Between 5 and 6 run two phases of the ingest path (the scheduler and the
``host`` backend):

5a. concurrent ingest through the scheduler: slice 1's first 65,536
   stresstest records (half its 131,072, to hold the script's time) in
   256-record POSTs from 8 client threads, each run on a fresh
   ``DukeApp(device="cuda", persistent=False)``, in the order S, M, 1, S
   (S: the scheduler at its defaults; M: ``DUKE_SCHEDULER=0``, the
   lock-winner merge; 1: one client sending the same POSTs serially).
   Each run prints records/s, POST latency p50 / p99, scoring passes, the
   scheduler's microbatches (mean requests and records each, queue wait,
   429s), Myers W=1 launches and the wrapper's shapes, and the split.
   Every POST must answer 200, S must dispatch fewer microbatches than
   POSTs and launch Myers fewer times than run 1, and the four feeds must
   be equal as unordered pairs with status and confidence.  Then the
   admission check: ``DUKE_SCHED_QUEUE_MAX=1``, 8 clients x 4 POSTs, at
   least one 429 with an integer ``Retry-After`` >= 1, every client that
   sleeps it out gets its 200, and the feed equals the serial run's.  The
   kernel phase holds Myers at the shapes this phase gave it too;
5b. the ``host`` backend: ``DukeApp(backend="host")`` (which must never
   resolve a device) serves the 512-record oracle traffic of step 4 (its
   feed within the oracle's, confidences equal; the links it misses, its
   blocking recall, are printed) and slice 1's first 8,192 records in
   2,048-record POSTs, beside a fresh device app on the same records: its
   records/s beside the device's, and every host link in the device feed
   with an equal confidence.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import statistics
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
PACKAGE = "sesam_duke_microservice_tpu_torch"
PALLAS = "sesam_duke_microservice_tpu/ops/pallas_kernels.py"

# H100 SXM device memory rate (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
# int32 lanes per Hopper SM (NVIDIA H100 architecture whitepaper: 64 INT32
# units per SM); the int32 ALU peak is lanes x SMs x the card's max SM clock
INT32_LANES_PER_SM = 64
# the fewest int32 instructions a 32-bit word of the Myers DP needs per text
# step: (eq & Pv) and its add (a carry-chained add per word past the
# first), Xh = (sum ^ Pv) | eq, Ph = Mv | ~(Xh | Pv) and Mh = Pv & Xh (one
# three-input LOP3 each), Xv = eq | Mv, the two horizontal shifts (a funnel
# shift or shift-add each), Pv = Mh' | ~(Xv | Ph') (one LOP3) and
# Mv = Ph' & Xv.  The match word and text unit are shared-memory loads, not
# ALU work; the score is read once per pair from the last column (O(W)
# popcounts, left out).  The CUDA C++ Programming Guide's throughput table
# gives 64 results per clock per SM for each of these int32 kinds at
# compute capability 9.0.
OPS_PER_WORD_STEP = 10
# Jaro-Winkler with the match done by lookup, as the bound counts it.  The
# greedy match can walk either side: each query char in order taking the
# lowest unmatched text position in its window, or each text char in order
# taking the lowest unmatched query position -- both give the same matched
# positions (tests/test_torch_jw_walk.py) -- so the least work walks the
# shorter side, min(l1, l2) steps a pair, against a position-mask table of
# the other side built once per row and shared by every pair of it (Q x L
# plus C x L entries, under 1/min(Q, C) of the rest, left out).  Per step:
# the table's mask of the char, the window mask and its slide, the and-not
# with the used positions, its lowest bit (negate, and) and the two ors, 8.
# Per match the walk's two lowest-bit finds, the compare, the count and the
# two bit clears; per common-prefix char a compare and a count.
# (``jw_bound(..., shorter=False)`` gives the earlier count of l1 steps a
# pair, against a per-corpus-row table, for comparison with older times.)
JW_OPS_PER_CHAR = 8
JW_OPS_PER_MATCH = 6
JW_OPS_PER_PREFIX = 2
# The fewest int32 instructions a lookup-based set intersection needs: with
# a hash table of each row's ids built once per row (Q x G plus C x G
# inserts, under 1/min(Q, C) of the rest, left out), a pair probes the
# smaller set's ids in the larger set's table, min(qn, cn) probes, and a
# probe whose window holds its id's home slot alone is a compare and a
# count.  csrc/intersect_tile.cu's hot loop (its SASS) spends three int32
# instructions per (id, query, slot) -- ISETP.NE, the count's VIADD and
# a predicated IMAD.MOV that keeps the old count -- where a predicated
# add would do it in two (ISETP, @P IADD3); the table words' 16-byte
# shared-memory load serves four queries, and the id's load, hash (IMAD,
# SHF) and slot address (LOP3, IMAD) are shared by them, all left out.
# (The kernel probes all cn ids of the corpus row over its warp's largest
# window, so it does at least this much.)
INTERSECT_OPS_PER_PROBE = 2
# the two-pointer merge the intersection kernel ran before its redesign:
# per step the compare, the count and the two advances
# (``intersect_bound(..., merge=True)``, for comparison with older times)
MERGE_OPS_PER_STEP = 4

# widths not on this run's main path, held against the plain version at
# the ingest POST's 2,048-query block
EXTRA_WIDTHS = (64, 256)
EXTRA_Q = 2048
# the Myers W=1 kernel is timed a second time on stresstest name rows here
NAMES_SHAPE = (2048, 8192, 32)
INGEST_RECORDS = 131072
INGEST_BATCH = 2048
QUERY_BATCH = 8192
LONG_RECORDS = 16384
ORACLE_RECORDS = 512
MIXED_RECORDS = 65536
# the ann workload's pre-sized corpus: the fused retrieval needs
# 64 / (1 - 0.99) = 6,400 bins of 64 rows at production knobs
ANN_CAPACITY = 524288
SET_PAD = 2**31 - 1
# where the kernel phase makes its inputs
DEVICE = "cuda"

STRESS_SCHEMA = """
      <object class="no.priv.garshol.duke.comparators.NumericComparator"
              name="AreaComparator">
        <param name="min-ratio" value="0.7"/>
      </object>
      <schema>
        <threshold>0.9</threshold>
        <property><name>NAME</name>
          <comparator>levenshtein</comparator><low>0.3</low><high>0.88</high>
        </property>
        <property><name>AREA</name>
          <comparator>AreaComparator</comparator><low>0.45</low><high>0.65</high>
        </property>
        <property><name>SSN</name>
          <comparator>exact</comparator><low>0.3</low><high>0.95</high>
        </property>
      </schema>
      <data-source class="io.sesam.dukemicroservice.IncrementalDeduplicationDataSource">
        <param name="dataset-id" value="crm"/>
        <column name="name" property="NAME"/>
        <column name="area" property="AREA"/>
        <column name="ssn" property="SSN"/>
      </data-source>
"""

# every scan kernel's comparator kind plus a host-only PersonName property
# (the JAX package's tests/test_dd.py hostprop fixture, widened); the
# address q-grams use the Jaccard formula, as overlap (common over the
# smaller set) scores most pairs of street addresses above 0.5
MIXED_PROPS = (("name", "levenshtein", 0.3, 0.9),
               ("given", "jaro-winkler", 0.35, 0.88),
               ("address", "AddressComparator", 0.3, 0.85),
               ("employer", "jaccard", 0.4, 0.7),
               ("ssn", "exact", 0.3, 0.95),
               ("person", "person-name", 0.4, 0.8))
MIXED_SCHEMA = (
    '<object class="no.priv.garshol.duke.comparators.QGramComparator" '
    'name="AddressComparator"><param name="formula" value="jaccard"/>'
    "</object>"
    "<schema><threshold>0.8</threshold><maybe-threshold>0.6</maybe-threshold>"
    + "".join(f"<property><name>{p.upper()}</name><comparator>{c}"
              f"</comparator><low>{lo}</low><high>{hi}</high></property>"
              for p, c, lo, hi in MIXED_PROPS)
    + "</schema><data-source class=\"io.sesam.dukemicroservice."
    "IncrementalDeduplicationDataSource\"><param name=\"dataset-id\" "
    "value=\"crm\"/>"
    + "".join(f'<column name="{p}" property="{p.upper()}"/>'
              for p, _, _, _ in MIXED_PROPS)
    + "</data-source>")


def config_xml(workloads, data_folder=None) -> str:
    """``workloads``: {name: schema XML}.  With ``data_folder`` the link
    databases are the durable default (``h2``: SQLite, write-behind, the
    journal) in that folder; without it, in memory."""
    if data_folder is None:
        head, link_db = "<DukeMicroService>", ' link-database-type="in-memory"'
    else:
        head, link_db = f'<DukeMicroService dataFolder="{data_folder}">', ""
    body = "".join(
        f'<Deduplication name="{n}"{link_db}>'
        f"<duke>{schema}</duke></Deduplication>"
        for n, schema in workloads.items())
    return f"{head}{body}</DukeMicroService>"


FIRST = ["ole", "kari", "per", "anne", "nils", "ingrid", "lars", "berit",
         "jan", "liv", "arne", "astrid", "knut", "solveig", "odd", "randi"]
LAST = ["hansen", "johansen", "olsen", "larsen", "andersen", "pedersen",
        "nilsen", "kristiansen", "jensen", "karlsen", "johnsen", "pettersen"]
STREETS = ["holmenkollveien", "stortingsgata", "kirkeveien", "bygdoy alle",
           "karl johans gate", "nordre gate", "tollbugata", "akersgata"]
# letters of made-up syllables (CV, CVC or VC) for names and streets
CONSONANTS = "bcdfghjklmnprstvwz"
VOWELS = "aeiouy"
STREET_ENDS = ["veien", "gata", "gate", "vegen", "stien", "alle", "lia",
               "svingen"]
EMPLOYER_WORDS = ["acme", "nordic", "fjord", "energy", "bank", "shipping",
                  "telecom", "foods", "media", "group", "holding", "invest",
                  "consult", "data", "systems", "health", "oil", "salmon",
                  "timber", "retail", "transport", "insurance", "pharma",
                  "design", "logistics", "solar", "wind", "hydro", "steel",
                  "textile", "mining", "software", "labs", "capital",
                  "partners", "north", "west", "coast", "valley", "bridge"]


def _long_name_pool(rng, size=512):
    """Address-like names of 33-120 chars (the 4-word kernel's widths)."""
    pool = []
    for _ in range(size):
        name = f"{rng.choice(FIRST)} {rng.choice(LAST)}"
        target = rng.randint(33, 120)
        while len(name) < target:
            name += f" {rng.choice(STREETS)} {rng.randint(1, 99)}"
        pool.append(name[:target])
    return pool


def stresstest_entities(n, seed, prefix, *, long_names=False):
    """Seeded fake entities mirroring the sesam stresstest value pools
    (the bench's generator: 15% of names perturbed into near-duplicates,
    area in [1, 10], ssn in [1, 1e6]); ``long_names`` draws the names from
    a pool of 33-120-char address-like names instead."""
    rng = random.Random(seed)
    pool = _long_name_pool(random.Random(seed + 1)) if long_names else None
    out = []
    for i in range(n):
        if pool is not None:
            name = rng.choice(pool)
        else:
            name = f"{rng.choice(FIRST)} {rng.choice(LAST)}"
        if rng.random() < 0.15:  # perturbations create near-duplicates
            pos = rng.randrange(len(name))
            name = name[:pos] + rng.choice("abcdefghij") + name[pos + 1:]
        out.append({"_id": f"{prefix}{i}", "name": name,
                    "area": str(rng.randint(1, 10)),
                    "ssn": str(rng.randint(1, 1_000_000))})
    return out


def with_copies(entities, source, every, seed):
    """Replace every ``every``-th entity by a copy (under its own id) of a
    random ``source`` entity: the exact duplicates a dedup feed exists to
    find (stresstest pairs rarely clear the 0.9 threshold on their own,
    since a differing ssn costs more than an equal name gains)."""
    rng = random.Random(seed)
    for i in range(0, len(entities), every):
        entities[i] = dict(rng.choice(source), _id=entities[i]["_id"])
    return entities


def _typo(rng, value):
    pos = rng.randrange(len(value))
    return value[:pos] + rng.choice("abcdefghij") + value[pos + 1:]


def mixed_entities(n, seed, prefix):
    """Seeded people for the ``mixed`` schema: made-up given names of two
    syllables and surnames of three (at most 32 chars in all), addresses
    on ~3,000 made-up streets, two- or three-word employers, a random ssn,
    and a person name of given + initial + surname.  Every 8th entity is a
    copy of an earlier one with typos in some fields and, half the time,
    another ssn or address, so survivors fall on both sides of the
    thresholds.  Pairs that share only a given name (a few per query at
    65,536 records) are the survivors the dd path certifies as rejects."""
    rng = random.Random(seed)

    def syllable():
        c, v = rng.choice(CONSONANTS), rng.choice(VOWELS)
        k = rng.random()
        return c + v if k < 0.4 else c + v + rng.choice(CONSONANTS) \
            if k < 0.8 else v + c

    def word(parts):
        return "".join(syllable() for _ in range(parts))

    givens = sorted({word(2) for _ in range(20000)})
    lasts = sorted({word(3) for _ in range(20000)})
    streets = sorted({word(3) + rng.choice(STREET_ENDS) for _ in range(3000)})
    out = []
    for i in range(n):
        if i % 8 == 7:
            ent = dict(rng.choice(out), _id=f"{prefix}{i}")
            for prop in ("name", "given", "address", "employer", "person"):
                if rng.random() < 0.3:
                    ent[prop] = _typo(rng, ent[prop])
            if rng.random() < 0.5:
                ent["ssn"] = str(rng.randint(1, 1_000_000))
            if rng.random() < 0.5:
                ent["address"] = (f"{rng.choice(streets)} "
                                  f"{rng.randint(1, 200)}")
            out.append(ent)
            continue
        given = rng.choice(givens)
        last = rng.choice(lasts)
        out.append({
            "_id": f"{prefix}{i}",
            "name": f"{given} {last}"[:32],
            "given": given,
            "address": f"{rng.choice(streets)} {rng.randint(1, 200)}",
            "employer": " ".join(rng.sample(EMPLOYER_WORDS,
                                            rng.choice((2, 3)))),
            "ssn": str(rng.randint(1, 1_000_000)),
            "person": f"{given} {rng.choice('abcdefghjk')}. {last}",
        })
    return out


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


def int32_peak_ops_per_s() -> float:
    """int32 lanes per SM x SMs x the card's max SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    return INT32_LANES_PER_SM * sms * mhz * 1e6


def cuda_ms(fn, runs):
    """Median milliseconds of ``fn()`` over ``runs`` CUDA-event timings
    (after one warm-up call).  Each timing holds one call, so it also
    counts the host's gap before the launch (some 10 us through ctypes):
    the yardstick of the kernels line's ``ms``."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


# a back-to-back timing spans calls filling about this long
TIMED_SPAN_MS = 1.0
MAX_CALLS_PER_TIMING = 50


def cuda_ms_back_to_back(fn, runs):
    """Median milliseconds of one ``fn()`` over ``runs`` CUDA-event
    timings, each of back-to-back calls filling about TIMED_SPAN_MS (after
    one warm-up call, which sets their number): where the host's work per
    call is shorter than the kernel, the gaps between launches no longer
    count, so a short kernel's own time shows."""
    import torch

    def timed(calls):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / calls

    fn()
    torch.cuda.synchronize()
    first = max(timed(1), 1e-3)
    calls = min(MAX_CALLS_PER_TIMING, max(1, int(TIMED_SPAN_MS / first)))
    return statistics.median(timed(calls) for _ in range(runs))


# -- the kernel wrappers' shapes on the main paths -----------------------------

# wrapper name -> the shape key of one call (its args and keywords)
WRAPPER_SHAPES = {
    "myers_distance_tiles":
        lambda a, kw: (a[0].shape[0], a[2].shape[0], a[0].shape[1]),
    "jaro_winkler_sim_tiles":
        lambda a, kw: (a[0].shape[0], a[2].shape[0], a[0].shape[1]),
    "myers_distance_gathered":
        lambda a, kw: (a[0].shape[0], a[2].shape[1], a[0].shape[1]),
    "set_intersection_tiles":
        lambda a, kw: (a[0].shape[0], a[2].shape[0], a[0].shape[1]),
    # (Q, N, D, tc, seg, group_filtering)
    "retrieval_segmax":
        lambda a, kw: (a[0].shape[0], a[1].shape[0], a[0].shape[1], kw["tc"],
                       kw["seg"], kw["group_filtering"]),
}


@contextlib.contextmanager
def recording_shapes():
    """Count each kernel wrapper's CUDA calls by shape (the wrappers
    themselves count the launches)."""
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    shapes = {name: {} for name in WRAPPER_SHAPES}
    # the federation's scatter threads call the wrappers concurrently
    lock = threading.Lock()
    with contextlib.ExitStack() as stack:
        for name, key in WRAPPER_SHAPES.items():
            def recording(*args, _wrapper=getattr(ck, name), _key=key,
                          _seen=shapes[name], **kwargs):
                if args[0].is_cuda:
                    k = _key(args, kwargs)
                    with lock:
                        _seen[k] = _seen.get(k, 0) + 1
                return _wrapper(*args, **kwargs)

            stack.enter_context(mock.patch.object(ck, name, recording))
        yield shapes


@contextlib.contextmanager
def capturing_sets():
    """Keep a copy of the operands of the first CUDA call of the
    intersection wrapper at each set width G: {G: (qg, qn, cg, cn)}."""
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    seen = {}
    wrapper = ck.set_intersection_tiles

    def capturing(qg, qn, cg, cn):
        if qg.is_cuda and qg.shape[1] not in seen:
            seen[qg.shape[1]] = tuple(t.clone() for t in (qg, qn, cg, cn))
        return wrapper(qg, qn, cg, cn)

    with mock.patch.object(ck, "set_intersection_tiles", capturing):
        yield seen


@contextlib.contextmanager
def plain_versions():
    """Swap every kernel wrapper for its plain PyTorch version."""
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    with contextlib.ExitStack() as stack:
        for name, plain in (
                ("myers_distance_tiles", ck.myers_distance_tiles_reference),
                ("jaro_winkler_sim_tiles",
                 ck.jaro_winkler_sim_tiles_reference),
                ("myers_distance_gathered",
                 ck.myers_distance_gathered_reference),
                ("set_intersection_tiles",
                 ck.set_intersection_tiles_reference),
                ("retrieval_segmax", ck.retrieval_segmax_reference)):
            stack.enter_context(mock.patch.object(ck, name, plain))
        yield


# -- HTTP ---------------------------------------------------------------------


def post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as resp:
        payload = resp.read()
        if resp.status != 200:
            raise AssertionError(f"POST {path}: {resp.status} {payload!r}")
    return time.perf_counter() - t0


def feed(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}?since=0",
                                timeout=900) as resp:
        if resp.status != 200:
            raise AssertionError(f"GET {path}: {resp.status}")
        return json.loads(resp.read())


def ingest(port, path, entities):
    """POST ``entities`` in INGEST_BATCH-record batches; (latencies, wall)."""
    t0 = time.perf_counter()
    latencies = [post(port, path, entities[s:s + INGEST_BATCH])
                 for s in range(0, len(entities), INGEST_BATCH)]
    return latencies, time.perf_counter() - t0


def check_rows(rows, what):
    if not rows:
        raise AssertionError(f"{what}: empty feed")
    for r in rows:
        if not (0.0 < r["confidence"] <= 1.0) or r["_deleted"]:
            raise AssertionError(f"{what}: bad feed row {r}")


def oracle_links(workload, entities):
    """Brute-force host oracle of one POST: every ordered pair of the batch
    through the port's f64 ``Processor.compare``, as each query of the
    batch asserts its links -- a pair links when a direction clears the
    threshold or the maybe threshold, and the later query's confidence is
    the link's (PersonName is not symmetric)."""
    from sesam_duke_microservice_tpu_torch.engine.processor import Processor

    records = workload.datasources["crm"].records_for_batch(entities)
    duke = workload.config.duke
    proc = Processor(duke)
    maybe = duke.maybe_threshold
    links = {}
    for r1 in records:
        for r2 in records:
            if r2 is r1:
                continue
            p = proc.compare(r1, r2)
            if p > duke.threshold or (maybe and p > maybe):
                a, b = sorted((r1.record_id, r2.record_id))
                links[f"{a}_{b}".replace(":", "_")] = p
    return links


# {workload name: (entities, the host oracle's links)} of the main paths'
# oracle checks; the host-backend phase serves the same traffic
ORACLES = {}


def check_oracle(port, app, name, entities):
    post(port, f"/deduplication/{name}/crm", entities)
    got = {r["_id"]: r["confidence"]
           for r in feed(port, f"/deduplication/{name}")}
    want = oracle_links(app.deduplications[name], entities)
    if got != want:
        raise AssertionError(
            f"{name}: oracle feed differs: {len(got)} links vs {len(want)} "
            f"expected; missing {sorted(set(want) - set(got))[:5]}, "
            f"extra {sorted(set(got) - set(want))[:5]}")
    ORACLES[name] = (entities, want)
    print(f"oracle: {name}'s {len(entities)}-record feed equals the host "
          f"oracle ({len(want)} links)", flush=True)


def rescore_plain(workload, records):
    """Score ``records`` as one block twice on the workload's device
    tensors -- through the kernels, then with every kernel wrapper swapped
    for its plain version -- and fail unless count_above, top_index and
    top_logit are equal.  Returns the kernels' resolved block."""
    from sesam_duke_microservice_tpu_torch.engine import device_matcher as DM

    cache = workload.index.scorer_cache

    def score():
        pending = cache.dispatch_block(records, group_filtering=False)
        count = pending.fetch.result()[0][: len(records)]
        return count, DM.resolve_block(pending)

    with workload.lock:
        k_count, kernel = score()
        with plain_versions():
            p_count, plain = score()
    if not ((k_count == p_count).all()
            and (kernel.top_index == plain.top_index).all()
            and (kernel.top_logit == plain.top_logit).all()):
        raise AssertionError(f"{workload.name}: kernel and plain scoring "
                             "disagree on the final block")
    print(f"{workload.name}: final block re-scored with the plain functions:"
          f" equal count_above/top_index/top_logit over {len(records)} "
          f"queries x {workload.index.corpus.capacity} rows", flush=True)
    return kernel


def rescore_dd_on_cpu(workload, block):
    """Run the dd program of a resolved block on the card and on CPU
    copies of the same tensors; (hi, lo, unsafe) must be equal (IEEE f32
    ``+ - * /`` round alike on both, and the gathered Myers kernel's
    distances equal its plain version's)."""
    import torch

    from sesam_duke_microservice_tpu_torch.engine import device_matcher as DM
    from sesam_duke_microservice_tpu_torch.ops import bounds as B
    from sesam_duke_microservice_tpu_torch.ops import scoring as S

    plan = workload.index.plan
    qfeats, from_rows, query_row = block.dd_ctx
    fn = S.dd_rescorer(plan, queries_from_rows=from_rows,
                       value_slots_cap=DM._VALUE_SLOTS_MAX)
    with workload.lock:
        feats = workload.index.corpus.device_arrays()[0]
        cfeats = {s.name: feats[s.name] for s in B.dd_plan_specs(plan)}
        top = torch.from_numpy(block.top_index).to(DEVICE)
        card = [t.cpu() for t in fn(qfeats, cfeats, query_row, top)]
        cpu = fn({p: {n: t.cpu() for n, t in f.items()}
                  for p, f in qfeats.items()},
                 {p: {n: t.cpu() for n, t in f.items()}
                  for p, f in cfeats.items()}, query_row.cpu(), top.cpu())
    for name, a, b in zip(("hi", "lo", "unsafe"), card, cpu):
        if not torch.equal(a, b):
            raise AssertionError(f"{workload.name}: dd {name} on the card "
                                 "differs from the CPU run")
    lanes = int((block.top_logit > block.min_logit).sum())
    print(f"{workload.name}: dd program of the final block ({top.shape[0]} x "
          f"{top.shape[1]} pairs, {lanes} survivors) equals its CPU run: hi, "
          f"lo and unsafe bit for bit ({int(card[2].sum())} unsafe lanes)",
          flush=True)


# -- host paths: routes, resync, parity, the finalization split, traces --

# the resync step re-POSTs this many of the stresstest records unchanged
RESYNC_RECORDS = 16384
# host-parity phase: at least this many survivor pairs, at most this many
# string pairs held (the Python oracles take ~0.1 ms a pair)
PARITY_PAIRS = 10000
PARITY_MAX_STRING_PAIRS = 30000
# (workload, resolved block, its query records) of each re-scored final block
FINAL_BLOCKS = []
# in-memory ingest records/s by backend, for the restart phase's line
INGEST_RATES = {}


def host_counters():
    """Process-wide host-route counters: the parallel extractor's and the
    feature cache's."""
    from sesam_duke_microservice_tpu_torch.ops import feature_cache as FC
    from sesam_duke_microservice_tpu_torch.ops import parallel_extract as PX

    hits, misses, _, _ = FC.stats()
    return dict(PX.STATS, hits=hits, misses=misses)


def routes_line(before, what):
    """The host routes a phase took since ``before`` (``host_counters``)."""
    from sesam_duke_microservice_tpu_torch import native
    from sesam_duke_microservice_tpu_torch.ops import feature_cache as FC
    from sesam_duke_microservice_tpu_torch.ops import parallel_extract as PX

    now = host_counters()
    d = {k: now[k] - before[k] for k in now}
    lib = "on" if native.available() else "off (DUKE_TPU_NATIVE=0)"
    return (f"host routes [{what}]: C++ host library {lib}; parallel "
            f"extraction {d['slabs']} slabs, {d['tasks']} worker tasks "
            f"(DEVICE_EXTRACT_WORKERS {PX.workers()}, slabs from "
            f"{PX.min_records()} records); broken-pool serial retries "
            f"{d['serial_retries']}; feature cache {d['hits']} hits, "
            f"{d['misses']} misses (DUKE_FEATURE_CACHE_MB {FC.budget_mb()})"
            f" [host cores {os.cpu_count()}]")


SPLIT_FIELDS = ("dispatch_seconds", "wait_seconds", "dd_seconds",
                "finalize_seconds", "device_seconds")


def split_fields(stats):
    return {k: getattr(stats, k) for k in SPLIT_FIELDS}


def stats_since(stats, before):
    """The split fields of ``stats`` accumulated since ``before``
    (``split_fields``), for ``split_line``."""
    return types.SimpleNamespace(
        **{k: getattr(stats, k) - before[k] for k in SPLIT_FIELDS})


def resync(port, workload, entities, ingest_tail, tail_capacity, line):
    """Sesam's full resync: re-POST ``entities`` unchanged, in the ingest's
    POST size; with the feature cache on, every row must be a hit.
    ``ingest_tail``: the latencies of the ingest's last POSTs, which
    scanned ``tail_capacity`` rows."""
    from sesam_duke_microservice_tpu_torch.ops import feature_cache as FC

    before, s0 = host_counters(), split_fields(workload.processor.stats)
    _, wall = ingest(port, f"/deduplication/{workload.name}/crm", entities)
    hits = host_counters()["hits"] - before["hits"]
    if FC.active() is not None and hits != len(entities):
        raise AssertionError(f"resync: {hits} feature-cache hits for "
                             f"{len(entities)} unchanged records")
    tail = len(ingest_tail) * INGEST_BATCH / sum(ingest_tail)
    print(f"resync (the first {len(entities)} stresstest records re-POSTed "
          f"unchanged in {INGEST_BATCH}-record POSTs): "
          f"{len(entities) / wall:.1f} records/s over "
          f"{workload.index.corpus.capacity} corpus rows (the ingest's last "
          f"{len(ingest_tail)} POSTs: {tail:.1f} over {tail_capacity}), "
          f"feature-cache hits {hits} "
          f"of {len(entities)} rows; "
          + split_line(stats_since(workload.processor.stats, s0), wall, line),
          flush=True)
    print(routes_line(before, "resync"), flush=True)


@contextlib.contextmanager
def comparator_clock():
    """Time every ``Comparator.compare`` by class, in all threads: {class:
    [calls, inclusive s, exclusive s]} (exclusive: less the compares it
    made itself, as PersonName makes Levenshtein compares)."""
    from sesam_duke_microservice_tpu_torch.core import comparators as C

    totals, lock, local = {}, threading.Lock(), threading.local()

    def clocked(cls, compare):
        def timed(self, v1, v2):
            stack = local.__dict__.setdefault("stack", [])
            stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return compare(self, v1, v2)
            finally:
                dt = time.perf_counter() - t0
                inner = stack.pop()
                if stack:
                    stack[-1] += dt
                with lock:
                    row = totals.setdefault(cls.__name__, [0, 0.0, 0.0])
                    row[0] += 1
                    row[1] += dt
                    row[2] += dt - inner
        return timed

    classes = [c for c in vars(C).values() if isinstance(c, type)
               and issubclass(c, C.Comparator) and "compare" in vars(c)]
    with contextlib.ExitStack() as stack:
        for cls in classes:
            stack.enter_context(mock.patch.object(
                cls, "compare", clocked(cls, vars(cls)["compare"])))
        yield totals


def finalization_split(port, workload, batch, line):
    """One POST's host finalization by comparator class."""
    stats = workload.processor.stats
    s0 = split_fields(stats)
    with comparator_clock() as totals:
        wall = post(port, f"/deduplication/{workload.name}/crm", batch)
    host = stats_since(stats, s0).finalize_seconds
    print(f"{workload.name} finalization split (one {len(batch)}-record "
          f"POST, wall {wall:.3f} s, host finalization {host:.3f} s, "
          f"per-compare clock on): " + "; ".join(
              f"{name} {calls} compares, {excl:.3f} s ({incl:.3f} s with "
              "the compares it made)"
              for name, (calls, incl, excl) in sorted(
                  totals.items(), key=lambda kv: -kv[1][2]))
          + f" [{line}; host cores {os.cpu_count()}]", flush=True)


def mixed_finalization_split(port, mixed, batches, line):
    """One mixed POST's host finalization by comparator class, then the
    finalize thread pool on and off (1, n, n, 1 threads) over four more."""
    from sesam_duke_microservice_tpu_torch.engine.finalize import (
        FinalizeExecutor,
    )

    path = "/deduplication/mixed/crm"
    stats = mixed.processor.stats
    finalization_split(port, mixed, batches[0], line)
    n = min(8, os.cpu_count() or 1)
    old = mixed.processor.finalizer
    times = []
    try:
        for threads, batch in zip((1, n, n, 1), batches[1:]):
            mixed.processor.finalizer = FinalizeExecutor(threads)
            s0 = split_fields(stats)
            post(port, path, batch)
            d = stats_since(stats, s0)
            mixed.processor.finalizer.shutdown()
            times.append((threads, d.finalize_seconds))
    finally:
        mixed.processor.finalizer = old
    print("mixed host finalization by DUKE_FINALIZE_THREADS, one "
          f"{len(batches[1])}-record POST each: "
          + ", ".join(f"{t} threads {s:.3f} s" for t, s in times)
          + f" [{line}; host cores {os.cpu_count()}]", flush=True)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_summary(path):
    """Device activity of a Chrome trace: top ops by total device time,
    the idle share of the traced window and its longest idle gap."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e and "ts" in e]
    if not events:
        return None
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("cat") in DEVICE_CATS)
    by_name = {}
    for start, end, name in device:
        row = by_name.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += end - start
    busy, gap, edge = 0.0, 0.0, t0
    for start, end, _ in device:
        if end <= edge:
            continue
        gap = max(gap, start - edge)
        busy += end - max(start, edge)
        edge = end
    gap = max(gap, t1 - edge)
    window = max(t1 - t0, 1e-9)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"window_ms": window / 1e3, "device_events": len(device),
            "names": set(by_name),
            "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / window,
            "longest_idle_ms": gap / 1e3,
            "top": [(name[:60], calls, us / 1e3) for name, (calls, us) in top]}


def summary_text(s):
    if s is None:
        return "no events"
    return (f"window {s['window_ms']:.3f} ms, {s['device_events']} device "
            f"events, busy {s['busy_ms']:.3f} ms, idle share "
            f"{s['idle_share']:.4f}, longest idle gap "
            f"{s['longest_idle_ms']:.3f} ms; top device ops by total time: "
            + "; ".join(f"{name} x{calls} {ms:.3f} ms"
                        for name, calls, ms in s["top"]))


def device_trace(port, workload, batches, line):
    """The device trace of one block: the package's own (PROFILE_TRACE_DIR,
    ``trace_batch`` around the block's dispatch and resolve) on one POST,
    then a
    ``torch.profiler`` window around one whole POST of the same size."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.utils import profiling as P

    path = f"/deduplication/{workload.name}/crm"
    with tempfile.TemporaryDirectory() as tmp:
        with mock.patch.dict(os.environ, {"PROFILE_TRACE_DIR": tmp,
                                          "PROFILE_TRACE_BATCHES": "1"}):
            P.reset_trace_budget()
            post(port, path, batches[0])
        P.reset_trace_budget()
        traces = sorted(Path(tmp).glob("trace-*.json"))
        if len(traces) != 1:
            raise AssertionError(f"{workload.name}: PROFILE_TRACE_DIR wrote "
                                 f"{len(traces)} traces for one block")
        block = trace_summary(traces[0])
        whole_path = Path(tmp) / "whole_post.json"
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = post(port, path, batches[1])
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(whole_path))
        whole = trace_summary(whole_path)
    if whole is None or not whole["device_events"]:
        raise AssertionError(f"{workload.name}: the whole-POST trace holds "
                             "no device work")
    scan = sorted({k for k in ck.LAUNCHES for n in (block or {}).get(
        "names", ()) if f"{k}_kernel" in n})
    print(f"device trace [{workload.name}, trace_batch around the dispatch "
          f"and resolve of one {len(batches[0])}-record block]: "
          f"{summary_text(block)}; the port's kernels in it: "
          f"{', '.join(scan) or 'none'} [{line}]", flush=True)
    if not scan:
        raise AssertionError(f"{workload.name}: the trace_batch window holds "
                             "none of the block's scan kernels")
    print(f"device trace [{workload.name}, torch.profiler around one whole "
          f"{len(batches[1])}-record POST, wall {wall:.3f} s]: "
          f"{summary_text(whole)} [{line}]", flush=True)


def survivor_string_pairs(want):
    """String pairs of every comparison property of the final blocks'
    survivors (device logit above the bound), then of their other top-K
    rows until ``want`` record pairs are held."""
    import numpy as np

    chosen = []
    for survivors in (True, False):
        for workload, block, records in FINAL_BLOCKS:
            index = workload.index
            above = block.top_logit > block.min_logit
            pick = (above if survivors
                    else ~above & (block.top_index >= 0))
            for qi, k in zip(*np.nonzero(pick[:len(records)])):
                rid = index.corpus.row_ids[int(block.top_index[qi, k])]
                cand = index.records.get(rid)
                if cand is not None:
                    chosen.append((workload, records[qi], cand, survivors))
        if len(chosen) >= want:
            break
    pairs = []
    for workload, rec, cand, _ in chosen:
        for prop in workload.config.duke.comparison_properties():
            for a in rec.get_values(prop.name):
                for b in cand.get_values(prop.name):
                    pairs.append((a, b))
    n_surv = sum(1 for c in chosen if c[3])
    return pairs, n_surv, len(chosen) - n_surv


def phase_host_parity(stress_workload, stress_records, mixed_workload,
                      mixed_records):
    """The C++ host library held exactly against the port's Python / numpy
    paths on this run's rows (the embedding within its stated bound)."""
    import numpy as np

    from sesam_duke_microservice_tpu_torch import native
    from sesam_duke_microservice_tpu_torch.core import comparators as C
    from sesam_duke_microservice_tpu_torch.ops import embedding as H
    from sesam_duke_microservice_tpu_torch.ops import features as F

    if not native.available():
        print("host parity: not run (DUKE_TPU_NATIVE=0, the C++ library is "
              "off)", flush=True)
        return
    t0 = time.perf_counter()
    pairs, n_surv, n_more = survivor_string_pairs(PARITY_PAIRS)
    if n_surv + n_more < PARITY_PAIRS:
        raise AssertionError(f"host parity: only {n_surv + n_more} pairs")
    random.Random(5).shuffle(pairs)
    pairs = pairs[:PARITY_MAX_STRING_PAIRS]
    comparators = (C.Levenshtein(), C.JaroWinkler(), C.WeightedLevenshtein())
    got = [[c.compare(a, b) for a, b in pairs] for c in comparators]
    with mock.patch.object(C, "_NATIVE", None):
        want = [[c.compare(a, b) for a, b in pairs] for c in comparators]
    for c, g, w in zip(comparators, got, want):
        bad = [p for p, x, y in zip(pairs, g, w) if x != y]
        if bad:
            raise AssertionError(f"host parity: {type(c).__name__} C++ != "
                                 f"Python on {len(bad)} pairs, e.g. {bad[:3]}")

    def values(records):
        return [v for r in records for p in r.properties() for v in
                r.get_values(p)]

    all_values = values(stress_records) + values(mixed_records)
    gram_specs = [s for s in mixed_workload.index.plan.device_props
                  if s.kind == F.GRAM_SET]
    per_record = [[r.get_values(s.name) for r in mixed_records]
                  for s in gram_specs]
    nat_hash = F.fnv1a64_batch(all_values)
    nat_grams = [F.extract_property(s, v) for s, v in zip(gram_specs,
                                                           per_record)]
    with mock.patch.object(native, "available", lambda: False):
        ref_hash = F.fnv1a64_batch(all_values)
        ref_grams = [F.extract_property(s, v) for s, v in zip(gram_specs,
                                                               per_record)]
    if not np.array_equal(nat_hash, ref_hash):
        raise AssertionError("host parity: fnv1a64_bytes_batch != numpy")
    for nat, ref in zip(nat_grams, ref_grams):
        for name in ref:
            if not np.array_equal(nat[name], ref[name]):
                raise AssertionError(f"host parity: gram_set_batch {name} "
                                     "!= Python")
    worst = 0.0
    for workload, records in ((stress_workload, stress_records),
                              (mixed_workload, mixed_records)):
        enc = H.RecordEncoder(workload.config.duke, 256)
        nat = enc.encode_batch(records)
        ref = H.embed_batch([[(p, v) for p in enc.props
                              for v in r.get_values(p) if v]
                             for r in records], enc.dim)
        worst = max(worst, float(np.abs(nat - ref).max()))
    if worst > H.NATIVE_EMBED_ATOL:
        raise AssertionError(f"host parity: embed_batch off numpy by {worst}"
                             f" > {H.NATIVE_EMBED_ATOL}")
    print(f"host parity: C++ == Python on {len(pairs)} string pairs of "
          f"{n_surv} survivor pairs (+{n_more} further top-K pairs) of the "
          f"stresstest and mixed final blocks for lev_sim, jaro_winkler and "
          f"weighted_lev; fnv1a64_bytes_batch == numpy on "
          f"{len(all_values)} values, gram_set_batch == Python on "
          f"{len(mixed_records)} records x {len(gram_specs)} q-gram "
          f"properties; embed_batch within {worst:.3g} of numpy (bound "
          f"{H.NATIVE_EMBED_ATOL:.3g}) on {len(stress_records)} + "
          f"{len(mixed_records)} records, D 256 ({time.perf_counter() - t0:.1f}"
          f" s)", flush=True)


# host extraction: slab sizes held serial against the process pool, and
# the feature cache's miss and hit paths on this many records
EXTRACT_SLABS = (8192, 32768, 131072)
CACHE_RECORDS = 16384
CACHE_MB = 256


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def same_features(got, want):
    import numpy as np

    return set(got) == set(want) and all(
        set(got[p]) == set(want[p]) and all(
            got[p][t].dtype == a.dtype and np.array_equal(got[p][t], a)
            for t, a in want[p].items())
        for p in want)


def phase_host_extraction(workload, entities, line):
    """Serial extraction against the shared-memory process pool on this
    host, at slabs from the pool's threshold up, with and without the
    ``ann`` encoder: the pool's first slab (which starts its workers) and
    its next, each held bit for bit against serial.  Then the feature
    cache's miss and hit paths against uncached extraction, fresh records
    each pass (the record digest is memoized on the record)."""
    from sesam_duke_microservice_tpu_torch.ops import embedding as H
    from sesam_duke_microservice_tpu_torch.ops import feature_cache as FC
    from sesam_duke_microservice_tpu_torch.ops import features as F
    from sesam_duke_microservice_tpu_torch.ops import parallel_extract as PX

    def records(n):
        return workload.datasources["crm"].records_for_batch(entities[:n])

    plan = workload.index.plan
    nw = max(2, min(8, (os.cpu_count() or 1) // 2))
    for enc in (None, H.RecordEncoder(workload.config.duke, 256)):
        what = "stresstest plan" + ("" if enc is None else
                                    ", ann encoder D 256")
        PX._shutdown()
        parts = []
        for n in EXTRACT_SLABS:
            recs = records(n)
            with mock.patch.dict(os.environ, {"DEVICE_EXTRACT_WORKERS": "0"}):
                want, serial = timed(
                    lambda: F._extract_direct(plan, recs, encoder=enc))
            with mock.patch.dict(os.environ,
                                 {"DEVICE_EXTRACT_WORKERS": str(nw)}):
                pool = []
                for _ in range(2):
                    got, dt = timed(lambda: PX.extract_batch_parallel(
                        plan, recs, encoder=enc))
                    if got is None or not same_features(got, want):
                        raise AssertionError(f"host extraction [{what}]: the "
                                             f"pool's {n}-record slab != "
                                             "serial")
                    pool.append(dt)
            parts.append(f"slab {n}: serial {serial:.3f} s "
                         f"({serial / n * 1e6:.2f} us a record), pool "
                         f"{pool[0]:.3f} s then {pool[1]:.3f} s")
        PX._shutdown()
        print(f"host extraction [{what}; a pool of {nw} workers, its first "
              f"slab starts them]: " + "; ".join(parts)
              + f"; every pool result bit-identical to serial [{line}; host "
              f"cores {os.cpu_count()}]", flush=True)

        cache = FC.FeatureCache(CACHE_MB << 20)
        n = CACHE_RECORDS
        with mock.patch.dict(os.environ, {"DEVICE_EXTRACT_WORKERS": "0"}):
            recs = records(n)
            want, plain = timed(
                lambda: F._extract_direct(plan, recs, encoder=enc))
            recs = records(n)
            _, miss = timed(
                lambda: FC.cached_extract(cache, plan, recs, encoder=enc))
            recs = records(n)
            got, hit = timed(
                lambda: FC.cached_extract(cache, plan, recs, encoder=enc))
        if cache.hits != n or not same_features(got, want):
            raise AssertionError(f"feature cache [{what}]: {cache.hits} hits "
                                 f"of {n}, or hit rows != extraction")
        print(f"feature cache [{what}, {n} records, serial extraction, a "
              f"cache of {CACHE_MB} MB]: uncached {plain / n * 1e6:.2f} "
              f"us a record, miss path {miss / n * 1e6:.2f}, hit path "
              f"{hit / n * 1e6:.2f} (every row a hit, bit-identical) "
              f"[{line}; host cores {os.cpu_count()}]", flush=True)


# -- the main paths -------------------------------------------------------------


def split_line(stats, wall, line):
    parts = (stats.dispatch_seconds + stats.wait_seconds + stats.dd_seconds
             + stats.finalize_seconds)
    return (f"wall {wall:.3f} s: dispatching the blocks (query preparation, "
            f"corpus upload, kernel launches) {stats.dispatch_seconds:.3f} "
            f"s, waiting on their results {stats.wait_seconds:.3f} s, the dd "
            f"rescore {stats.dd_seconds:.3f} s, host finalization "
            f"{stats.finalize_seconds:.3f} s, the rest (HTTP, JSON, "
            f"extraction, persist) {wall - parts:.3f} s (host clock); the "
            f"programs' device time {stats.device_seconds:.3f} s (CUDA "
            f"events) [{line}]")


def phase_slice1(app, port, line):
    """Slice 1's main path: the stresstest ingest, the query POST and the
    long-name workload; returns (launches, shapes)."""
    from sesam_duke_microservice_tpu_torch.engine import device_matcher as DM
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    people = app.deduplications["people"]
    # three more POSTs of the same traffic: the device traces (two) and
    # the finalization split (one)
    entities = stresstest_entities(INGEST_RECORDS + 3 * INGEST_BATCH, 1234,
                                   "p")
    entities, extra = entities[:INGEST_RECORDS], entities[INGEST_RECORDS:]
    queries = with_copies(stresstest_entities(QUERY_BATCH, 4321, "q"),
                          entities, 16, 1)
    addresses = stresstest_entities(LONG_RECORDS, 99, "a", long_names=True)
    addresses = with_copies(addresses, addresses[: LONG_RECORDS // 2], 8, 2)

    with recording_shapes() as shapes:
        ck.reset_launch_counts()
        counters = host_counters()
        latencies, ingest_s = ingest(port, "/deduplication/people/crm",
                                     entities)
        tail_capacity = people.index.corpus.capacity
        stats = people.processor.stats
        split = split_line(stats, ingest_s, line)
        routes = [routes_line(counters, "stresstest ingest")]
        pairs0 = stats.pairs_compared
        counters = host_counters()
        query_s = post(port, "/deduplication/people/crm", queries)
        routes.append(routes_line(counters, "stresstest query POST"))
        query_pairs = stats.pairs_compared - pairs0
        counters = host_counters()
        _, long_s = ingest(port, "/deduplication/addresses/crm", addresses)
        long_split = split_line(
            app.deduplications["addresses"].processor.stats, long_s, line)
        routes.append(routes_line(counters, "long-name ingest"))
        people_rows = feed(port, "/deduplication/people")
        address_rows = feed(port, "/deduplication/addresses")
        launches = dict(ck.LAUNCHES)

    print(f"slice-1 path: launches {launches}; wrapper calls by shape "
          f"{ {k: dict(sorted(v.items())) for k, v in shapes.items() if v} }",
          flush=True)
    for name in ("myers_tile", "myersN_tile"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on slice 1's "
                                 "main path")
    check_rows(people_rows, "people")
    check_rows(address_rows, "addresses")
    widths = {s.name: s.chars
              for s in app.deduplications["addresses"].index.plan
              .device_props}
    print(f"feeds: people {len(people_rows)} links, addresses "
          f"{len(address_rows)} links (char widths {widths})", flush=True)
    final = people.datasources["crm"].records_for_batch(
        queries[-DM.query_buckets()[-1]:])
    FINAL_BLOCKS.append((people, rescore_plain(people, final), final))
    long_wl = app.deduplications["addresses"]
    rescore_plain(long_wl, long_wl.datasources["crm"].records_for_batch(
        addresses[-INGEST_BATCH:]))

    INGEST_RATES["device"] = INGEST_RECORDS / ingest_s
    print(f"records/s (stresstest ingest, {INGEST_RECORDS} records in "
          f"{INGEST_BATCH}-record POSTs): {INGEST_RECORDS / ingest_s:.1f} "
          f"[{line}]")
    print(f"pairs scored/s ({QUERY_BATCH}-record query POST, "
          f"{query_pairs} pairs in {query_s:.3f} s): "
          f"{query_pairs / query_s:.1f} [{line}]")
    print(f"p50 POST latency (stresstest ingest POSTs): "
          f"{statistics.median(latencies) * 1e3:.1f} ms [{line}]")
    print(f"stresstest ingest {split}", flush=True)
    print(f"long-name ingest ({LONG_RECORDS} records) {long_split}",
          flush=True)
    for text in routes:
        print(text, flush=True)
    resync(port, people, entities[:RESYNC_RECORDS],
           latencies[-(RESYNC_RECORDS // INGEST_BATCH):], tail_capacity,
           line)
    device_trace(port, people,
                 [extra[:INGEST_BATCH], extra[INGEST_BATCH:2 * INGEST_BATCH]],
                 line)
    finalization_split(port, people, extra[2 * INGEST_BATCH:], line)
    return launches, shapes, people_rows, entities


def phase_mixed(app, port, line):
    """The ``mixed`` main path; returns (launches, shapes, the operands of
    the final block's first intersection call at each set width)."""
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    mixed = app.deduplications["mixed"]
    # seven more POSTs of the same traffic: the finalization split (five)
    # and the device traces (two)
    entities = mixed_entities(MIXED_RECORDS + 7 * INGEST_BATCH, 2024, "m")
    extra = [entities[s:s + INGEST_BATCH]
             for s in range(MIXED_RECORDS, len(entities), INGEST_BATCH)]
    entities = entities[:MIXED_RECORDS]
    with recording_shapes() as shapes:
        ck.reset_launch_counts()
        counters = host_counters()
        latencies, ingest_s = ingest(port, "/deduplication/mixed/crm",
                                     entities)
        launches = dict(ck.LAUNCHES)
        routes = routes_line(counters, "mixed ingest")
    rows = feed(port, "/deduplication/mixed")
    stats = mixed.processor.stats
    print(f"mixed path: launches {launches}; wrapper calls by shape "
          f"{ {k: dict(sorted(v.items())) for k, v in shapes.items() if v} }",
          flush=True)
    for name in ("myers_tile", "jw_tile", "intersect_tile",
                 "myers_gathered"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the mixed "
                                 "main path")
    check_rows(rows, "mixed")
    residue = (stats.dd_residue_margin + stats.dd_residue_kind
               + stats.dd_residue_truncation)
    print(f"mixed: {len(rows)} links; survivors {stats.candidates_retrieved}, "
          f"dd blocks dispatched {stats.dd_blocks} of {stats.batches}; "
          f"certified rejects {stats.pairs_device_certified}; host "
          f"compares {stats.pairs_rescored}: residue {residue} (margin "
          f"{stats.dd_residue_margin}, kind {stats.dd_residue_kind}, "
          f"truncation or JW branch guard {stats.dd_residue_truncation}), "
          f"the other {stats.pairs_rescored - residue} certified events or "
          f"survivors of blocks the gate skipped; decisive-band skips "
          f"{stats.pairs_skipped}", flush=True)
    if stats.pairs_device_certified <= 0:
        raise AssertionError("mixed: no pair was certified on the dd path")
    print(f"records/s (mixed ingest, {MIXED_RECORDS} records in "
          f"{INGEST_BATCH}-record POSTs): {MIXED_RECORDS / ingest_s:.1f} "
          f"[{line}]")
    print(f"p50 POST latency (mixed ingest POSTs): "
          f"{statistics.median(latencies) * 1e3:.1f} ms [{line}]")
    print(f"mixed ingest {split_line(stats, ingest_s, line)}", flush=True)
    print(routes, flush=True)

    final = mixed.datasources["crm"].records_for_batch(
        entities[-INGEST_BATCH:])
    with capturing_sets() as real_sets:
        block = rescore_plain(mixed, final)
    FINAL_BLOCKS.append((mixed, block, final))
    rescore_dd_on_cpu(mixed, block)
    mixed_finalization_split(port, mixed, extra[:5], line)
    device_trace(port, mixed, extra[5:], line)
    return launches, shapes, real_sets, entities[:INGEST_BATCH]


def phase_main_paths(line):
    import torch

    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp, serve

    app = DukeApp(parse_config(config_xml({
        "people": STRESS_SCHEMA, "addresses": STRESS_SCHEMA,
        "oracle": STRESS_SCHEMA, "mixed": MIXED_SCHEMA,
        "mixed_oracle": MIXED_SCHEMA})), device="cuda", persistent=False)
    server = serve(app, port=0, host="127.0.0.1")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        *slice1, stress_entities = phase_slice1(app, port, line)
        *mixed, mixed_post = phase_mixed(app, port, line)
        people, mixed_wl = (app.deduplications[name]
                            for name in ("people", "mixed"))
        phase_host_parity(
            people, people.datasources["crm"].records_for_batch(
                stress_entities[:INGEST_BATCH]),
            mixed_wl, mixed_wl.datasources["crm"].records_for_batch(
                mixed_post))
        phase_host_extraction(people, stress_entities, line)
        # a sixth of the batch copies one entity: more candidates per
        # query than the initial top-K, so K-escalation runs too
        check_oracle(port, app, "oracle", with_copies(
            stresstest_entities(ORACLE_RECORDS, 7, "o"),
            stresstest_entities(1, 8, "x"), 6, 3))
        check_oracle(port, app, "mixed_oracle",
                     mixed_entities(ORACLE_RECORDS, 77, "mo"))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        app.close()
    torch.cuda.synchronize()
    return slice1, mixed


# -- the ann backend's main path -------------------------------------------------


def rescore_ann_plain(workload, records):
    """Score ``records`` as one block of the ``ann`` workload through the
    kernels and through their plain versions, on the same device tensors:
    the retrieval scores must agree within the segment-max bar, the
    retrieved rows wherever neighbouring scores are further apart than it,
    and the rescored logits of equal rows within ``certified_f32_margin``."""
    import torch

    from sesam_duke_microservice_tpu_torch.engine import device_matcher as DM
    from sesam_duke_microservice_tpu_torch.ops import bounds as B
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.ops import encoder as E

    index = workload.index
    cache = index.scorer_cache
    with workload.lock:
        _, _, query_row, query_group = cache._prepare_queries(records, False)
        feats, valid, deleted, group = index.corpus.device_arrays()
        emb = feats[E.ANN_PROP]
        q_tree = {n: t.index_select(0, query_row.clamp_min(0))
                  for n, t in emb.items()}

        def retrieve():
            return E.retrieval_scan(
                q_tree, emb, valid, deleted, group, query_group, query_row,
                chunk=DM._CHUNK, top_c=index.initial_top_c,
                group_filtering=False)

        def block():
            return DM.resolve_block(cache.dispatch_block(
                records, group_filtering=False))

        k_sim, k_idx = retrieve()
        kernel = block()
        with plain_versions():
            p_sim, p_idx = retrieve()
            plain = block()
    n = len(records)
    tol = ck.segmax_tolerance(emb[E.ANN_TENSOR].shape[1])
    k_sim, p_sim = k_sim[:n].double(), p_sim[:n].double()
    # neighbours closer than the bar, but not exactly tied, may swap
    gap = (p_sim[:, 1:] - p_sim[:, :-1]).abs()
    gaps = (gap == 0) | (gap > tol)
    decided = torch.ones(p_sim.shape, dtype=torch.bool, device=p_sim.device)
    decided[:, 1:] &= gaps
    decided[:, :-1] &= gaps
    sim_err = float((k_sim - p_sim).abs().max())
    moved = int((decided & (k_idx[:n] != p_idx[:n])).sum())
    if sim_err > tol or moved:
        raise AssertionError(f"{workload.name}: kernel and plain retrieval "
                             f"disagree (max |sim err| {sim_err}, {moved} "
                             "decided rows differ)")
    if kernel.top_index.shape != plain.top_index.shape:
        raise AssertionError(f"{workload.name}: kernel and plain blocks "
                             "escalated to different widths")
    same = kernel.top_index[:n] == plain.top_index[:n]
    margin = B.certified_f32_margin(index.plan)
    logit_err = float(abs(kernel.top_logit[:n][same].astype("float64")
                          - plain.top_logit[:n][same]).max(initial=0.0))
    if logit_err > margin:
        raise AssertionError(f"{workload.name}: rescored logits differ by "
                             f"{logit_err} > certified_f32_margin {margin}")
    print(f"{workload.name}: final block re-scored with the plain functions: "
          f"retrieval within {sim_err:.3g} (bar {tol:.3g}), rows equal where "
          f"decided ({int(decided.sum())} of {decided.numel()} slots), "
          f"{int(same.sum())} of {same.size} rows equal after rescoring, "
          f"logits within {logit_err:.3g} (margin {margin:.3g})", flush=True)


# the flat ann app's feed after its query POST, that POST's wall and its
# device trace (phase_ann), for the IVF app of the selfcheck phase
ANN_FLAT = {}


def profiled_post(port, path, body):
    """POST under ``torch.profiler``: (wall, the trace's device summary);
    the kernels of every thread (CUPTI) land in it, so the dispatcher's
    work is counted."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = post(port, path, body)
            torch.cuda.synchronize()
        trace = Path(tmp) / "post.json"
        prof.export_chrome_trace(str(trace))
        summary = trace_summary(trace)
    if summary is None or not summary["device_events"]:
        raise AssertionError(f"POST {path}: the trace holds no device work")
    return wall, summary


def copy_pairs(rows, entities):
    """The feed rows linking two entities with identical values."""
    values = {e["_id"]: (e["name"], e["area"], e["ssn"]) for e in entities}
    return {r["_id"] for r in rows
            if values[r["entity1"]] == values[r["entity2"]]}


def phase_ann(line, device_rows):
    """The ``ann`` backend's main path: a second app, its corpus pre-sized
    to ANN_CAPACITY rows (the knob set for it alone), takes slice 1's
    131,072 stresstest records in 2,048-record POSTs and its 8,192-record
    query POST; its feed must be a subset of slice 1's brute-force feed
    with equal confidences.  Returns (launches, shapes, the feed after the
    ingest)."""
    import torch

    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.engine import device_matcher as DM
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.ops import encoder as E
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp, serve

    entities = stresstest_entities(INGEST_RECORDS, 1234, "p")
    queries = with_copies(stresstest_entities(QUERY_BATCH, 4321, "q"),
                          entities, 16, 1)
    with mock.patch.dict(os.environ,
                         {"DEVICE_INITIAL_CAPACITY": str(ANN_CAPACITY)}):
        app = DukeApp(parse_config(config_xml({"people": STRESS_SCHEMA})),
                      backend="ann", device="cuda", persistent=False)
    server = serve(app, port=0, host="127.0.0.1")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    people = app.deduplications["people"]
    stats = people.processor.stats
    try:
        with recording_shapes() as shapes:
            ck.reset_launch_counts()
            for name in E.ROUTES:
                E.ROUTES[name] = 0
            escalations = DM.ESCALATIONS["top_c"]
            counters = host_counters()
            latencies, ingest_s = ingest(port, "/deduplication/people/crm",
                                         entities)
            ingest_launches = dict(ck.LAUNCHES)
            ingest_routes = dict(E.ROUTES)
            # the restart phase holds its restored feed against this one
            ingest_rows = feed(port, "/deduplication/people")
            split = split_line(stats, ingest_s, line)
            host_routes = [routes_line(counters, "ann ingest")]
            pairs0 = stats.pairs_compared
            counters = host_counters()
            query_s = post(port, "/deduplication/people/crm", queries)
            host_routes.append(routes_line(counters, "ann query POST"))
            query_pairs = stats.pairs_compared - pairs0
            launches = dict(ck.LAUNCHES)
            routes = dict(E.ROUTES)
            escalations = DM.ESCALATIONS["top_c"] - escalations
        rows = feed(port, "/deduplication/people")
        capacity = people.index.corpus.capacity
        rescore_ann_plain(people, people.datasources["crm"]
                          .records_for_batch(entities[-INGEST_BATCH:]))
        # the device time: a second, identical query POST under the
        # profiler, after the feed and the counts were read
        _, query_trace = profiled_post(port, "/deduplication/people/crm",
                                       queries)
        # the selfcheck phase's IVF app is held against this flat scan
        ANN_FLAT.update(rows=rows, query_s=query_s, query_trace=query_trace)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        app.close()
    torch.cuda.synchronize()

    print(f"ann path (capacity {capacity}): launches {launches} (ingest "
          f"{ingest_launches}); retrieval routes {routes} (ingest "
          f"{ingest_routes}); C-escalations {escalations}; wrapper calls by "
          f"shape { {k: dict(sorted(v.items())) for k, v in shapes.items() if v} }",
          flush=True)
    if capacity != ANN_CAPACITY:
        raise AssertionError(f"ann corpus capacity {capacity}, expected the "
                             f"pre-sized {ANN_CAPACITY}")
    for name in ("retrieval_segmax", "myers_gathered"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the ann "
                                 "main path")
    if ingest_launches["retrieval_segmax"] < INGEST_RECORDS // INGEST_BATCH:
        raise AssertionError("retrieval_segmax launched fewer times than "
                             "there were ingest POSTs")
    check_rows(rows, "ann")
    device = {r["_id"]: r["confidence"] for r in device_rows
              if not r["_deleted"]}
    ann = {r["_id"]: r["confidence"] for r in rows}
    stray = [k for k, v in ann.items() if device.get(k) != v]
    if stray:
        raise AssertionError(f"ann: {len(stray)} links not in the "
                             f"brute-force feed with equal confidence, e.g. "
                             f"{[(k, ann[k], device.get(k)) for k in stray[:3]]}")
    everyone = entities + queries
    copies = copy_pairs(device_rows, everyone)
    print(f"ann feed: {len(ann)} links, all in the brute-force feed with "
          f"equal confidences; recall {len(ann) / len(device):.4f} of "
          f"{len(device)} brute-force links, on exact-copy pairs "
          f"{len(copies & set(ann)) / max(1, len(copies)):.4f} of "
          f"{len(copies)}", flush=True)
    INGEST_RATES["ann"] = INGEST_RECORDS / ingest_s
    print(f"records/s (ann ingest, {INGEST_RECORDS} records in "
          f"{INGEST_BATCH}-record POSTs): {INGEST_RECORDS / ingest_s:.1f} "
          f"[{line}]")
    print(f"ann query POST ({QUERY_BATCH} records): {query_s:.3f} s, "
          f"{query_pairs} pairs rescored; torch.profiler around a second, "
          f"identical POST: {summary_text(query_trace)} [{line}]")
    print(f"p50 POST latency (ann ingest POSTs): "
          f"{statistics.median(latencies) * 1e3:.1f} ms [{line}]")
    print(f"ann ingest {split}; pairs rescored {pairs0}", flush=True)
    for text in host_routes:
        print(text, flush=True)
    return launches, shapes, ingest_rows


# -- concurrent ingest through the scheduler, and the host backend ---------------

# slice 1's first 65,536 stresstest records (of its 131,072: halved to hold
# the script's time), in 256-record POSTs from 8 client threads
CONCURRENT_RECORDS = 65536
CONCURRENT_POST = 256
CONCURRENT_CLIENTS = 8
# the admission check: DUKE_SCHED_QUEUE_MAX=1, 8 clients x 4 POSTs
ADMISSION_POSTS = 4
# the host backend's share of slice 1's traffic, in INGEST_BATCH POSTs
# (8,192 since the multihost phase joined the script: its Python
# retrieval grows with the corpus, and the script keeps its time)
HOST_RECORDS = 8192


def post_status(port, path, body):
    """POST without raising on an error status: (status, Retry-After,
    seconds)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=900) as resp:
            resp.read()
            return resp.status, None, time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, e.headers.get("Retry-After"), time.perf_counter() - t0


def link_set(rows):
    """A feed as unordered entity pairs with status and confidence: what
    does not depend on the order the records arrived in."""
    return {(frozenset((r["entity1"], r["entity2"])), r["_deleted"],
             r["confidence"]) for r in rows}


def stress_app(env=None, **kwargs):
    """A fresh in-memory app of the stresstest schema; ``env`` holds for
    its construction (the scheduler reads its knobs there)."""
    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp

    with mock.patch.dict(os.environ, env or {}):
        return DukeApp(parse_config(config_xml({"people": STRESS_SCHEMA})),
                       persistent=False, **kwargs)


def send(port, path, posts, clients):
    """Send ``posts`` from ``clients`` threads (client c sends posts c, c +
    clients, ... in order); every POST must answer 200.  Returns (latencies,
    wall)."""
    def client(c):
        out = []
        for body in posts[c::clients]:
            status, _, dt = post_status(port, path, body)
            if status != 200:
                raise AssertionError(f"POST {path}: status {status}")
            out.append(dt)
        return out

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        latencies = [dt for f in [pool.submit(client, c)
                                  for c in range(clients)]
                     for dt in f.result()]
    return latencies, time.perf_counter() - t0


def concurrent_run(label, posts, line):
    """One run of the concurrent-ingest phase on a fresh device app: ``S``
    the scheduler at its defaults, ``M`` DUKE_SCHEDULER=0 (the lock-winner
    merge), ``1`` one client sending the POSTs serially.  Returns its
    numbers, the Myers shapes and the feed's link set."""
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    path = "/deduplication/people/crm"
    app = stress_app({"DUKE_SCHEDULER": "0" if label == "M" else "1"},
                     device="cuda")
    people = app.deduplications["people"]
    with serving(app) as port:
        with recording_shapes() as shapes:
            before = split_fields(people.processor.stats)
            ck.reset_launch_counts()
            latencies, wall = send(port, path, posts,
                                   1 if label == "1" else CONCURRENT_CLIENTS)
            launches = dict(ck.LAUNCHES)
        stats = people.processor.stats
        split = split_line(stats_since(stats, before), wall, line)
        passes = stats.batches
        sched = (app.scheduler.stats_snapshot()["workloads"][0]
                 if app.scheduler is not None else None)
        rows = feed(port, "/deduplication/people")
    if launches["myers_tile"] <= 0:
        raise AssertionError(f"concurrent ingest [{label}]: kernel "
                             "myers_tile never launched")
    check_rows(rows, f"concurrent ingest [{label}]")
    records = sum(map(len, posts))
    q = statistics.quantiles(latencies, n=100)
    sched_text = "no scheduler"
    if sched is not None:
        mb = sched["microbatches"]
        sched_text = (f"scheduler microbatches {mb} (mean "
                      f"{sched['merged_requests'] / mb} requests, "
                      f"{sched['records_dispatched'] / mb} records each; "
                      f"mean queue wait {sched['avg_wait_ms']} ms; 429s "
                      f"{sched['rejected']})")
    myers = dict(sorted(shapes["myers_distance_tiles"].items()))
    print(f"concurrent ingest [{label}]: {records} records in {len(posts)} "
          f"{CONCURRENT_POST}-record POSTs from "
          f"{1 if label == '1' else CONCURRENT_CLIENTS} client(s): "
          f"{records / wall} records/s; POST latency p50 "
          f"{statistics.median(latencies) * 1e3} ms, p99 {q[98] * 1e3} ms; "
          f"scoring passes {passes}; {sched_text}; Myers W=1 launches "
          f"{launches['myers_tile']}, wrapper calls by (Q, C, L) {myers}; "
          f"{split}; {len(rows)} links", flush=True)
    return dict(label=label, rps=records / wall, passes=passes,
                microbatches=sched and sched["microbatches"],
                rejected=sched and sched["rejected"],
                myers=launches["myers_tile"], launches=launches,
                shapes=shapes, links=link_set(rows))


def admission_check(posts, line):
    """DUKE_SCHED_QUEUE_MAX=1 under 8 clients x ADMISSION_POSTS POSTs: at
    least one 429 with an integer Retry-After >= 1, every client retrying
    after it (sleeping Retry-After) gets its 200, and the feed equals the
    same POSTs sent serially."""
    path = "/deduplication/people/crm"
    rejects = []

    def client(port, c):
        for body in posts[c::CONCURRENT_CLIENTS]:
            for _ in range(120):
                status, retry_after, _ = post_status(port, path, body)
                if status == 200:
                    break
                if status != 429 or int(retry_after) < 1:
                    raise AssertionError(f"admission: status {status}, "
                                         f"Retry-After {retry_after!r}")
                rejects.append(int(retry_after))
                time.sleep(int(retry_after))
            else:
                raise AssertionError(f"admission: client {c} never got "
                                     "its 200")

    app = stress_app({"DUKE_SCHEDULER": "1", "DUKE_SCHED_QUEUE_MAX": "1"},
                     device="cuda")
    t0 = time.perf_counter()
    with serving(app) as port:
        with ThreadPoolExecutor(CONCURRENT_CLIENTS) as pool:
            for f in [pool.submit(client, port, c)
                      for c in range(CONCURRENT_CLIENTS)]:
                f.result()
        wall = time.perf_counter() - t0
        got = link_set(feed(port, "/deduplication/people"))
    serial = stress_app({"DUKE_SCHEDULER": "1"}, device="cuda")
    with serving(serial) as port:
        send(port, path, posts, 1)
        want = link_set(feed(port, "/deduplication/people"))
    if not rejects:
        raise AssertionError("admission: no POST was answered 429 at "
                             "DUKE_SCHED_QUEUE_MAX=1")
    if got != want:
        raise AssertionError(f"admission: feed of {len(got)} links differs "
                             f"from the serial run's {len(want)}")
    print(f"admission (DUKE_SCHED_QUEUE_MAX=1, {CONCURRENT_CLIENTS} clients x "
          f"{ADMISSION_POSTS} POSTs): {len(rejects)} 429s, Retry-After "
          f"{sorted(set(rejects))} s; every client got its 200s in {wall} s; "
          f"feed of {len(got)} links equals the serial run's [{line}]",
          flush=True)


def phase_concurrent(line):
    """Concurrent ingest through the scheduler on the card: runs S, M, 1,
    S (S: the scheduler at its defaults; M: DUKE_SCHEDULER=0, the
    lock-winner merge; 1: one client, the same POSTs serially), each on a
    fresh app; then the admission check.  Returns (launches, shapes) of the
    first S run."""
    import torch

    t0 = time.perf_counter()
    entities = stresstest_entities(CONCURRENT_RECORDS, 1234, "p")
    posts = [entities[s:s + CONCURRENT_POST]
             for s in range(0, CONCURRENT_RECORDS, CONCURRENT_POST)]
    runs = [concurrent_run(label, posts, line)
            for label in ("S", "M", "1", "S")]
    torch.cuda.synchronize()
    first, serial = runs[0], runs[2]
    for run in runs:
        if run["links"] != first["links"]:
            raise AssertionError(
                f"concurrent ingest [{run['label']}]: {len(run['links'])} "
                f"links differ from run S's {len(first['links'])}")
    for run in (runs[0], runs[3]):
        if run["microbatches"] >= len(posts):
            raise AssertionError(f"scheduler: {run['microbatches']} "
                                 f"microbatches for {len(posts)} POSTs")
        if run["myers"] >= serial["myers"]:
            raise AssertionError(f"scheduler: {run['myers']} Myers launches,"
                                 f" not fewer than the serial run's "
                                 f"{serial['myers']}")
    print(f"concurrent ingest: S, M, 1, S records/s "
          f"{[r['rps'] for r in runs]}; scoring passes "
          f"{[r['passes'] for r in runs]}; Myers W=1 launches "
          f"{[r['myers'] for r in runs]}; the four feeds equal "
          f"({len(first['links'])} links) [{line}]", flush=True)
    admission_check(posts[:CONCURRENT_CLIENTS * ADMISSION_POSTS], line)
    print(f"concurrent ingest phase: {time.perf_counter() - t0} s",
          flush=True)
    return first["launches"], first["shapes"]


def phase_host_backend(line):
    """The ``host`` backend beside the card: ``DukeApp(backend="host")``
    serves the main paths' oracle traffic (its feed within the brute-force
    oracle's, confidences equal; the links it misses are its blocking
    recall) and slice 1's first HOST_RECORDS records, whose links must all
    be in a fresh device app's feed of the same records with equal
    confidences.  The host app must never resolve a device."""
    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.engine import workload as W
    from sesam_duke_microservice_tpu_torch.service import app as A

    t0 = time.perf_counter()
    entities = stresstest_entities(HOST_RECORDS, 1234, "p")
    path = "/deduplication/people/crm"
    resolved = []

    def refusing(*args, **kwargs):
        resolved.append(args)
        raise AssertionError("the host backend resolved a device")

    recall = {}
    with mock.patch.object(A, "resolve_device", refusing), \
            mock.patch.object(W, "resolve_device", refusing):
        app = A.DukeApp(parse_config(config_xml({
            "people": STRESS_SCHEMA, "oracle": STRESS_SCHEMA,
            "mixed_oracle": MIXED_SCHEMA})), backend="host",
            persistent=False)
        with serving(app) as port:
            for name, (oracle_entities, want) in sorted(ORACLES.items()):
                post(port, f"/deduplication/{name}/crm", oracle_entities)
                got = {r["_id"]: r["confidence"]
                       for r in feed(port, f"/deduplication/{name}")}
                stray = [k for k, v in got.items() if want.get(k) != v]
                if stray:
                    raise AssertionError(
                        f"host {name}: {len(stray)} links not in the oracle "
                        f"with equal confidence, e.g. {stray[:3]}")
                recall[name] = (len(got), len(want))
            latencies, host_s = ingest(port, path, entities)
            host_rows = feed(port, "/deduplication/people")
    if resolved:
        raise AssertionError("the host backend resolved a device")
    device = stress_app(device="cuda")
    with serving(device) as port:
        _, device_s = ingest(port, path, entities)
        device_rows = feed(port, "/deduplication/people")
    check_rows(host_rows, "host")
    want = {r["_id"]: r["confidence"] for r in device_rows}
    stray = [r["_id"] for r in host_rows
             if want.get(r["_id"]) != r["confidence"]]
    if stray:
        raise AssertionError(f"host: {len(stray)} links not in the device "
                             f"feed with equal confidence, e.g. {stray[:3]}")
    print(f"host backend: oracle feeds within the brute-force oracle with "
          f"equal confidences; blocking recall "
          f"{ {n: f'{g}/{w} ({g / max(1, w):.4f}), missed {w - g}' for n, (g, w) in recall.items()} }",
          flush=True)
    print(f"host backend: {HOST_RECORDS} stresstest records in "
          f"{INGEST_BATCH}-record POSTs: {HOST_RECORDS / host_s} records/s "
          f"(p50 POST {statistics.median(latencies) * 1e3} ms), the device "
          f"backend {HOST_RECORDS / device_s} records/s in the same run; "
          f"{len(host_rows)} host links, all in the device feed of "
          f"{len(device_rows)} with equal confidences (recall "
          f"{len(host_rows) / len(device_rows):.4f}) [{line}]", flush=True)
    print(f"host backend phase: {time.perf_counter() - t0} s", flush=True)


# -- the restart phase: durable state --------------------------------------------

CRASH_SITE = "mid_flush"
CRASH_NTH = 4
CRASH_CHILD = REPO / "tests" / "torch_crash_recovery_child.py"


@contextlib.contextmanager
def serving(app):
    """Serve ``app`` on a free port; shut down and close it on exit (the
    close drains the link flush and saves the corpus snapshot)."""
    from sesam_duke_microservice_tpu_torch.service.app import serve

    server = serve(app, port=0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        app.close()


def feed_rows(rows):
    """A feed as sorted rows without their timestamps (the one field a
    restart may change)."""
    return sorted(tuple(sorted((k, v) for k, v in r.items()
                               if k != "_updated")) for r in rows)


def check_same_feed(rows, want, what):
    got, expected = feed_rows(rows), feed_rows(want)
    if got != expected:
        missing = sorted(set(expected) - set(got))[:2]
        extra = sorted(set(got) - set(expected))[:2]
        raise AssertionError(
            f"{what}: feed of {len(got)} links differs from the in-memory "
            f"phase's {len(expected)} (missing e.g. {missing}, extra e.g. "
            f"{extra})")


def crash_child(data, *args, fault=""):
    """tests/torch_crash_recovery_child.py on the card: (rc, acks, dump)."""
    env = dict(os.environ, DUKE_FAULTS=fault)
    proc = subprocess.run(
        [sys.executable, str(CRASH_CHILD), "--data", str(data), "--device",
         DEVICE, *args], capture_output=True, text=True, timeout=600,
        env=env)
    acks = [int(l.split()[1]) for l in proc.stdout.splitlines()
            if l.startswith("ACK ")]
    dumps = [json.loads(l[5:]) for l in proc.stdout.splitlines()
             if l.startswith("DUMP ")]
    if proc.returncode not in (0, -9):
        raise AssertionError(f"crash child rc {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    return proc.returncode, acks, (dumps[0] if dumps else None)


def phase_crash(root):
    """One crash: a child ingesting under ``crash_at=mid_flush`` is
    SIGKILLed; its restart (journal replay) and the retry of the unacked
    batches must give the uncrashed control's link rows."""
    rc, acks, control = crash_child(root / "control", "--dump", "--close")
    if rc != 0 or not control["links"]:
        raise AssertionError("crash control run failed")
    fault = f"crash_at={CRASH_SITE}:{CRASH_NTH}"
    rc, acks, _ = crash_child(root / "crashed", fault=fault)
    if rc != -9:
        raise AssertionError(f"the child survived {fault} (rc {rc})")
    resume = max(acks) + 1 if acks else 0
    rc, _, got = crash_child(root / "crashed", "--start", str(resume),
                             "--dump", "--close")
    for key in ("links", "feed", "store_rows"):
        if got[key] != control[key]:
            raise AssertionError(f"crash at {CRASH_SITE}: recovered {key} "
                                 "differ from the uncrashed control")
    if got["journal_pending"] != 0 or got["replayed"] < 1:
        raise AssertionError(f"crash at {CRASH_SITE}: journal pending "
                             f"{got['journal_pending']}, replayed "
                             f"{got['replayed']}")
    print(f"crash: SIGKILL at {CRASH_SITE} (arrival {CRASH_NTH}) after "
          f"{len(acks)} acked batches; restart replayed {got['replayed']} "
          f"journaled batch(es), retried from batch {resume}: "
          f"{len(got['links'])} link rows equal to the uncrashed control",
          flush=True)


def phase_restart(line, device_rows, ann_rows):
    """Durable state on the card: slice 1's ingest into a persistent app
    (write-behind, journal, overlapped recovery at their defaults), a
    restart from the snapshot and one from a replay of the store, each
    serving the in-memory phase's feed (kernel #1 on the restored corpus);
    the same for ``ann`` from the snapshot (kernels #6 and #4 on the
    restored corpus); one crash; and the ``restart`` line."""
    import tempfile

    import torch

    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.engine import device_matcher as DM
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp

    path = "/deduplication/people/crm"
    entities = stresstest_entities(INGEST_RECORDS, 1234, "p")
    queries = with_copies(stresstest_entities(QUERY_BATCH, 4321, "q"),
                          entities, 16, 1)
    saves = []
    real_save = DM.DeviceIndex.snapshot_save

    def timed_save(index, snap_path):
        t0 = time.perf_counter()
        real_save(index, snap_path)
        saves.append(time.perf_counter() - t0)

    with tempfile.TemporaryDirectory(prefix="duke-restart-") as tmp, \
            mock.patch.object(DM.DeviceIndex, "snapshot_save", timed_save):
        root = Path(tmp)
        times = {}
        for backend, want in (("device", device_rows), ("ann", ann_rows)):
            config = parse_config(config_xml({"people": STRESS_SCHEMA},
                                             data_folder=root / backend))
            folder = Path(config.deduplications["people"].data_folder)
            capacity = {"DEVICE_INITIAL_CAPACITY": str(
                ANN_CAPACITY if backend == "ann" else 0)}

            def start(route):
                t0 = time.perf_counter()
                with mock.patch.dict(os.environ, capacity):
                    app = DukeApp(config, backend=backend, device="cuda")
                wl = app.deduplications["people"]
                if wl.restore_route != route:
                    app.close()
                    raise AssertionError(f"{backend}: restart took route "
                                         f"{wl.restore_route}, not {route}")
                return app, t0

            # 1. the durable ingest, then a graceful close
            app, _ = start(None)
            with serving(app) as port:
                _, ingest_s = ingest(port, path, entities)
            journal = os.path.getsize(folder / "linkdatabase.journal")
            snap = folder / "corpus_snapshot.npz"
            times[backend] = dict(
                ingest_rps=INGEST_RECORDS / ingest_s,
                snapshot_bytes=os.path.getsize(snap), save_s=saves[-1])
            if journal != 0:
                raise AssertionError(f"{backend}: journal holds {journal} "
                                     "bytes after a graceful close")
            print(f"{backend} durable ingest: {INGEST_RECORDS} records in "
                  f"{ingest_s} s; journal {journal} bytes after close; "
                  f"snapshot {times[backend]['snapshot_bytes']} bytes saved "
                  f"in {saves[-1]} s [{line}]", flush=True)

            # 2. restart from the snapshot
            app, t0 = start("snapshot")
            with serving(app) as port:
                rows = feed(port, "/deduplication/people")
                times[backend]["snapshot_s"] = time.perf_counter() - t0
                ck.reset_launch_counts()
                if backend == "device":
                    post(port, path, queries)
                    rows = feed(port, "/deduplication/people")
                    launches = dict(ck.LAUNCHES)
                    kernels = ("myers_tile",)
                else:
                    # ann: the feed right after the restart, then a fresh
                    # ingest POST on the restored corpus
                    check_same_feed(rows, want, "ann snapshot restart")
                    post(port, path, stresstest_entities(INGEST_BATCH, 5678,
                                                         "n"))
                    launches = dict(ck.LAUNCHES)
                    kernels = ("retrieval_segmax", "myers_gathered")
                torch.cuda.synchronize()
            print(f"{backend} snapshot restart: first feed read "
                  f"{times[backend]['snapshot_s']} s after the start "
                  f"(route snapshot); launches after it {launches} [{line}]",
                  flush=True)
            for name in kernels:
                if launches[name] <= 0:
                    raise AssertionError(f"kernel {name} never launched on "
                                         f"the restored {backend} corpus")
            if backend == "device":
                check_same_feed(rows, want, "snapshot restart")

                # 3. restart by replaying the store
                os.remove(snap)
                app, t0 = start("replay")
                with serving(app) as port:
                    rows = feed(port, "/deduplication/people")
                    times[backend]["replay_s"] = time.perf_counter() - t0
                check_same_feed(rows, want, "replay restart")
                print(f"device replay restart: first feed read "
                      f"{times[backend]['replay_s']} s after the start "
                      f"(route replay) [{line}]", flush=True)
        phase_crash(root)
    dev, ann = times["device"], times["ann"]
    print(f"restart: durable ingest {dev['ingest_rps']} records/s (in-memory "
          f"{INGEST_RATES['device']}), ann {ann['ingest_rps']} (in-memory "
          f"{INGEST_RATES['ann']}); snapshot restart {dev['snapshot_s']} s, "
          f"replay restart {dev['replay_s']} s, snapshot "
          f"{dev['snapshot_bytes']} bytes saved in {dev['save_s']} s; ann "
          f"snapshot restart {ann['snapshot_s']} s, snapshot "
          f"{ann['snapshot_bytes']} bytes saved in {ann['save_s']} s "
          f"[{line}]", flush=True)


# -- the control and read surface --------------------------------------------

CONTROL_RECORDS = 65536
CONTROL_FEED_PAGE = 256


def scrape(port):
    """(/metrics samples {(name, ((label, value), ...)): value}, /stats
    JSON, wall ms of the two GETs)."""
    import re

    sample_line = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? "
                             r"(\S+)$")
    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as resp:
        text = resp.read().decode()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                timeout=60) as resp:
        stats = json.loads(resp.read())
    wall_ms = (time.perf_counter() - t0) * 1000.0
    samples = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, labels, value = sample_line.match(line).groups()
        pairs = tuple(re.findall(r'([a-zA-Z_]\w*)="((?:\\.|[^"\\])*)"',
                                 labels or ""))
        samples[(name, pairs)] = float(value)
    return samples, stats, wall_ms


def family(samples, name, **labels):
    """The samples of ``name`` whose labels include ``labels``."""
    return {k: v for k, v in samples.items() if k[0] == name
            and all((l, str(v)) in k[1] for l, v in labels.items())}


def one(samples, name, **labels):
    found = family(samples, name, **labels)
    if len(found) != 1:
        raise AssertionError(f"/metrics: {len(found)} samples of {name} "
                             f"{labels}")
    return next(iter(found.values()))


def raw_feed(port, path, version):
    """(body bytes, seconds) of one ``?since=0`` GET: HTTP/1.1 is read
    de-chunked by urllib, HTTP/1.0 from a raw socket (the buffered body
    with a Content-Length; the server's status line says HTTP/1.1)."""
    import socket

    t0 = time.perf_counter()
    if version == "HTTP/1.1":
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}?since=0",
                                    timeout=900) as resp:
            if resp.headers.get("Transfer-Encoding") != "chunked":
                raise AssertionError("the HTTP/1.1 feed is not chunked")
            body = resp.read()
        return body, time.perf_counter() - t0
    with socket.create_connection(("127.0.0.1", port), timeout=900) as sock:
        sock.sendall(f"GET {path}?since=0 HTTP/1.0\r\n\r\n".encode())
        data = bytearray()
        while chunk := sock.recv(1 << 20):
            data += chunk
    head, _, body = bytes(data).partition(b"\r\n\r\n")
    if not head.startswith(b"HTTP/1.1 200") or b"Content-Length" not in head:
        raise AssertionError(f"HTTP/1.0 feed: {head[:80]!r}")
    return body, time.perf_counter() - t0


def multipart_post(port, path, field, payload):
    """(status, seconds) of a multipart/form-data POST of one file field."""
    boundary = "----chipsmoke"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="{field}"; filename="duke.xml"\r\nContent-Type: '
            f"application/xml\r\n\r\n{payload}\r\n--{boundary}--\r\n").encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})

    class NoRedirect(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *args, **kwargs):
            return None

    t0 = time.perf_counter()
    try:
        with urllib.request.build_opener(NoRedirect).open(
                req, timeout=900) as resp:
            resp.read()
            status = resp.status
    except urllib.error.HTTPError as e:
        e.read()
        status = e.code
    return status, time.perf_counter() - t0


def over_limit_post(port, path, length):
    """The raw answer to a POST announcing a ``length``-byte body and
    sending none: the server must refuse it from the header alone and
    close the connection (the read ends at EOF)."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
        sock.sendall(f"POST {path} HTTP/1.1\r\nHost: x\r\n"
                     f"Content-Length: {length}\r\n\r\n".encode())
        data = bytearray()
        while chunk := sock.recv(1 << 16):
            data += chunk
    return bytes(data)


def compare_feeds(port, path, rows, line):
    """The streamed feed at FEED_PAGE_SIZE=256 must equal the HTTP/1.0
    buffered one byte for byte (and decode to ``rows``); returns (links,
    bytes, HTTP/1.1 seconds, HTTP/1.0 seconds)."""
    with mock.patch.dict(os.environ,
                         {"FEED_PAGE_SIZE": str(CONTROL_FEED_PAGE)}):
        streamed, s11 = raw_feed(port, path, "HTTP/1.1")
    buffered, s10 = raw_feed(port, path, "HTTP/1.0")
    if streamed != buffered or json.loads(streamed) != rows:
        raise AssertionError("control: the streamed feed differs from the "
                             "HTTP/1.0 feed")
    print(f"control feeds: {len(rows)} links, {len(streamed)} bytes; "
          f"HTTP/1.1 at FEED_PAGE_SIZE={CONTROL_FEED_PAGE} {s11} s, "
          f"HTTP/1.0 buffered {s10} s, byte-identical [{line}]", flush=True)
    return len(rows), len(streamed), s11, s10


def corpus_tensor_bytes(workload):
    """Bytes of the corpus tensors on the card, summed here from the
    tensors themselves (the ledger's ``corpus_tensors`` component)."""
    corpus = workload.index.corpus
    feats = sum(t.nbytes for tensors in corpus._device_feats.values()
                for t in tensors.values())
    return feats + sum(t.nbytes for t in corpus._device_masks)


def phase_control(line):
    """The control and read surface on the card: a persistent app takes
    slice 1's first 65,536 records; /metrics and /stats are scraped and
    held against the app's own state (records, rows, links, requests, the
    cost ledger's balance, the device-byte ledger against the allocator);
    the streamed feed at FEED_PAGE_SIZE=256 against the HTTP/1.0 buffered
    one, byte for byte; a multipart POST /config reload (the same workload
    plus a second one) through the corpus snapshot, with the feed, a
    query POST's links (Myers W=1 on the rebuilt corpus) and the device
    memory checked after it against a control app that never reloaded;
    a malformed reload (400, the old config kept), the probes and a 413.
    Prints the ``control`` line."""
    import tempfile

    import torch

    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp
    from sesam_duke_microservice_tpu_torch.telemetry import memory

    path, feed_path = "/deduplication/people/crm", "/deduplication/people"
    entities = stresstest_entities(INGEST_RECORDS, 1234, "p")[:CONTROL_RECORDS]
    queries = with_copies(stresstest_entities(INGEST_BATCH, 4321, "q"),
                          entities, 16, 1)
    posts = [entities[s:s + INGEST_BATCH]
             for s in range(0, len(entities), INGEST_BATCH)]
    out = {}
    with tempfile.TemporaryDirectory(prefix="duke-control-") as tmp:
        xml = config_xml({"people": STRESS_SCHEMA}, data_folder=tmp)
        xml2 = config_xml({"people": STRESS_SCHEMA, "people2": STRESS_SCHEMA},
                          data_folder=tmp)
        app = DukeApp(parse_config(xml), device=DEVICE)
        with serving(app) as port:
            before, _, _ = scrape(port)
            busy0 = one(before, "duke_cost_busy_seconds_total")
            t0 = time.perf_counter()
            for body in posts:
                post(port, path, body)
            out["ingest_rps"] = CONTROL_RECORDS / (time.perf_counter() - t0)
            wl = app.deduplications["people"]
            torch.cuda.synchronize()

            # 1. /metrics and /stats against the app's own state, after a
            # feed read: it drains the write-behind link flush, and the
            # link-row gauge reads the durable store without draining
            rows = feed(port, feed_path)
            samples, stats, out["scrape_ms"] = scrape(port)
            people = {"kind": "deduplication", "workload": "people"}
            row = next(r for r in stats["workloads"] if r["name"] == "people")
            checks = {
                "records processed": (one(
                    samples, "duke_engine_records_processed_total", **people),
                    CONTROL_RECORDS),
                "corpus rows": (one(samples, "duke_corpus_rows", state="live",
                                    **people), row["records_indexed"]),
                "links rows": (one(samples, "duke_links_rows", **people),
                               len(rows)),
                "POST 200s": (one(
                    samples, "duke_http_requests_total",
                    route="/deduplication/:name/:datasetId", method="POST",
                    status="200"), len(posts)),
            }
            for what, (got, want) in checks.items():
                if got != want:
                    raise AssertionError(f"control: /metrics {what} {got}, "
                                         f"expected {want}")
            phase_sum = sum(family(samples, "duke_cost_device_seconds_total",
                                   **people).values())
            busy = one(samples, "duke_cost_busy_seconds_total") - busy0
            if abs(phase_sum - busy) > 1e-9 * max(busy, 1e-12):
                raise AssertionError(f"control: per-phase cost seconds "
                                     f"{phase_sum} != busy {busy}")
            out["corpus_bytes"] = corpus_tensor_bytes(wl)
            ledger = one(samples, "duke_device_bytes",
                         component="corpus_tensors", **people)
            # the ledger's cross-check: torch.cuda.memory_allocated
            out["allocated"] = memory.live_arrays_bytes()
            if ledger != out["corpus_bytes"] or ledger > out["allocated"]:
                raise AssertionError(
                    f"control: duke_device_bytes corpus_tensors {ledger}, "
                    f"tensors {out['corpus_bytes']}, allocated "
                    f"{out['allocated']}")
            total_mem = torch.cuda.mem_get_info()[1]
            headroom = one(samples, "duke_device_headroom_bytes")
            registered = sum(family(samples, "duke_device_bytes").values())
            if memory.budget_bytes() != (float(total_mem), "device") or \
                    headroom != total_mem - registered:
                raise AssertionError(
                    f"control: headroom {headroom}, card memory {total_mem}, "
                    f"registered {registered}, budget "
                    f"{memory.budget_bytes()}")
            out["headroom"] = headroom
            print(f"control scrape: {out['scrape_ms']} ms for /metrics + "
                  f"/stats; records {CONTROL_RECORDS}, corpus rows "
                  f"{row['records_indexed']}, links {len(rows)}, POST 200s "
                  f"{len(posts)}; per-phase cost seconds {phase_sum} = busy "
                  f"{busy}; corpus_tensors {ledger} bytes (allocated "
                  f"{out['allocated']}), headroom {headroom} of {total_mem} "
                  f"[{line}]", flush=True)

            # 2. the streamed feed against the buffered one
            out["feeds"] = [compare_feeds(port, feed_path, rows, line)]

            # 3. the reload through the corpus snapshot
            fallbacks = sum(family(samples,
                                   "duke_snapshot_fallbacks_total").values())
            out["before_reload"] = memory.live_arrays_bytes()
            status, out["reload_s"] = multipart_post(port, "/config",
                                                     "configfile", xml2)
            if status != 302:
                raise AssertionError(f"control: reload answered {status}")
            new = app.deduplications["people"]
            if new is wl or not wl.closed or new.restore_route != "snapshot":
                raise AssertionError(f"control: reload route "
                                     f"{new.restore_route}")
            new.index.corpus.device_arrays()  # waits for the warm upload
            torch.cuda.synchronize()
            out["after_reload"] = memory.live_arrays_bytes()
            # the replacement corpus is as large as the old one, so a
            # leaked old corpus would add a whole corpus_bytes: half of it
            # is the most the allocator's rounding may explain
            if out["after_reload"] - out["before_reload"] >= \
                    out["corpus_bytes"] // 2:
                raise AssertionError(
                    f"control: device memory {out['before_reload']} before "
                    f"the reload, {out['after_reload']} after: the old "
                    f"corpus ({out['corpus_bytes']} bytes) was not freed")
            samples, _, _ = scrape(port)
            if sum(family(samples, "duke_snapshot_fallbacks_total").values()) \
                    != fallbacks:
                raise AssertionError("control: the reload fell back to a "
                                     "replay")
            if feed(port, feed_path) != rows:
                raise AssertionError("control: the feed changed across the "
                                     "reload")
            ck.reset_launch_counts()
            post(port, path, queries)
            torch.cuda.synchronize()
            out["launches"] = ck.LAUNCHES["myers_tile"]
            if out["launches"] <= 0:
                raise AssertionError("control: Myers W=1 never launched on "
                                     "the rebuilt corpus")
            reloaded_rows = feed(port, feed_path)
            # the feed again, now holding the query POST's links
            out["feeds"].append(compare_feeds(port, feed_path,
                                              reloaded_rows, line))
            if not reloaded_rows:
                raise AssertionError("control: no links after the query "
                                     "POST")
            post(port, "/deduplication/people2/crm", posts[0])

            # 4. a malformed reload keeps the old config
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/config", data=b"<DukeMicroService>",
                method="POST", headers={"Content-Type": "application/xml"})
            try:
                urllib.request.urlopen(req, timeout=60)
                raise AssertionError("control: a malformed reload answered "
                                     "2xx")
            except urllib.error.HTTPError as e:
                if e.code != 400:
                    raise AssertionError(f"control: malformed reload {e.code}")
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/config",
                                        timeout=60) as resp:
                if resp.read().decode() != xml2:
                    raise AssertionError("control: GET /config lost the "
                                         "config after a failed reload")

            # 5. the probes and a 413
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz",
                                        timeout=60) as resp:
                ready = json.loads(resp.read())
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                        timeout=60) as resp:
                health = json.loads(resp.read())
            if (ready["status"] != "ready" or not ready["checks"][
                    "device_backend"] or health["status"] != "ok"):
                raise AssertionError(f"control: /readyz {ready}, /healthz "
                                     f"{health}")
            with mock.patch.dict(os.environ, {"MAX_REQUEST_BYTES": "1024"}):
                answer = over_limit_post(port, path, 4096)
            if not answer.startswith(b"HTTP/1.1 413"):
                raise AssertionError(f"control: a 4 KiB POST over a 1 KiB "
                                     f"limit answered {answer[:40]!r}")

        # the control app: the same POSTs, never reloaded
        control = DukeApp(parse_config(config_xml({"people": STRESS_SCHEMA})),
                          device=DEVICE, persistent=False)
        with serving(control) as port:
            for body in posts:
                post(port, path, body)
            post(port, path, queries)
            check_same_feed(reloaded_rows, feed(port, feed_path),
                            "control: the query POST after the reload")
    print(f"control: ingest {out['ingest_rps']} records/s ({CONTROL_RECORDS} "
          f"records, durable); scrape {out['scrape_ms']} ms; feeds (links, "
          f"bytes, HTTP/1.1 s at page {CONTROL_FEED_PAGE}, HTTP/1.0 s) "
          f"{out['feeds']}; reload "
          f"{out['reload_s']} s to the 302 (route snapshot, no fallback); "
          f"device memory {out['before_reload']} bytes before the reload, "
          f"{out['after_reload']} after (corpus_tensors "
          f"{out['corpus_bytes']}); headroom {out['headroom']}; myers_tile "
          f"launches {out['launches']} on the rebuilt corpus, links equal to "
          f"the control app's; readyz ready, healthz ok, 413 [{line}]",
          flush=True)


# -- the debug phase: the streamed append, tracing, a capture, explain --------------

DEBUG_RECORDS = 65536
EXPLAIN_RECORDS = 4096


def slices_total():
    from sesam_duke_microservice_tpu_torch import telemetry

    return telemetry.STREAM_APPEND_SLICES.single().value


def get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as resp:
        return resp.status, dict(resp.headers), json.loads(resp.read())


def post_json(port, path, payload, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        method="POST", headers=dict({"Content-Type": "application/json"},
                                    **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=900) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def raw_since(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}?since=0",
                                timeout=900) as resp:
        return resp.read()


def streamed_ingest(app, port, posts, queries, traced, line):
    """POST ``posts`` (the POST at index 1 with a sampled ``traceparent``)
    and the closing query POST; the link clock is a counter, so two apps
    on the same traffic write the same feed bytes.  Returns the numbers,
    the feed bytes and the traced POST's reply headers."""
    from sesam_duke_microservice_tpu_torch.links import base as linkbase
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    path = "/deduplication/people/crm"
    corpus = app.deduplications["people"].index.corpus
    slices, growths, headers = [], [], None
    ticks = iter(range(1_700_000_000_000, 1_800_000_000_000))
    with mock.patch.object(linkbase, "now_millis", lambda: next(ticks)):
        t0 = time.perf_counter()
        for i, body in enumerate(posts):
            s0, cap0 = slices_total(), corpus.capacity
            if i == 1:
                status, headers, _ = post_json(
                    port, path, body, {"traceparent": traced})
                if status != 200:
                    raise AssertionError(f"debug: traced POST {status}")
            else:
                post(port, path, body)
            slices.append(int(slices_total() - s0))
            growths.append(corpus.capacity != cap0)
        rps = sum(map(len, posts)) / (time.perf_counter() - t0)
        ck.reset_launch_counts()
        post(port, path, queries)
        import torch

        torch.cuda.synchronize()
        myers = ck.LAUNCHES["myers_tile"]
    if myers <= 0:
        raise AssertionError("debug: Myers W=1 never launched on the "
                             "closing query POST")
    return dict(rps=rps, slices=slices, growths=growths, myers=myers,
                feed=raw_since(port, "/deduplication/people")), headers


def capture_around_post(port, path, body, line):
    """``POST /debug/profile?seconds=N`` around a query POST sent by
    another thread: the capture's kernels, ``record_function`` ranges and
    the retained host spans it carries on its own row.  Returns (kernel
    names and counts, range names, span names and counts, the POST's
    wall)."""
    from sesam_duke_microservice_tpu_torch.utils import profiling
    seconds = 6
    status, _, info = post_json(port, f"/debug/profile?seconds={seconds}",
                                {})
    if status != 200 or info["capturing"] is None:
        raise AssertionError(f"debug: POST /debug/profile {status} {info}")
    status, _, again = post_json(port, "/debug/profile?seconds=1", {})
    if status != 409:
        raise AssertionError(f"debug: a second capture answered {status}")
    wall = []
    sender = threading.Thread(target=lambda: wall.append(post(port, path,
                                                              body)))
    sender.start()
    sender.join()
    deadline = time.monotonic() + seconds + 30
    while get_json(port, "/debug/profile")[2]["capturing"] is not None:
        if time.monotonic() > deadline:
            raise AssertionError("debug: the capture never stopped")
        time.sleep(0.2)
    files = sorted(Path(info["capturing"]["dir"]).glob("capture-*.json"))
    if len(files) != 1:
        raise AssertionError(f"debug: the capture wrote {len(files)} files")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels, ranges, spans = {}, {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        bucket = (spans if e.get("pid") == profiling.SPAN_ROW_PID
                  else kernels if e.get("cat") == "kernel" else ranges
                  if e.get("cat") == "user_annotation" else None)
        if bucket is not None:
            name = e["name"][:60]
            bucket[name] = bucket.get(name, 0) + 1
    return kernels, ranges, spans, wall[0]


def explain_pair_on_card(port, app, workload, id1, id2, line):
    """``POST /explain`` of one pair, with the launches it made; the same
    device breakdown on CPU copies of the pair's tensors (the plain
    versions) within ``certified_f32_margin``.  Returns (the reply, the
    launches, the CPU breakdown, the margin)."""
    import torch

    from sesam_duke_microservice_tpu_torch.engine import explain as X
    from sesam_duke_microservice_tpu_torch.ops import bounds as B
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    status, _, out = post_json(port, "/explain", {
        "name": workload, "id1": id1, "id2": id2})
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in ck.LAUNCHES.items() if v}
    if status != 200:
        raise AssertionError(f"debug: POST /explain {status} {out}")
    index = app.deduplications[workload].index
    cpu_index = types.SimpleNamespace(
        plan=index.plan, schema=index.schema, _extract=index._extract,
        device=torch.device("cpu"))
    r1, r2 = (index.find_record_by_id(i) for i in (id1, id2))
    cpu = X.device_breakdown(cpu_index, r1, r2)
    margin = B.certified_f32_margin(index.plan)
    card = out["device"]
    for a, b in zip(card["per_property"], cpu["per_property"]):
        if abs(a["logit"] - b["logit"]) > margin:
            raise AssertionError(f"debug: {workload} {a['name']} logit "
                                 f"{a['logit']} on the card, {b['logit']} "
                                 f"on CPU copies (margin {margin})")
    for key in ("band_verdict", "decided_path"):
        if card.get(key) != cpu.get(key):
            raise AssertionError(f"debug: {workload} {key} "
                                 f"{card.get(key)} / {cpu.get(key)}")
    return out, launches, wall, margin


def folded_probability(out):
    """``sigmoid`` of the host contributions summed in the fold's order."""
    import math

    total = 0.0
    for prop in out["properties"]:
        total += prop["logit"]
    return 1.0 / (1.0 + math.exp(-total))


def phase_debug(line):
    """The streamed append, request tracing, an on-demand capture and
    ``/explain`` on the card.  Prints the ``debug`` lines."""
    import torch

    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.engine.device_matcher import (
        _to_device,
    )
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.ops import encoder as E
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp

    t_phase = time.perf_counter()
    entities = stresstest_entities(INGEST_RECORDS, 1234, "p")[:DEBUG_RECORDS]
    queries = with_copies(stresstest_entities(INGEST_BATCH, 4321, "q"),
                          entities, 16, 1)
    posts = [entities[s:s + INGEST_BATCH]
             for s in range(0, len(entities), INGEST_BATCH)]
    # the traced POST, second: copies of the first POST's records under
    # new ids (links, so the persist span holds ``links:assert_batch``),
    # on a warm corpus it does not outgrow (``encode.stream_append``)
    posts.insert(1, with_copies(stresstest_entities(INGEST_BATCH, 777, "t"),
                                posts[0], 4, 3))

    # 1. the streamed append in four fresh apps, in the order on (the
    # default), 0, 0, on; the last two stay up for the tensor comparison,
    # and the last serves the tracing and the capture
    runs = []
    with contextlib.ExitStack() as keep:
        for i, label in enumerate(("on", "off", "off", "on")):
            app = stress_app(device=DEVICE)
            stack = contextlib.ExitStack()
            port = stack.enter_context(serving(app))
            tid = f"d{i}" * 16
            with mock.patch.dict(os.environ, {} if label == "on" else
                                 {"DUKE_STREAM_APPEND": "0"}):
                run, headers = streamed_ingest(
                    app, port, posts, queries, f"00-{tid}-{'e2' * 8}-01",
                    line)
            runs.append(dict(run, label=label, app=app, port=port, tid=tid,
                             headers=headers))
            if i < 2:
                stack.close()
            else:
                keep.enter_context(stack)
        off, on = runs[2], runs[3]
        a = on["app"].deduplications["people"].index.corpus
        b = off["app"].deduplications["people"].index.corpus
        da, db = a.device_arrays(), b.device_arrays()
        torch.cuda.synchronize()
        twins = 0
        for prop, tensors in da[0].items():
            for name, t in tensors.items():
                mirror = _to_device(a.feats[prop][name], t.device, prop)
                if not (torch.equal(t, db[0][prop][name])
                        and torch.equal(t, mirror)):
                    raise AssertionError(f"debug: corpus tensor "
                                         f"{prop}.{name} differs")
                twins += 1
        for x, y, host in zip(da[1:], db[1:], (a.row_valid, a.row_deleted,
                                               a.row_group)):
            if not (torch.equal(x, y) and torch.equal(
                    x, _to_device(host, x.device))):
                raise AssertionError("debug: a corpus mask differs")
            twins += 1
        if any(r["feed"] != on["feed"] for r in runs):
            raise AssertionError("debug: the feeds of DUKE_STREAM_APPEND on "
                                 "and 0 differ")
        want = [0 if i == 0 or grew else 4
                for i, grew in enumerate(on["growths"])]
        for r in runs:
            if r["slices"] != (want if r["label"] == "on"
                               else [0] * len(want)):
                raise AssertionError(f"debug: slices a POST {r['slices']} "
                                     f"[{r['label']}], expected {want} on")
        print(f"debug stream append: {sum(map(len, posts))} records in "
              f"{len(posts)} POSTs, four fresh apps: records/s on / 0 / 0 / "
              f"on {[r['rps'] for r in runs]}; slices a POST "
              f"{on['slices']} (0 on the cold POST and on the "
              f"{sum(on['growths'][1:])} that doubled the capacity; none at "
              f"0); feeds byte-identical ({len(on['feed'])} bytes); {twins} "
              f"corpus tensors equal to their twins and the host mirror; "
              f"Myers W=1 launches on the query POST "
              f"{[r['myers'] for r in runs]} [{line}]", flush=True)
        port, headers, trace_id = on["port"], on["headers"], on["tid"]

        # 2. tracing: the sampled POST's tree, its Chrome export, the
        # unsampled requests' digests
        if headers.get("X-Trace-Id") != trace_id:
            raise AssertionError(f"debug: X-Trace-Id {headers}")
        _, _, tree = get_json(port, f"/debug/traces/{trace_id}")
        names = {s["name"] for s in tree["spans"]}
        need = {"POST /deduplication/:name/:datasetId", "sched.queued",
                "sched.microbatch", "ingest.convert", "encode",
                "encode.stream_append", "scan.dispatch", "scan.wait",
                "finalize", "persist", "links:assert_batch"}
        if not need <= names:
            raise AssertionError(f"debug: the trace lacks {need - names}")
        _, _, chrome = get_json(port,
                                f"/debug/traces/{trace_id}?format=chrome")
        digests = get_json(port, "/debug/requests")[2]["requests"]
        unsampled = [d for d in digests if not d["sampled"]
                     and d["name"].startswith("POST /deduplication")]
        if not unsampled:
            raise AssertionError("debug: /debug/requests holds no unsampled "
                                 "POST")
        phases = {s["name"]: round(s["duration_us"] / 1e3, 3)
                  for s in tree["spans"] if s["name"] in need}
        print(f"debug trace: {len(tree['spans'])} spans, "
              f"{tree['duration_ms']} ms; ms by span {phases}; chrome "
              f"{len(chrome['traceEvents'])} events; /debug/requests "
              f"{len(digests)} digests, {len(unsampled)} unsampled POSTs "
              f"[{line}]", flush=True)

        # the slowest requests the tail latch kept (TRACE_SLOW_MS) over
        # the whole script: where their time went, span by span -- the
        # slowest of all, and the slowest of the concurrent-ingest phase's
        # CONCURRENT_POST-record POSTs (its p99)
        slow = sorted((t for t in get_json(port, "/debug/traces")[2][
            "traces"] if t["slow"]), key=lambda t: -t["duration_ms"])
        concurrent = []
        for rank, t in enumerate(slow):
            try:
                spans = get_json(port, f"/debug/traces/{t['trace_id']}")[2][
                    "spans"]
            except urllib.error.HTTPError:  # evicted since the listing
                continue
            queued = [sp for sp in spans if sp["name"] == "sched.queued"]
            mine = (queued and queued[0]["attributes"].get("records")
                    == CONCURRENT_POST)
            if rank > 0 and not (mine and len(concurrent) < 3):
                continue
            concurrent += [t] if mine else []
            ms = {}
            for sp in spans:
                ms[sp["name"]] = round(ms.get(sp["name"], 0.0)
                                       + sp["duration_us"] / 1e3, 3)
            batch = next((sp["attributes"] for sp in spans
                          if sp["name"] == "sched.microbatch"), None)
            batch = (f"its microbatch of {batch['requests']} requests, "
                     f"{batch['records']} records" if batch else
                     "it rode another request's microbatch, whose trace "
                     "holds the engine spans")
            print(f"debug slow trace {t['trace_id']} ({t['name']}, "
                  f"{t['duration_ms']} ms{', a concurrent POST' if mine else ''}"
                  f"): ms by span {ms}; {batch} [{line}]", flush=True)
        print(f"debug slow traces: {len(slow)} retained over the script, "
              f"{len(concurrent)} of them concurrent POSTs printed [{line}]",
              flush=True)

        # 3. an on-demand capture around a query POST from another thread
        kernels, ranges, spans, wall = capture_around_post(
            port, "/deduplication/people/crm",
            with_copies(stresstest_entities(INGEST_BATCH, 999, "r"),
                        entities, 16, 2), line)
        mine = sorted(k for k in ck.LAUNCHES for n in kernels
                      if f"{k}_kernel" in n)
        print(f"debug capture: query POST {wall:.3f} s inside a 6 s "
              f"capture; {sum(kernels.values())} kernels, top "
              f"{sorted(kernels.items(), key=lambda kv: -kv[1])[:8]}; the "
              f"port's kernels {sorted(set(mine))}; record_function ranges "
              f"{sorted(ranges.items())[:12]}; retained host spans on "
              f"their row {sorted(spans.items())[:12]} [{line}]",
              flush=True)
        if "myers_tile" not in mine:
            raise AssertionError("debug: the capture holds no Myers kernel")

    # 4. explain and decisions: the mixed schema, then one ann pair
    mixed = DukeApp(parse_config(config_xml({"mixed": MIXED_SCHEMA})),
                    device=DEVICE, persistent=False)
    with serving(mixed) as port:
        ents = mixed_entities(EXPLAIN_RECORDS, 2024, "x")
        ingest(port, "/deduplication/mixed/crm", ents)
        rows = feed(port, "/deduplication/mixed")
        check_rows(rows, "debug mixed")
        linked = {frozenset((r["entity1"], r["entity2"])) for r in rows}
        first = rows[0]
        pair = ("crm__" + first["entity1"], "crm__" + first["entity2"])
        other = next(f"crm__{e['_id']}" for e in ents[1:]
                     if frozenset((ents[0]["_id"], e["_id"])) not in linked)
        explained = []
        for (id1, id2), want in ((pair, first["confidence"]),
                                 ((f"crm__{ents[0]['_id']}", other), None)):
            out, launches, wall, margin = explain_pair_on_card(
                port, mixed, "mixed", id1, id2, line)
            folded = folded_probability(out)
            if folded != out["probability"] or (
                    want is not None and folded != want):
                raise AssertionError(f"debug: sigmoid of the contributions "
                                     f"{folded!r}, explain "
                                     f"{out['probability']!r}, feed "
                                     f"{want!r}")
            explained.append((id1, id2, out, launches, wall))
            print(f"debug explain [mixed, {'linked' if want else 'unlinked'}"
                  f" {id1} {id2}]: probability {out['probability']!r} "
                  f"(sigmoid of the contributions equal"
                  f"{', and to the feed' if want else ''}); "
                  f"{out['classification']}; band "
                  f"{out['device']['band_verdict']}, decided_path "
                  f"{out['device'].get('decided_path')}; device logit "
                  f"{out['device']['logit']} within {margin} of the CPU "
                  f"copies' per property; launches {launches}; "
                  f"{wall * 1e3:.3f} ms [{line}]", flush=True)
        if not explained[0][3].get("myers_tile") or not explained[0][3].get(
                "jw_tile") or explained[0][3].get("intersect_tile", 0) < 2:
            raise AssertionError(f"debug: the explain call launched "
                                 f"{explained[0][3]}")
        _, _, decisions = get_json(port, "/debug/decisions")
        _, _, stats = get_json(port, "/stats")
        block = stats["workloads"][0].get("decisions")
        if not decisions["decisions"] or not block or not sum(
                block["outcomes"].values()):
            raise AssertionError(f"debug: decisions {len(decisions)} / "
                                 f"{block}")
        print(f"debug decisions: ring {len(decisions['decisions'])} records; "
              f"/stats {block} [{line}]", flush=True)

    with mock.patch.dict(os.environ,
                         {"DEVICE_INITIAL_CAPACITY": str(ANN_CAPACITY)}):
        ann = DukeApp(parse_config(config_xml({"people": STRESS_SCHEMA})),
                      backend="ann", device=DEVICE, persistent=False)
    with serving(ann) as port:
        ents = with_copies(stresstest_entities(EXPLAIN_RECORDS, 55, "a"),
                           stresstest_entities(EXPLAIN_RECORDS, 55, "a"),
                           8, 5)
        ingest(port, "/deduplication/people/crm", ents)
        rows = feed(port, "/deduplication/people")
        check_rows(rows, "debug ann")
        routes0 = dict(E.ROUTES)
        id1, id2 = "crm__" + rows[0]["entity1"], "crm__" + rows[0]["entity2"]
        out, launches, wall, margin = explain_pair_on_card(
            port, ann, "people", id1, id2, line)
        routes = {k: E.ROUTES[k] - routes0[k] for k in E.ROUTES}
        if folded_probability(out) != rows[0]["confidence"]:
            raise AssertionError("debug: ann explain probability differs "
                                 "from the feed's confidence")
        if not out["retrieval"].get("retrieved"):
            raise AssertionError(f"debug: ann retrieval {out['retrieval']}")
        print(f"debug explain [ann {id1} {id2}]: probability "
              f"{out['probability']!r} equal to the feed's; retrieval rank "
              f"{out['retrieval']['rank']} of C "
              f"{out['retrieval']['effective_top_c']}, cosine "
              f"{out['retrieval']['cosine']}, route {routes}; band "
              f"{out['device']['band_verdict']}, decided_path "
              f"{out['device'].get('decided_path')}; launches {launches}; "
              f"{wall * 1e3:.3f} ms [{line}]", flush=True)
    print(f"debug: phase {time.perf_counter() - t_phase:.1f} s [{line}]",
          flush=True)


# -- the kernel phase -------------------------------------------------------------


# -- the selfcheck phase: the arena, the canary prober, numcheck, IVF -----------

# (a) three stresstest tenants of this many records each, under a budget
# of 2.5 tenants; the query POSTs that fault the spilled one back in
ARENA_TENANT_RECORDS = 65536
ARENA_TENANTS = 3
ARENA_BUDGET_TENANTS = 2.5
# the 503 app's budget (MiB): below one 2,048-record stresstest corpus
TINY_BUDGET_MB = 1
# (c) mixed traffic under DUKE_NUMCHECK=1, on / 0 / 0 / on
NUMCHECK_RECORDS = 32768


class LinkClocks:
    """Link clocks keyed by the traffic being sent (``key``: the app and
    the traffic): each key is a counter of its own from one start, so the
    same traffic writes the same timestamps, and so the same feed bytes,
    in any app -- whatever other tenants or probe cycles wrote in
    between."""

    def __init__(self):
        self.key = None
        self._counters = {}

    def __call__(self):
        counter = self._counters.setdefault(
            self.key, iter(range(1_700_000_000_000, 1_800_000_000_000)))
        return next(counter)


def tenant_traffic(i):
    """Tenant ``i``'s 65,536 stresstest records and its query POST (every
    16th query a copy of one of its records)."""
    entities = stresstest_entities(ARENA_TENANT_RECORDS, 1234 + i, f"t{i}")
    queries = with_copies(stresstest_entities(INGEST_BATCH, 4321 + i,
                                              f"u{i}"), entities, 16, 1)
    return entities, queries


def launched_since(before):
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    return {k: v - before.get(k, 0) for k, v in ck.LAUNCHES.items()
            if v - before.get(k, 0)}


@contextlib.contextmanager
def spill_meter(log):
    """Record ``torch.cuda.memory_allocated`` around every arena spill
    (the spill runs inside the admitting tenant's admission, on the
    dispatcher thread): (label, freed bytes, before, after)."""
    import torch

    from sesam_duke_microservice_tpu_torch.engine import device_matcher as DM

    real = DM.DeviceCorpus.spill_device

    def metered(corpus):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        freed = real(corpus)
        torch.cuda.synchronize()
        log.append((corpus.arena_label, freed, before,
                    torch.cuda.memory_allocated()))
        return freed

    with mock.patch.object(DM.DeviceCorpus, "spill_device", metered):
        yield


def arena_check(clocks, line):
    """(a): three tenants under a 2.5-tenant budget; the spilled tenant's
    query POST faults it back in; its feed against a DUKE_ARENA=0 app's;
    the 503 of an app whose budget is smaller than one small corpus.
    Returns the spilled tenant's traffic and feed bytes."""
    import torch

    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.ops.arena import ARENA
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp

    names = [f"t{i}" for i in range(ARENA_TENANTS)]
    traffic = {name: tenant_traffic(i) for i, name in enumerate(names)}
    spills = []
    ARENA._reset_for_tests()
    app = DukeApp(parse_config(config_xml({n: STRESS_SCHEMA
                                           for n in names})),
                  device=DEVICE, persistent=False)
    env = {}
    with serving(app) as port, mock.patch.dict(os.environ, env), \
            spill_meter(spills):
        ck.reset_launch_counts()
        rates = []
        for i, name in enumerate(names):
            clocks.key = ("arena", name)
            _, wall = ingest(port, f"/deduplication/{name}/crm",
                             traffic[name][0])
            rates.append(ARENA_TENANT_RECORDS / wall)
            if i == 0:
                # the budget: 2.5 tenants, from the ledger's lease
                one = app.deduplications[name].index.corpus._device_nbytes()
                leased = ARENA.debug_snapshot()["tiers"]["device"]
                if leased != one:
                    raise AssertionError(f"arena: the ledger leases {leased} "
                                         f"bytes for one tenant of {one}")
                budget_mb = int(ARENA_BUDGET_TENANTS * one / 2**20)
                os.environ["DUKE_HBM_BUDGET_MB"] = str(budget_mb)
        snap = ARENA.debug_snapshot()
        spilled = [r["label"].split("/")[1] for r in snap["leases"]
                   if not r["resident"]]
        if snap["spills"] < 1 or len(spilled) != 1:
            raise AssertionError(f"arena: the third tenant spilled "
                                 f"{spilled} ({snap['spills']} spills)")
        victim = spilled[0]
        faults0 = ARENA.faults
        clocks.key = ("arena", victim)
        path = f"/deduplication/{victim}/crm"
        fault_in_s = post(port, path, traffic[victim][1])
        resident_s = post(port, path, traffic[victim][1])
        torch.cuda.synchronize()
        faults = ARENA.faults - faults0
        launches = dict(ck.LAUNCHES)
        victim_feed = raw_since(port, f"/deduplication/{victim}")
        snap = ARENA.debug_snapshot()
    if faults != 1:
        raise AssertionError(f"arena: {faults} fault-ins for one query POST "
                             "to the spilled tenant")
    for label, freed, before, after in spills:
        if freed <= 0 or before - after < freed:
            raise AssertionError(f"arena: spilling {label} freed {freed} "
                                 f"bytes but memory_allocated fell by "
                                 f"{before - after}")
    if launches.get("myers_tile", 0) <= 0:
        raise AssertionError("arena: Myers W=1 never launched")
    print(f"selfcheck arena: {ARENA_TENANTS} tenants of "
          f"{ARENA_TENANT_RECORDS} records (records/s {rates}), one tenant "
          f"{one} bytes, DUKE_HBM_BUDGET_MB={budget_mb}; spills "
          f"{snap['spills']}, fault-ins {snap['faults']} (the query POST to "
          f"{victim}: 1), admissions {snap['admissions']}; memory_allocated "
          f"around each spill "
          f"{[(l, f, b, a, b - a) for l, f, b, a in spills]} (label, freed, "
          f"before, after, fall); fault-in POST {fault_in_s:.3f} s against "
          f"the same POST resident {resident_s:.3f} s; launches {launches} "
          f"[{line}]", flush=True)

    # the same traffic into an app with the arena off: the feed bytes
    with mock.patch.dict(os.environ, {"DUKE_ARENA": "0", "DUKE_PROBE": "0"}):
        control = stress_app(device=DEVICE)
        with serving(control) as port:
            clocks.key = ("control", victim)
            ingest(port, "/deduplication/people/crm", traffic[victim][0])
            for _ in range(2):
                post(port, "/deduplication/people/crm", traffic[victim][1])
            control_feed = raw_since(port, "/deduplication/people")
    if control_feed != victim_feed:
        got, want = json.loads(victim_feed), json.loads(control_feed)
        raise AssertionError(f"arena: {victim}'s feed differs from the "
                             f"DUKE_ARENA=0 app's on the same traffic "
                             f"({len(got)} rows against {len(want)}; first "
                             f"difference "
                             f"{next(((a, b) for a, b in zip(got, want) if a != b), None)})")

    # a budget below one 2,048-record corpus: a 503 with Retry-After
    with mock.patch.dict(os.environ,
                         {"DUKE_HBM_BUDGET_MB": str(TINY_BUDGET_MB)}):
        tiny = stress_app(device=DEVICE)
        with serving(tiny) as port:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/deduplication/people/crm",
                data=json.dumps(traffic[victim][1]).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=300) as resp:
                    raise AssertionError(f"arena: a {TINY_BUDGET_MB} MiB "
                                         f"budget answered {resp.status}")
            except urllib.error.HTTPError as e:
                status, retry, body = (e.code, e.headers.get("Retry-After"),
                                       e.read().decode())
    if status != 503 or not retry or "HBM budget exhausted" not in body:
        raise AssertionError(f"arena: tiny budget answered {status} "
                             f"Retry-After {retry}: {body}")
    print(f"selfcheck arena: {victim}'s feed byte-identical to a "
          f"DUKE_ARENA=0 app's ({len(victim_feed)} bytes); a "
          f"{TINY_BUDGET_MB} MiB budget answers {status} with Retry-After "
          f"{retry}: {body[:160]}", flush=True)
    ARENA._reset_for_tests()
    return victim, traffic[victim], victim_feed


def cycle_once(app, clocks, what, line):
    """One ``run_cycle`` with its own link clock: every canary verdict must
    equal its oracle verdict, and the shadows may build nothing."""
    import torch

    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.telemetry import costs

    clocks.key = "probe"
    builds = costs.compile_count()
    before = dict(ck.LAUNCHES)
    t0 = time.perf_counter()
    results = app.prober.run_cycle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launched_since(before)
    builds = costs.compile_count() - builds
    bad = {k: r.get("error") or {c: v for c, v in r.get("verdicts", {})
                                 .items() if v["expected"] != v["observed"]}
           for k, r in results.items() if not r["ok"]}
    if not results or bad:
        raise AssertionError(f"prober [{what}]: failed cycles {bad}")
    if builds:
        raise AssertionError(f"prober [{what}]: the shadows ran {builds} "
                             "nvcc / g++ builds")
    canaries = sum(len(r["verdicts"]) for r in results.values())
    print(f"selfcheck prober [{what}]: cycle wall {wall:.3f} s "
          f"({ {'/'.join(k): r['seconds'] for k, r in results.items()} } "
          f"s per workload), {canaries} canary verdicts equal to the oracle's, "
          f"0 builds, launches {launches} [{line}]", flush=True)
    return launches


def prober_check(victim, traffic, want_feed, clocks, line):
    """(b), stresstest: the spilled tenant's traffic again, with probe
    cycles after the ingest and after each query POST (arena off, as in
    the control app): the feed must equal the DUKE_PROBE=0 control's."""
    with mock.patch.dict(os.environ, {"DUKE_ARENA": "0"}):
        app = stress_app(device=DEVICE)
        with serving(app) as port:
            clocks.key = ("probed", victim)
            ingest(port, "/deduplication/people/crm", traffic[0])
            cycle_once(app, clocks, "stresstest, 65,536 records", line)
            for _ in range(2):
                clocks.key = ("probed", victim)
                post(port, "/deduplication/people/crm", traffic[1])
                cycle_once(app, clocks, "stresstest, after a query POST",
                           line)
            got = raw_since(port, "/deduplication/people")
    if got != want_feed:
        raise AssertionError("prober: the user feed with probe cycles "
                             "differs from the DUKE_PROBE=0 app's")
    print(f"selfcheck prober: stresstest user feed byte-identical with "
          f"DUKE_PROBE on (cycles around the user POSTs) and 0 "
          f"({len(got)} bytes)", flush=True)


def numcheck_check(clocks, line):
    """(c): mixed traffic in four fresh apps, DUKE_NUMCHECK on / 0 / 0 /
    on; the on runs must record observations and no violation; every
    feed equal.  (b), mixed: a probe cycle on each on run's full corpus,
    after its feed is read (the 0 runs have DUKE_PROBE=0)."""
    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp
    from sesam_duke_microservice_tpu_torch.utils import numcheck

    entities = mixed_entities(NUMCHECK_RECORDS, 2024, "m")
    kinds = {}
    real = numcheck.observe

    def counted(kind, *args):
        kinds[kind] = kinds.get(kind, 0) + 1
        return real(kind, *args)

    runs = []
    for label in ("on", "0", "0", "on"):
        env = ({"DUKE_NUMCHECK": "1"} if label == "on"
               else {"DUKE_NUMCHECK": "0", "DUKE_PROBE": "0"})
        numcheck.reset()
        kinds.clear()
        with mock.patch.dict(os.environ, env), \
                mock.patch.object(numcheck, "observe", counted):
            app = DukeApp(parse_config(config_xml({"mixed": MIXED_SCHEMA})),
                          device=DEVICE, persistent=False)
            with serving(app) as port:
                clocks.key = ("mixed", len(runs))
                ck.reset_launch_counts()
                _, wall = ingest(port, "/deduplication/mixed/crm", entities)
                launches = dict(ck.LAUNCHES)
                rep = numcheck.report()
                stats = app.deduplications["mixed"].processor.stats
                run = dict(label=label, rps=NUMCHECK_RECORDS / wall,
                           checked=rep["checked"],
                           violations=rep["violations"], kinds=dict(kinds),
                           certified=stats.pairs_device_certified,
                           feed=raw_since(port, "/deduplication/mixed"),
                           launches=launches)
                if label == "on" and len(runs) == 0:
                    cycle_once(app, clocks, "mixed, 32,768 records", line)
        runs.append(run)
    numcheck.reset()
    for run in runs:
        if run["label"] == "on" and (run["violations"]
                                     or run["checked"] <= 0):
            raise AssertionError(f"numcheck: {run['checked']} checked, "
                                 f"violations {run['violations'][:3]}")
        if run["label"] == "0" and run["checked"]:
            raise AssertionError("numcheck: observations with the knob at 0")
        if run["feed"] != runs[0]["feed"]:
            raise AssertionError("numcheck: the feeds of DUKE_NUMCHECK on "
                                 "and 0 differ")
    on = [r for r in runs if r["label"] == "on"]
    print(f"selfcheck numcheck: mixed {NUMCHECK_RECORDS} records, "
          f"DUKE_NUMCHECK on / 0 / 0 / on: records/s "
          f"{[r['rps'] for r in runs]}; checked events "
          f"{[r['checked'] for r in on]} (by kind {[r['kinds'] for r in on]}"
          f": 'reject' = the sampled certified rejects, 'event' = the "
          f"certified events), certified rejects "
          f"{[r['certified'] for r in runs]}, 0 violations; feeds "
          f"byte-identical ({len(runs[0]['feed'])} bytes); launches "
          f"{runs[0]['launches']} [{line}]", flush=True)


def ivf_check(clocks, line, device_rows):
    """(d): the ann phase's corpus and traffic with DUKE_IVF=1 against
    the flat ann app (phase_ann) and the brute-force feed (slice 1)."""
    import numpy as np
    import torch

    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.engine import ann_matcher as AM
    from sesam_duke_microservice_tpu_torch.engine import device_matcher as DM
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.ops import ivf as IVF
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp

    entities = stresstest_entities(INGEST_RECORDS, 1234, "p")
    queries = with_copies(stresstest_entities(QUERY_BATCH, 4321, "q"),
                          entities, 16, 1)
    trains = []
    real_train = IVF.IvfState._train

    def timed_train(state, corpus):
        t0 = time.perf_counter()
        real_train(state, corpus)
        trains.append((corpus.size, time.perf_counter() - t0))

    fallbacks = [0]
    real_flat = AM._AnnScorerCache._scorer

    def counted_flat(cache, *args):
        if cache.index.ivf is not None and cache.index.ivf.ready:
            fallbacks[0] += 1
        return real_flat(cache, *args)

    with mock.patch.dict(os.environ, {"DEVICE_INITIAL_CAPACITY":
                                      str(ANN_CAPACITY), "DUKE_IVF": "1"}):
        app = DukeApp(parse_config(config_xml({"people": STRESS_SCHEMA})),
                      backend="ann", device=DEVICE, persistent=False)
    with serving(app) as port, \
            mock.patch.object(IVF.IvfState, "_train", timed_train), \
            mock.patch.object(AM._AnnScorerCache, "_scorer", counted_flat):
        people = app.deduplications["people"]
        clocks.key = "ivf"
        ck.reset_launch_counts()
        esc = dict(DM.ESCALATIONS)
        _, ingest_s = ingest(port, "/deduplication/people/crm", entities)
        ingest_fallbacks = fallbacks[0]
        query_s = post(port, "/deduplication/people/crm", queries)
        launches = dict(ck.LAUNCHES)
        escalations = {k: DM.ESCALATIONS[k] - esc[k] for k in esc}
        query_fallbacks = fallbacks[0]
        rows = feed(port, "/deduplication/people")
        ivf = people.index.ivf
        corpus = people.index.corpus
        # train twice on the card on the last training's rows
        n = ivf.trained_rows
        live = np.flatnonzero(corpus.row_valid[:n] & ~corpus.row_deleted[:n])
        x = ivf._embeddings_f32(corpus, live)
        twice = [IVF.train_kmeans(x, ivf.ncells, seed=ivf.seed,
                                  iters=ivf.iters, device=DEVICE)
                 for _ in range(2)]
        torch.cuda.synchronize()
        cells, nprobe0, bucket = ivf.ncells, ivf.nprobe0, ivf.bucket
        same_as_state = np.array_equal(twice[0], ivf.centroids)
        # the device time, as for the flat app: a second, identical query
        # POST under the profiler, after the feed and the counts were read
        _, query_trace = profiled_post(port, "/deduplication/people/crm",
                                       queries)
    if not np.array_equal(twice[0], twice[1]):
        raise AssertionError("ivf: two k-means trainings on the card gave "
                             "different centroids")
    if not same_as_state:
        raise AssertionError("ivf: a training on the live rows differs from "
                             "the index's own")
    if launches.get("myers_gathered", 0) <= 0:
        raise AssertionError("ivf: the gathered Myers kernel never launched")
    oracle = {r["_id"]: r["confidence"] for r in device_rows
              if not r["_deleted"]}
    got = {r["_id"]: r["confidence"] for r in rows}
    stray = [k for k, v in got.items() if oracle.get(k) != v]
    if stray:
        raise AssertionError(f"ivf: {len(stray)} links not in the "
                             f"brute-force feed with equal confidence, e.g. "
                             f"{[(k, got[k], oracle.get(k)) for k in stray[:3]]}")
    flat = {r["_id"]: r["confidence"] for r in ANN_FLAT["rows"]}
    flat_trace = ANN_FLAT["query_trace"]
    print(f"selfcheck ivf: {INGEST_RECORDS} records (capacity "
          f"{corpus.capacity}) in {ingest_s:.3f} s "
          f"({INGEST_RECORDS / ingest_s:.1f} records/s); trainings "
          f"{[(size, round(s, 3)) for size, s in trains]} (rows, s), "
          f"{sum(s for _, s in trains):.3f} s in all; auto policy: {cells} "
          f"cells, nprobe {nprobe0}, membership width {bucket}; escalations "
          f"{escalations}, flat-fallback scans {query_fallbacks} "
          f"({ingest_fallbacks} during the ingest); query POST "
          f"({QUERY_BATCH} records) {query_s:.3f} s, device busy "
          f"{query_trace['busy_ms']:.3f} ms (a second, identical POST "
          f"under the profiler), against the flat ann app's "
          f"{ANN_FLAT['query_s']:.3f} s, {flat_trace['busy_ms']:.3f} ms; "
          f"launches {launches} [{line}]", flush=True)
    print(f"selfcheck ivf: {len(got)} links, all in the brute-force feed "
          f"with equal confidences; recall {len(set(got) & set(flat)) / max(1, len(flat)):.4f} "
          f"of the flat scan's {len(flat)} links, "
          f"{len(got) / max(1, len(oracle)):.4f} of the brute-force "
          f"oracle's {len(oracle)}; two k-means trainings on the card "
          f"({len(live)} rows, {cells} cells) equal bit for bit and to the "
          f"index's centroids [{line}]", flush=True)
    return launches


def phase_selfcheck(line, device_rows):
    """The arena, the canary prober, the certified-numerics sanitizer and
    IVF retrieval on the card, at production knobs.  Returns the launch
    counts of each part."""
    from sesam_duke_microservice_tpu_torch.links import base as linkbase

    t0 = time.perf_counter()
    clocks = LinkClocks()
    with mock.patch.object(linkbase, "now_millis", clocks):
        victim, traffic, victim_feed = arena_check(clocks, line)
        prober_check(victim, traffic, victim_feed, clocks, line)
        numcheck_check(clocks, line)
        launches = ivf_check(clocks, line, device_rows)
    print(f"selfcheck: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# -- the mesh phase: the single-process mesh on logical shards of one card -----

# four logical shards on cuda:0 (engine.sharded_matcher.set_serving_devices):
# they run one after the other, so the phase proves the layout, the global
# row offsets, the merge, the survivor gather and the ring on the card, and
# measures no scaling
MESH_SHARDS = 4
MESH_MIXED_RECORDS = 16384
MESH_ANN_RECORDS = 65536
# each shard must hold the single-device ann app's capacity for the fused
# route to take its local shape (the bins / top-C gate of
# encoder.fused_route); the bins then hold the same rows on both apps
MESH_ANN_CAPACITY = MESH_SHARDS * ANN_CAPACITY


def mesh_traffic(app, port, name, entities, queries, clocks, key):
    """Drive one app of the mesh phase: ``entities`` in INGEST_BATCH-record
    POSTs, then the ``queries`` POST if any, the launch counts set to 0
    just before and read just after; returns what the phase compares."""
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.ops import encoder as E

    path = f"/deduplication/{name}/crm"
    clocks.key = key
    with recording_shapes() as shapes:
        for route in E.ROUTES:
            E.ROUTES[route] = 0
        ck.reset_launch_counts()
        latencies, ingest_s = ingest(port, path, entities)
        query_s = post(port, path, queries) if queries else None
        launches = dict(ck.LAUNCHES)
        routes = dict(E.ROUTES)
    body = raw_since(port, f"/deduplication/{name}")
    samples, _, _ = scrape(port)
    wl = app.deduplications[name]
    return dict(rps=len(entities) / ingest_s, ingest_s=ingest_s,
                p50=statistics.median(latencies), query_s=query_s,
                launches=launches, routes=routes, feed=body,
                rows=json.loads(body), samples=samples,
                shapes={k: dict(sorted(v.items()))
                        for k, v in shapes.items() if v},
                capacity=wl.index.corpus.capacity,
                certified=wl.processor.stats.pairs_device_certified)


def mesh_twins(stack, label, name, schema, entities, queries, clocks,
               backends, envs=(None, None)):
    """The traffic through a fresh app of each of ``backends`` (the mesh
    app first); the mesh app stays served in ``stack``, its twin is
    closed.  Returns (mesh run, its port, twin run)."""
    runs, port0 = [], None
    for backend, env in zip(backends, envs):
        app = mesh_app(name, schema, backend, env)
        if not runs:
            port0 = stack.enter_context(serving(app))
            runs.append((app, mesh_traffic(app, port0, name, entities,
                                           queries, clocks, (label, backend))))
            continue
        with serving(app) as port:
            runs.append((app, mesh_traffic(app, port, name, entities,
                                           queries, clocks, (label, backend))))
    (first, mesh), (_, twin) = runs
    return first, mesh, port0, twin


def mesh_app(name, schema, backend, env):
    """A fresh app of ``backend`` serving ``name``, built under ``env``."""
    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp

    with mock.patch.dict(os.environ, env or {}):
        return DukeApp(parse_config(config_xml({name: schema})),
                       backend=backend, device=DEVICE, persistent=False)


def mesh_rematch(app, port, twin, clocks, line):
    """(4) ``POST /deduplication/people/rematch`` on the stresstest mesh
    app: 200 with the mesh's shards and the live rows as its queries; the
    links it emits equal the device twin's feed, and the feed after it is
    the feed before it (a rematch of an intact store asserts nothing
    new)."""
    wl = app.deduplications["people"]
    emitted = {}

    class Recorder:
        def batch_ready(self, size):
            pass

        def batch_done(self):
            pass

        def no_match_for(self, record):
            pass

        def matches(self, r1, r2, confidence):
            a, b = sorted((r1.record_id, r2.record_id))
            emitted[f"{a}_{b}".replace(":", "_")] = confidence

        matches_perhaps = matches

    before = raw_since(port, "/deduplication/people")
    live = wl.index.live_records
    recorder = Recorder()
    wl.processor.add_match_listener(recorder)
    clocks.key = ("mesh", "rematch")
    try:
        t0 = time.perf_counter()
        status, _, stats = post_json(port, "/deduplication/people/rematch",
                                     [])
        wall = time.perf_counter() - t0
    finally:
        wl.processor.listeners.remove(recorder)
    after = raw_since(port, "/deduplication/people")
    if status != 200:
        raise AssertionError(f"mesh rematch: {status} {stats!r}")
    if stats["devices"] != MESH_SHARDS or stats["queries"] != live:
        raise AssertionError(f"mesh rematch: stats {stats}, expected "
                             f"{MESH_SHARDS} devices and {live} queries")
    want = {r["_id"]: r["confidence"] for r in twin["rows"]
            if not r["_deleted"]}
    if emitted != want:
        raise AssertionError(
            f"mesh rematch: {len(emitted)} links emitted against the device "
            f"feed's {len(want)}; differ e.g. "
            f"{sorted(set(emitted.items()) ^ set(want.items()))[:3]}")
    if after != before:
        raise AssertionError("mesh rematch: the feed changed")
    print(f"mesh rematch: POST /deduplication/people/rematch 200 in "
          f"{wall:.3f} s (host clock): {stats}; the {len(emitted)} links it "
          f"emitted equal the device app's feed, the feed after it equals "
          f"the feed before it [{line}]", flush=True)
    return wall, stats


def phase_mesh(line):
    """The single-process mesh: ``sharded-brute`` and ``sharded`` apps on
    MESH_SHARDS logical shards of cuda:0 beside their single-device twins
    on the same traffic, then the ring rematch.  Returns the launch counts
    of each mesh app's traffic."""
    import torch

    from sesam_duke_microservice_tpu_torch.engine import sharded_matcher as SM
    from sesam_duke_microservice_tpu_torch.links import base as linkbase

    t0 = time.perf_counter()
    card = torch.device("cuda", 0) if DEVICE == "cuda" else DEVICE
    SM.set_serving_devices([card] * MESH_SHARDS)
    clocks = LinkClocks()
    out = {}
    try:
        with mock.patch.object(linkbase, "now_millis", clocks), \
                contextlib.ExitStack() as stack:
            # (1) stresstest sharded-brute at the main path's full width
            entities = stresstest_entities(INGEST_RECORDS, 1234, "p")
            queries = with_copies(stresstest_entities(QUERY_BATCH, 4321, "q"),
                                  entities, 16, 1)
            app, mesh, port, twin = mesh_twins(
                stack, "stress", "people", STRESS_SCHEMA, entities, queries,
                clocks, ("sharded-brute", "device"))
            if mesh["feed"] != twin["feed"]:
                raise AssertionError("mesh stresstest: the sharded-brute feed "
                                     "differs from the device app's")
            check_rows(mesh["rows"], "mesh stresstest")
            if mesh["launches"]["myers_tile"] <= 0:
                raise AssertionError("mesh stresstest: Myers W=1 never "
                                     "launched")
            devices = one(mesh["samples"], "duke_mesh_devices")
            per_shard = one(mesh["samples"],
                            "duke_corpus_capacity_rows_per_shard",
                            workload="people")
            if devices != MESH_SHARDS or per_shard != mesh["capacity"] // \
                    MESH_SHARDS:
                raise AssertionError(f"mesh stresstest: duke_mesh_devices "
                                     f"{devices}, per shard {per_shard}")
            out["stress"] = mesh["launches"]
            print(f"mesh stresstest: {INGEST_RECORDS} records in "
                  f"{INGEST_BATCH}-record POSTs and the {QUERY_BATCH}-record "
                  f"query POST on {MESH_SHARDS} logical shards of cuda:0: "
                  f"sharded-brute {mesh['rps']:.1f} records/s (p50 POST "
                  f"{mesh['p50'] * 1e3:.1f} ms), query POST "
                  f"{mesh['query_s']:.3f} s; device {twin['rps']:.1f} "
                  f"records/s (p50 {twin['p50'] * 1e3:.1f} ms), query POST "
                  f"{twin['query_s']:.3f} s; feeds byte-identical "
                  f"({len(mesh['feed'])} bytes, {len(mesh['rows'])} links); "
                  f"duke_mesh_devices {devices:.0f}, "
                  f"duke_corpus_capacity_rows_per_shard {per_shard:.0f} of "
                  f"{mesh['capacity']}; launches {mesh['launches']}, "
                  f"wrapper calls by local shape {mesh['shapes']} [{line}]",
                  flush=True)
            # (4) the ring rematch on (1)'s app, while it serves
            out["rematch"] = mesh_rematch(app, port, twin, clocks, line)
            stack.close()

            # (2) mixed sharded-brute: every scan kernel, dd on every block
            entities = mixed_entities(MESH_MIXED_RECORDS, 2024, "m")
            app, mesh, _, twin = mesh_twins(
                stack, "mixed", "mixed", MIXED_SCHEMA, entities, None,
                clocks, ("sharded-brute", "device"))
            gathers = one(mesh["samples"], "duke_mesh_dd_gathers_total",
                          workload="mixed")
            rows_moved = one(mesh["samples"],
                             "duke_mesh_dd_gather_rows_total",
                             workload="mixed")
            stack.close()
            if mesh["feed"] != twin["feed"]:
                raise AssertionError("mesh mixed: the sharded-brute feed "
                                     "differs from the device app's")
            check_rows(mesh["rows"], "mesh mixed")
            for kernel in ("myers_tile", "jw_tile", "intersect_tile",
                           "myers_gathered"):
                if mesh["launches"][kernel] <= 0:
                    raise AssertionError(f"mesh mixed: {kernel} never "
                                         "launched")
            if gathers <= 0 or mesh["certified"] <= 0:
                raise AssertionError(f"mesh mixed: {gathers} dd gathers, "
                                     f"{mesh['certified']} certified")
            out["mixed"] = mesh["launches"]
            print(f"mesh mixed: {MESH_MIXED_RECORDS} records: sharded-brute "
                  f"{mesh['rps']:.1f} records/s, device {twin['rps']:.1f}; "
                  f"feeds byte-identical ({len(mesh['rows'])} links); dd "
                  f"survivor gathers {gathers:.0f} ({rows_moved:.0f} rows to "
                  f"the lead shard), certified rejects {mesh['certified']} "
                  f"(device app {twin['certified']}); launches "
                  f"{mesh['launches']}, wrapper calls by local shape "
                  f"{mesh['shapes']} [{line}]", flush=True)

            # (3) stresstest sharded (ann) against the single-device ann
            entities = stresstest_entities(MESH_ANN_RECORDS, 1234, "p")
            app, mesh, _, twin = mesh_twins(
                stack, "ann", "people", STRESS_SCHEMA, entities, None,
                clocks, ("sharded", "ann"),
                envs=({"DEVICE_INITIAL_CAPACITY": str(MESH_ANN_CAPACITY)},
                      {"DEVICE_INITIAL_CAPACITY": str(ANN_CAPACITY)}))
            stack.close()
            sharded = {r["_id"]: r["confidence"] for r in mesh["rows"]}
            missing = [r["_id"] for r in twin["rows"]
                       if sharded.get(r["_id"]) != r["confidence"]]
            if missing or not twin["rows"]:
                raise AssertionError(f"mesh ann: {len(missing)} of the ann "
                                     f"app's {len(twin['rows'])} links not "
                                     f"in the sharded feed with equal "
                                     f"confidence, e.g. {missing[:3]}")
            for kernel in ("retrieval_segmax", "myers_gathered"):
                if mesh["launches"][kernel] <= 0:
                    raise AssertionError(f"mesh ann: {kernel} never "
                                         "launched")
            out["ann"] = mesh["launches"]
            print(f"mesh ann: {MESH_ANN_RECORDS} stresstest records: "
                  f"sharded (capacity {mesh['capacity']}, "
                  f"{mesh['capacity'] // MESH_SHARDS} a shard) "
                  f"{mesh['rps']:.1f} records/s, {len(mesh['rows'])} links; "
                  f"ann (capacity {twin['capacity']}) {twin['rps']:.1f} "
                  f"records/s, {len(twin['rows'])} links, every one in the "
                  f"sharded feed with an equal confidence; retrieval routes "
                  f"sharded {mesh['routes']} / ann {twin['routes']}; "
                  f"launches {mesh['launches']} (segment max "
                  f"{mesh['launches']['retrieval_segmax']} against the ann "
                  f"app's {twin['launches']['retrieval_segmax']}), wrapper "
                  f"calls by local shape {mesh['shapes']} [{line}]",
                  flush=True)

            # (3b) a measurement, not a check: the same traffic on a
            # sharded app holding the ann app's capacity split over the
            # shards, as one budget split over D cards would be -- the
            # superset of (3) is shown only at equal local capacity
            # (parallel/ann_sharded.py)
            split_app = mesh_app("people", STRESS_SCHEMA, "sharded",
                                 {"DEVICE_INITIAL_CAPACITY":
                                  str(ANN_CAPACITY)})
            with serving(split_app) as port:
                split = mesh_traffic(split_app, port, "people", entities,
                                     None, clocks, ("ann", "sharded-split"))
            check_rows(split["rows"], "mesh ann split")
            split_links = {r["_id"]: r["confidence"] for r in split["rows"]}
            twin_links = {r["_id"]: r["confidence"] for r in twin["rows"]}
            lost = sum(split_links.get(k) != v for k, v in twin_links.items())
            extra = sum(k not in twin_links for k in split_links)
            out["ann_split"] = dict(lost=lost, extra=extra,
                                    links=len(split_links),
                                    routes=split["routes"])
            print(f"mesh ann split: the same {MESH_ANN_RECORDS} records on "
                  f"sharded at capacity {split['capacity']} "
                  f"({split['capacity'] // MESH_SHARDS} a shard): "
                  f"{split['rps']:.1f} records/s, {len(split_links)} links; "
                  f"{lost} of the ann app's {len(twin_links)} links missing "
                  f"or at another confidence, {extra} links the ann app "
                  f"lacks; retrieval routes {split['routes']}, launches "
                  f"{split['launches']} [{line}]", flush=True)
    finally:
        SM.set_serving_devices(None)
    torch.cuda.synchronize()
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


MULTIHOST_LOCAL_SHARDS = 2
MULTIHOST_RECORDS = {"sharded-brute": 65536, "sharded": 16384}
MULTIHOST_CHILD = REPO / "tests" / "torch_multihost_serving_child.py"
# each child's own limit: the group's start-up, its traffic and its exit
MULTIHOST_CHILD_TIMEOUT_S = 240


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_group(backend, env, report_dir):
    """Start the two processes of a serving group on cuda:0, each with
    MULTIHOST_LOCAL_SHARDS logical shards (a global mesh of twice as
    many): rank 0 the HTTP frontend, rank 1 the follower with its replica
    read plane.  The kernels were built before the spawn (phase 1), so
    the children only load them.  Returns (procs, frontend port, replica
    port, report paths)."""
    http, replica, coordinator = free_port(), free_port(), free_port()
    child_env = dict(os.environ, **(env or {}))
    child_env.update(CONFIG_STRING=config_xml({"people": STRESS_SCHEMA}),
                     DUKE_DISPATCH_HOST="127.0.0.1",
                     DUKE_REPLICA_HTTP_PORT=str(replica),
                     PYTHONPATH=str(REPO))
    reports = [report_dir / f"rank{r}.json" for r in (0, 1)]
    procs = []
    for r in (0, 1):
        # the child keeps its own copy of the log's descriptor
        with open(report_dir / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(MULTIHOST_CHILD), str(r),
                 f"127.0.0.1:{coordinator}", str(http), backend,
                 "--shards", str(MULTIHOST_LOCAL_SHARDS), "--device", DEVICE,
                 "--ephemeral", "--counter-clock", "--report",
                 str(reports[r])],
                env=child_env, stdout=subprocess.DEVNULL, stderr=log,
                cwd=str(REPO)))
    deadline = time.monotonic() + MULTIHOST_CHILD_TIMEOUT_S
    while True:
        for p in procs:
            if p.poll() is not None:
                raise AssertionError(
                    f"multihost {backend}: a child exited {p.returncode} at "
                    f"start-up: {multihost_log(report_dir)}")
        try:
            if all(urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/readyz", timeout=5).status
                    == 200 for port in (http, replica)):
                return procs, http, replica, reports
        except OSError:
            pass
        if time.monotonic() > deadline:
            raise AssertionError(f"multihost {backend}: the group never "
                                 f"came up: {multihost_log(report_dir)}")
        time.sleep(0.2)


def multihost_log(report_dir):
    return " | ".join(
        f"rank {r}: " + (report_dir / f"rank{r}.log").read_text()[-2000:]
        for r in (0, 1) if (report_dir / f"rank{r}.log").exists())


def multihost_stop(procs, reports, report_dir, backend):
    """SIGTERM the frontend (its dispatcher sends the follower the
    shutdown op); both must exit 0.  Returns both processes' reports."""
    import signal

    procs[0].send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=MULTIHOST_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"multihost {backend}: a child did not "
                                 f"exit: {multihost_log(report_dir)}")
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(
            f"multihost {backend}: exit codes {[p.returncode for p in procs]}"
            f": {multihost_log(report_dir)}")
    return [json.loads(r.read_text()) for r in reports]


def multihost_run(backend, clocks, line, report_dir):
    """One backend: its traffic through a single-process app of the same
    backend on 2 * MULTIHOST_LOCAL_SHARDS logical shards of cuda:0 (the
    twin), then through the two-process group; the checks of the phase.
    Returns the group's per-process launch counts."""
    from sesam_duke_microservice_tpu_torch.engine import sharded_matcher as SM

    n = MULTIHOST_RECORDS[backend]
    entities = stresstest_entities(n, 2718, "h")
    entities = with_copies(entities, entities[: n // 2], 16, 3)
    env = ({"DEVICE_INITIAL_CAPACITY": str(MESH_ANN_CAPACITY)}
           if backend == "sharded" else None)
    card = "cuda:0" if DEVICE == "cuda" else DEVICE
    SM.set_serving_devices([card] * (2 * MULTIHOST_LOCAL_SHARDS))
    try:
        app = mesh_app("people", STRESS_SCHEMA, backend, env)
        with serving(app) as port:
            twin = mesh_traffic(app, port, "people", entities, None, clocks,
                                ("multihost", backend))
    finally:
        SM.set_serving_devices(None)

    t0 = time.perf_counter()
    procs, http, replica, reports = multihost_group(backend, env, report_dir)
    started = time.perf_counter() - t0
    try:
        path = "/deduplication/people"
        latencies, wall = ingest(http, f"{path}/crm", entities)
        body = raw_since(http, path)
        if body != twin["feed"]:
            raise AssertionError(
                f"multihost {backend}: the group's feed ({len(body)} bytes) "
                f"differs from the single-process app's "
                f"({len(twin['feed'])} bytes)")
        rows = json.loads(body)
        check_rows(rows, f"multihost {backend}")
        t1 = time.monotonic()
        while True:  # the links ops carry no handshake: poll the replica
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{replica}{path}?since=0",
                    timeout=120) as resp:
                lag, got = resp.headers.get("X-Replica-Lag"), resp.read()
            if got == body and lag == "0":
                break
            if time.monotonic() - t1 > 30:
                raise AssertionError(
                    f"multihost {backend}: the replica feed ({len(got)} "
                    f"bytes, lag {lag}) never caught up with the frontend's")
            time.sleep(0.05)
        caught_up = time.monotonic() - t1
        samples, _, _ = scrape(http)
        followers = one(samples, "duke_dispatch_followers")
        evictions = one(samples, "duke_follower_evictions_total")
        down = one(samples, "duke_dispatch_down")
        if (followers, evictions, down) != (1, 0, 0):
            raise AssertionError(
                f"multihost {backend}: duke_dispatch_followers {followers}, "
                f"duke_follower_evictions_total {evictions}, "
                f"duke_dispatch_down {down}")
        rematch = None
        if backend == "sharded-brute":
            live = sum(not r["_deleted"] for r in rows)
            t2 = time.perf_counter()
            status, _, stats = post_json(http, f"{path}/rematch", [])
            rematch = (time.perf_counter() - t2, stats)
            if (status != 200 or stats["devices"] != 2 * MULTIHOST_LOCAL_SHARDS
                    or stats["queries"] != n or stats["events"] != live):
                raise AssertionError(f"multihost rematch: {status} {stats}, "
                                     f"expected {live} events")
            if raw_since(http, path) != body:
                raise AssertionError("multihost rematch: the feed changed")
    except BaseException:
        for p in procs:
            p.kill()
        print(f"multihost {backend}: children's logs: "
              f"{multihost_log(report_dir)}", flush=True)
        raise
    front, follower = multihost_stop(procs, reports, report_dir, backend)
    kernels = sorted(set(front["launches"]) | set(follower["launches"]))
    per = {k: (front["launches"].get(k, 0), follower["launches"].get(k, 0))
           for k in kernels}
    if any(a != b for a, b in per.values()):
        raise AssertionError(f"multihost {backend}: the processes launched "
                             f"the kernels unequally: {per}")
    needed = (("myers_tile",) if backend == "sharded-brute"
              else ("retrieval_segmax", "myers_gathered"))
    for k in needed:
        if per.get(k, (0, 0))[0] <= 0:
            raise AssertionError(f"multihost {backend}: {k} never launched")
    if front["backend"] != "gloo" or follower["backend"] != "gloo":
        raise AssertionError(f"multihost {backend}: collective backend "
                             f"{front['backend']} / {follower['backend']}")
    print(f"multihost {backend}: {n} stresstest records (every 16th a copy) "
          f"in {INGEST_BATCH}-record POSTs; two processes on cuda:0 x "
          f"{MULTIHOST_LOCAL_SHARDS} logical shards each (global mesh "
          f"{2 * MULTIHOST_LOCAL_SHARDS}), collective backend "
          f"{front['backend']}, group up in {started:.1f} s: "
          f"{n / wall:.1f} records/s, p50 POST "
          f"{statistics.median(latencies) * 1e3:.1f} ms; the single-process "
          f"{backend} app on {2 * MULTIHOST_LOCAL_SHARDS} logical shards "
          f"{twin['rps']:.1f} records/s, p50 POST {twin['p50'] * 1e3:.1f} "
          f"ms; feeds byte-identical ({len(body)} bytes, {len(rows)} links); "
          f"the follower's replica feed byte-identical at X-Replica-Lag 0, "
          f"{caught_up:.2f} s after the frontend's; duke_dispatch_followers "
          f"{followers:.0f}, duke_follower_evictions_total {evictions:.0f}"
          + (f"; POST {path}/rematch through the group in "
             f"{rematch[0]:.3f} s (host clock): {rematch[1]}, its "
             f"{rematch[1]['events']} links the feed's, the feed unchanged"
             if rematch else "")
          + f" [{line}]", flush=True)
    print(f"multihost {backend} launches (process 0 / process 1): "
          + ", ".join(f"{k} {a} / {b}" for k, (a, b) in per.items())
          + f"; collectives process 0 {front['collectives']}, process 1 "
          f"{follower['collectives']} [{line}]", flush=True)
    return per


def phase_multihost(line):
    """The two-process serving group on one card: ``sharded-brute`` and
    then ``sharded``, each beside its single-process twin.  Returns the
    launch counts of each backend's group, per process."""
    import tempfile

    import torch

    from sesam_duke_microservice_tpu_torch.links import base as linkbase

    t0 = time.perf_counter()
    clocks = LinkClocks()
    out = {}
    with mock.patch.object(linkbase, "now_millis", clocks), \
            tempfile.TemporaryDirectory() as tmp:
        for backend in MULTIHOST_RECORDS:
            report_dir = Path(tmp) / backend
            report_dir.mkdir()
            out[backend] = multihost_run(backend, clocks, line, report_dir)
    torch.cuda.synchronize()
    print(f"multihost phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# -- the federation tier -------------------------------------------------------

FED_GROUPS = 3
FED_RANGES_PER_GROUP = 4
FED_RECORDS = 65536
FED_MORE_RECORDS = 8192
FED_MOVED_COPIES = 512
FED_PATH = "/deduplication/people"


def fed_feed(port, token):
    """Drain the federated feed from ``token`` one page a GET: (rows, the
    next token, the degraded ranges and Retry-After of the last page)."""
    rows = []
    while True:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{FED_PATH}?since={token}",
                timeout=900) as resp:
            if resp.status != 200:
                raise AssertionError(f"federated feed: {resp.status}")
            rows.extend(json.loads(resp.read()))
            token = resp.headers["X-Fed-Next-Since"]
            degraded = resp.headers.get("X-Fed-Degraded-Ranges")
            retry = resp.headers.get("Retry-After")
            if resp.headers["X-Fed-Drained"] == "true" or degraded:
                return rows, token, degraded, retry


def fed_norm(rows):
    """Feed rows without their timestamps, sorted (the groups' link clocks
    run on their own threads)."""
    return sorted(json.dumps(dict(r, _updated=None), sort_keys=True)
                  for r in rows)


def fed_owner(fed, entities):
    """Each entity's owning range under the live map, by the router's rule
    (``route_key`` of its store record id)."""
    from sesam_duke_microservice_tpu_torch.federation.ranges import route_key

    ds = fed.groups[0].workload("deduplication", "people").datasources["crm"]
    ranges = fed.map.ranges()
    return [next(r for r in ranges
                 if r.contains(route_key(ds.record_id_for_entity(e))))
            for e in entities]


def id_routed(fed, prefix, pred):
    """The first id ``<prefix>_<k>`` whose record id routes to a range that
    ``pred`` accepts."""
    k = 0
    while True:
        cand = {"_id": f"{prefix}_{k}"}
        if pred(fed_owner(fed, [cand])[0]):
            return cand["_id"]
        k += 1


def fed_twins(tmp, batches_per_group):
    """Three standalone durable ``device`` workloads, each fed by
    ``submit_batch`` exactly the sub-batches the map sent its group, in
    order: (their feed rows, Myers W=1 launches, seconds)."""
    import dataclasses

    import torch

    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.engine.workload import (
        build_workload)
    from sesam_duke_microservice_tpu_torch.links.replica import feed_row
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    rows = []
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    for g, subs in enumerate(batches_per_group):
        folder = Path(tmp) / f"twin{g}"
        folder.mkdir()
        sc = parse_config(config_xml({"people": STRESS_SCHEMA},
                                     data_folder=str(folder)))
        wc = dataclasses.replace(sc.deduplications["people"],
                                 data_folder=str(folder))
        wl = build_workload(wc, sc, backend="device", device=DEVICE,
                            persistent=True)
        try:
            for sub in subs:
                if wl.submit_batch("crm", sub) is None:
                    raise AssertionError(f"twin {g}: workload closed")
            wl.link_database.drain()
            rows.extend(feed_row(l, wl.index.find_record_by_id)
                        for l in wl.link_database.get_all_links())
        finally:
            with wl.lock:
                wl.close()
    torch.cuda.synchronize()
    return rows, ck.LAUNCHES["myers_tile"], time.perf_counter() - t0


def fed_single_app(tmp, posts):
    """The same POSTs through one standalone durable ``device`` app:
    (records/s, p50 POST seconds, its links)."""
    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp

    folder = Path(tmp) / "single"
    folder.mkdir()
    app = DukeApp(parse_config(config_xml({"people": STRESS_SCHEMA},
                                          data_folder=str(folder))),
                  device=DEVICE)
    with serving(app) as port:
        t0 = time.perf_counter()
        latencies = [post(port, f"{FED_PATH}/crm", b) for b in posts]
        wall = time.perf_counter() - t0
        links = len(feed_all_pages(port))
    n = sum(len(b) for b in posts)
    return n / wall, statistics.median(latencies), links


def feed_all_pages(port):
    """Every row of a standalone app's feed (``?since=0``, streamed)."""
    return json.loads(raw_since(port, FED_PATH))


def phase_federation(line):
    """Three serving groups of the ``device`` backend on cuda:0 behind the
    partition router (12 ranges), through ``serve_federation`` over HTTP:
    the ingest held against three standalone twins fed the same
    sub-batches, a live range migration under traffic, the ``fed_down``
    and scatter-timeout drills, the fleet rollup and ``/debug/loadmap``;
    then the same POSTs through one standalone app (measured only).
    Returns the launch counts of the federation's ingest."""
    import tempfile

    import torch

    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.federation import Federation
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.service.federation_plane import (
        serve_federation)
    from sesam_duke_microservice_tpu_torch.utils import faults

    t_phase = time.perf_counter()
    entities = stresstest_entities(FED_RECORDS, 3141, "f")
    entities = with_copies(entities, entities[: FED_RECORDS // 2], 16, 5)
    posts = [entities[s:s + INGEST_BATCH]
             for s in range(0, len(entities), INGEST_BATCH)]
    with tempfile.TemporaryDirectory() as tmp:
        sc = parse_config(config_xml({"people": STRESS_SCHEMA},
                                     data_folder=tmp))
        fed = Federation(sc, n_groups=FED_GROUPS, data_folder=tmp,
                         ranges_per_group=FED_RANGES_PER_GROUP,
                         backend="device", device=DEVICE)
        server = serve_federation(fed, port=0)
        port = server.server_address[1]
        try:
            out = federation_traffic(fed, port, entities, posts, tmp, line)
        finally:
            faults.configure(None)
            server.shutdown()
            server.server_close()
            fed.close()
        rps, p50, single_links = fed_single_app(tmp, posts + out["more"])
    torch.cuda.synchronize()
    fed_links = out["links_after_migration"]
    print(f"federation vs one app: the federation {out['rps']:.1f} "
          f"records/s, p50 POST {out['p50'] * 1e3:.1f} ms over "
          f"{FED_RECORDS} records; one standalone durable device app fed the "
          f"same {len(posts) + len(out['more'])} POSTs {rps:.1f} records/s, "
          f"p50 POST {p50 * 1e3:.1f} ms; links after the migration's "
          f"traffic: federation {fed_links}, one app {single_links}, share "
          f"{fed_links / max(1, single_links):.4f} [{line}]", flush=True)
    print(f"federation phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out["launches"]


def federation_traffic(fed, port, entities, posts, tmp, line):
    """The phase's steps 1-4 on a served federation (see
    ``phase_federation``)."""
    import torch

    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.telemetry import heat
    from sesam_duke_microservice_tpu_torch.utils import faults

    # 1. ingest, held against the twins
    owners = fed_owner(fed, entities)
    per_group = [[] for _ in range(FED_GROUPS)]
    for s in range(0, len(entities), INGEST_BATCH):
        subs = {}
        for e, r in zip(entities[s:s + INGEST_BATCH],
                        owners[s:s + INGEST_BATCH]):
            subs.setdefault(r.group, []).append(e)
        for g, sub in subs.items():
            per_group[g].append(sub)
    ck.reset_launch_counts()
    with recording_shapes() as shapes:
        t0 = time.perf_counter()
        latencies = [post(port, f"{FED_PATH}/crm", b) for b in posts]
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    launches = {k: v for k, v in ck.LAUNCHES.items() if v}
    if launches.get("myers_tile", 0) <= 0:
        raise AssertionError(f"federation: myers_tile never launched "
                             f"({launches})")
    rows, token, degraded, _ = fed_feed(port, "")
    if degraded:
        raise AssertionError(f"federation: degraded ranges {degraded}")
    check_rows(rows, "federation")
    twin_rows, twin_myers, twin_s = fed_twins(tmp, per_group)
    if fed_norm(rows) != fed_norm(twin_rows):
        raise AssertionError(
            f"federation: the feed ({len(rows)} rows) differs from the three "
            f"twins' ({len(twin_rows)} rows)")
    if launches["myers_tile"] != twin_myers:
        raise AssertionError(
            f"federation: {launches['myers_tile']} Myers W=1 launches, the "
            f"twins {twin_myers}")
    print(f"federation ingest: {FED_RECORDS} stresstest records (every 16th "
          f"a copy) in {INGEST_BATCH}-record POSTs to {FED_GROUPS} device "
          f"groups x {FED_RANGES_PER_GROUP} ranges on cuda:0: "
          f"{FED_RECORDS / wall:.1f} records/s, p50 POST "
          f"{statistics.median(latencies) * 1e3:.1f} ms; sub-batches per "
          f"group {[len(p) for p in per_group]}, records per group "
          f"{[sum(map(len, p)) for p in per_group]}; feed {len(rows)} rows "
          f"equal to the three twins' ({twin_s:.1f} s); launches {launches}"
          f" (twins' Myers W=1 {twin_myers}); shapes "
          f"{ {k: v for k, v in shapes.items() if v} } [{line}]", flush=True)

    # 2. live migration of the fullest range to the next group, then
    # traffic holding copies of moved records routed into that range
    counts = {}
    for r in owners:
        counts[r.range_id] = counts.get(r.range_id, 0) + 1
    moved_id = max(sorted(counts), key=counts.get)
    src = fed.map.find(moved_id).group
    target = (src + 1) % FED_GROUPS
    moved = [e for e, r in zip(entities, owners) if r.range_id == moved_id]
    t0 = time.perf_counter()
    status, _, result = post_json(port, "/federation/migrate",
                                  {"range": moved_id, "target": target})
    migrate_s = time.perf_counter() - t0
    if status != 200 or result.get("moved_records") != len(moved):
        raise AssertionError(f"federation migrate: {status} {result}, "
                             f"{len(moved)} records in the range")
    _, _, timeline = get_json(port, "/debug/migrations")
    more = stresstest_entities(FED_MORE_RECORDS, 2653, "g")
    rng = random.Random(7)
    copies = []
    for i, k in enumerate(range(0, FED_MORE_RECORDS,
                                FED_MORE_RECORDS // FED_MOVED_COPIES)):
        orig = rng.choice(moved)
        new_id = id_routed(fed, f"mv{i}",
                           lambda r: r.range_id == moved_id)
        more[k] = dict(orig, _id=new_id)
        copies.append((orig["_id"], new_id))
    more_posts = [more[s:s + INGEST_BATCH]
                  for s in range(0, len(more), INGEST_BATCH)]
    for b in more_posts:
        post(port, f"{FED_PATH}/crm", b)
    rows2, token, degraded, _ = fed_feed(port, token)
    full, _, _, _ = fed_feed(port, "")
    if degraded or fed_norm(rows + rows2) != fed_norm(full):
        raise AssertionError(
            f"federation migration: the old token's rows ({len(rows)} + "
            f"{len(rows2)}) differ from a fresh drain ({len(full)})")
    pairs = {frozenset((r["entity1"], r["entity2"])) for r in full}
    missing = [c for c in copies if frozenset(c) not in pairs]
    if missing:
        raise AssertionError(f"federation migration: {len(missing)} copies "
                             f"of moved records did not link, e.g. "
                             f"{missing[:3]}")
    links_after_migration = len(full)
    print(f"federation migration: range {moved_id} ({len(moved)} records) "
          f"group {src} -> {target} in {migrate_s:.3f} s (host clock): "
          f"{result}; then {FED_MORE_RECORDS} records with "
          f"{FED_MOVED_COPIES} copies of moved records: the old token's feed "
          f"continued with {len(rows2)} rows, none lost or duplicated "
          f"({len(full)} in all), every copy linked at the new owner; "
          f"timeline {json.dumps(timeline['migrations'][0]['phases'])} "
          f"[{line}]", flush=True)

    # 3. degraded drills: a dead group, then a scatter timeout
    down = (target + 1) % FED_GROUPS
    down_ranges = sorted(r.range_id for r in fed.map.group_ranges(down))
    drill = stresstest_entities(INGEST_BATCH, 5821, "d")
    # copies of live groups' records under ids routed to the same group,
    # so the live sub-batches write links while group ``down`` is dead
    live = [e for i, (e, r) in enumerate(zip(drill, fed_owner(fed, drill)))
            if r.group != down and i % 16]
    for i, k in enumerate(range(0, INGEST_BATCH, 16)):
        orig = rng.choice(live)
        og = fed_owner(fed, [orig])[0].group
        drill[k] = dict(orig, _id=id_routed(fed, f"dd{i}",
                                            lambda r, og=og: r.group == og))
    faults.configure(f"fed_down={down}")
    try:
        status, retry, body = post_fed(port, drill)
        if (status != 503 or retry is None
                or sorted(body["degraded_ranges"]) != down_ranges):
            raise AssertionError(f"federation fed_down={down}: {status} "
                                 f"Retry-After {retry} {body}")
        rows3, token3, degraded, retry3 = fed_feed(port, token)
        if (degraded is None or sorted(degraded.split(",")) != down_ranges
                or retry3 is None or not rows3):
            raise AssertionError(
                f"federation fed_down={down}: feed page degraded "
                f"{degraded}, Retry-After {retry3}, {len(rows3)} live rows")
    finally:
        faults.configure(None)
    status, _, _ = post_fed(port, drill)
    if status != 200:
        raise AssertionError(f"federation: {status} after fed_down cleared")
    # a group call that outlives DUKE_FED_TIMEOUT answers 503 while its
    # thread runs on; the resend lands idempotently
    slow = fed.groups[down].workload("deduplication", "people")
    real_submit = slow.submit_batch

    def late_submit(*args, **kwargs):
        time.sleep(1.0)
        return real_submit(*args, **kwargs)

    late = stresstest_entities(INGEST_BATCH, 6007, "t")
    with mock.patch.dict(os.environ, {"DUKE_FED_TIMEOUT": "0.2",
                                      "DUKE_FED_RETRIES": "0"}), \
            mock.patch.object(slow, "submit_batch", late_submit):
        status, _, body = post_fed(port, late)
        for t in threading.enumerate():
            if t.name == f"fed-scatter-g{down}":
                t.join(timeout=120)
    if status != 503 or "timed out" not in json.dumps(body):
        raise AssertionError(f"federation scatter timeout: {status} {body}")
    status, _, _ = post_fed(port, late)
    if status != 200:
        raise AssertionError(f"federation: {status} resending after the "
                             "scatter timeout")
    rows4, _, degraded, _ = fed_feed(port, token3)
    full2, _, _, _ = fed_feed(port, "")
    chain = rows + rows2 + rows3 + rows4
    if (degraded or fed_norm(chain) != fed_norm(full2)
            or len({r["_id"] for r in full2}) != len(full2)):
        raise AssertionError(
            f"federation drills: the token chain ({len(chain)} rows) differs "
            f"from a fresh drain ({len(full2)})")
    print(f"federation drills: fed_down={down} answered 503 with its ranges "
          f"{down_ranges} and Retry-After {retry}; a feed page listed them "
          f"while {len(rows3)} live rows flowed; 200 after the fault cleared;"
          f" a scatter timeout (DUKE_FED_TIMEOUT 0.2 s, group {down} held "
          f"1 s) answered 503 and the resend 200; the token chain's "
          f"{len(chain)} rows equal a fresh drain's, no row twice [{line}]",
          flush=True)

    # 4. surfaces: the fleet rollup's device bytes, /debug/loadmap
    samples, _, _ = scrape(port)
    per_group_bytes = {}
    for (name, labels), v in samples.items():
        d = dict(labels)
        if name == "duke_device_bytes" and "group" in d:
            per_group_bytes[d["group"]] = per_group_bytes.get(
                d["group"], 0) + v
    corpora = 0
    for g in fed.groups:
        for wl in g.workloads.values():
            corpora += sum(wl.index.corpus.device_bytes().values())
    allocated = torch.cuda.memory_allocated()
    if (sorted(per_group_bytes) != [str(g) for g in range(FED_GROUPS)]
            or min(per_group_bytes.values()) <= 0
            or sum(per_group_bytes.values()) != corpora
            or allocated < corpora):
        raise AssertionError(
            f"federation rollup: duke_device_bytes by group "
            f"{per_group_bytes}, the corpora {corpora} bytes, "
            f"memory_allocated {allocated}")
    _, _, loadmap = get_json(port, "/debug/loadmap")
    routed = FED_RECORDS + FED_MORE_RECORDS + 4 * INGEST_BATCH
    heat_total = sum(r["records_total"] for r in loadmap["ranges"])
    if (len(loadmap["ranges"]) != FED_GROUPS * FED_RANGES_PER_GROUP
            or loadmap["n_buckets"] != heat.N_BUCKETS
            or heat_total != routed):
        raise AssertionError(
            f"federation loadmap: {len(loadmap['ranges'])} ranges, heat "
            f"{heat_total}, {routed} records routed")
    print(f"federation surfaces: duke_device_bytes by group "
          f"{ {k: int(v) for k, v in sorted(per_group_bytes.items())} } sum "
          f"to the groups' corpora ({corpora} bytes; memory_allocated "
          f"{allocated}); /debug/loadmap {len(loadmap['ranges'])} ranges, "
          f"heat {heat_total} = records routed [{line}]", flush=True)
    return {"launches": launches, "rps": FED_RECORDS / wall,
            "p50": statistics.median(latencies), "more": more_posts,
            "links_after_migration": links_after_migration}


def post_fed(port, body):
    """A federated POST: (status, Retry-After, the JSON body or None)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{FED_PATH}/crm",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=900) as resp:
            return resp.status, None, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        payload = e.read()
        try:
            payload = json.loads(payload)
        except ValueError:
            payload = {"text": payload.decode(errors="replace")}
        return e.code, e.headers.get("Retry-After"), payload


# -- the conformance phase: the independent oracles and the index interface ---

# the goldens' groups that have a device kernel, by comparator class
GOLDENS = REPO / "tests" / "goldens" / "comparator_goldens.json"
GOLDEN_KERNELS = {"levenshtein": "Levenshtein", "jaro_winkler": "JaroWinkler",
                  "qgram_overlap": "QGram", "dice_tokens": "DiceCoefficient",
                  "jaccard_tokens": "JaccardIndex"}
# the demo config's NAME weights: the plan whose certified margin holds
# the goldens' similarities
GOLDEN_LOW, GOLDEN_HIGH = 0.09, 0.93
EXAMPLE_BACKENDS = ("device", "sharded-brute", "sharded", "ann")
CONFORMANCE_RECORDS = 65536
CONFORMANCE_PROBES = 64
CONFORMANCE_DELETES = 4096


def phase_conformance(line):
    """The port held to the repo's two oracles that do not pass through
    either package's engine, and the index interface at a size users run:
    (1) the hand-derived goldens through kernels #1, #3 and #5 on the
    card; (2) the example-config flow over HTTP on ``device``,
    ``sharded-brute`` and ``sharded`` (``[cuda:0] * 4``) and ``ann``
    against the longhand oracle of tests/torch_longhand.py; (3)
    ``find_candidate_matches`` and ``delete`` on a durable ``device`` app
    of 65,536 stresstest records restored from its snapshot, and (4) that
    restored store-backed mirror walked by ``bulk_values`` and by
    ``values()`` in turns."""
    import torch

    t0 = time.perf_counter()
    golden_tiles(line)
    example_flows(line)
    index_interface(line)
    torch.cuda.synchronize()
    print(f"conformance phase: {time.perf_counter() - t0:.1f} s [{line}]",
          flush=True)


def golden_tiles(line):
    """Each golden group as one (Q, C) tile, every query against every
    golden text, through the kernel wrappers on the card: distances and
    counts equal to the plain versions and to the longhand (textbook DP,
    Python set intersection), the Jaro-Winkler tile equal to its plain
    version; the similarity of each golden pair through the scorer's
    ``_property_sim`` within ``certified_f32_margin`` of the golden."""
    import torch

    import torch_longhand as LH
    from sesam_duke_microservice_tpu_torch.core import comparators as C
    from sesam_duke_microservice_tpu_torch.engine.device_matcher import (
        _to_device)
    from sesam_duke_microservice_tpu_torch.ops import bounds as B
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.ops import features as F
    from sesam_duke_microservice_tpu_torch.ops import scoring as S

    with open(GOLDENS) as f:
        goldens = json.load(f)
    ck.reset_launch_counts()
    worst = {}
    for group, name in GOLDEN_KERNELS.items():
        cases = goldens[group]
        v1 = [c["v1"] for c in cases]
        v2 = [c["v2"] for c in cases]
        n = len(cases)
        cmp = getattr(C, name)()
        spec = F.PropertyFeatureSpec(
            name="p", kind=F.feature_kind(cmp), low=GOLDEN_LOW,
            high=GOLDEN_HIGH, comparator=cmp, max_chars=32)
        margin = B.certified_f32_margin(F.SchemaFeatures(device_props=[spec]))
        qf, cf = ({k: _to_device(a, DEVICE) for k, a in
                   F.extract_property(spec, [[v] for v in vs]).items()}
                  for vs in (v1, v2))
        if spec.kind == F.CHARS:
            args = (qf["chars"][:, 0].contiguous(),
                    qf["length"][:, 0].contiguous(),
                    cf["chars"][:, 0].contiguous(),
                    cf["length"][:, 0].contiguous())
            if name == "Levenshtein":
                got = ck.myers_distance_tiles(*args)
                want = ck.myers_distance_tiles_reference(*args)
                longhand = [LH.lev_distance(a, b) for a, b in zip(v1, v2)]
            else:
                equal = torch.zeros((n, n), dtype=torch.bool, device=DEVICE)
                got = ck.jaro_winkler_sim_tiles(*args, equal)
                want = ck.jaro_winkler_sim_tiles_reference(*args, equal)
                longhand = None
        else:
            ids, count = (("grams", "gram_count") if spec.kind == F.GRAM_SET
                          else ("tokens", "token_count"))
            args = (qf[ids][:, 0].contiguous(), qf[count][:, 0].contiguous(),
                    cf[ids][:, 0].contiguous(), cf[count][:, 0].contiguous())
            got = ck.set_intersection_tiles(*args)
            want = ck.set_intersection_tiles_reference(*args)
            split = ((lambda v: {v[i:i + 2] for i in range(len(v) - 1)})
                     if spec.kind == F.GRAM_SET else str.split)
            longhand = [len(set(split(a)) & set(split(b)))
                        for a, b in zip(v1, v2)]
        if not torch.equal(got, want):
            raise AssertionError(f"goldens {group}: the kernel's tile "
                                 f"differs from its plain version")
        if longhand is not None and torch.diagonal(got).tolist() != longhand:
            raise AssertionError(f"goldens {group}: {torch.diagonal(got)} "
                                 f"vs longhand {longhand}")
        sim, _ = S._property_sim(spec, qf, cf)
        sim = torch.diagonal(sim.reshape(n, n)).double().cpu()
        expected = torch.tensor([c["expected"] for c in cases],
                                dtype=torch.float64)
        err = float((sim - expected).abs().max())
        if err > margin:
            raise AssertionError(f"goldens {group}: |sim - golden| {err} "
                                 f"above the margin {margin}")
        worst[group] = (n, err, margin)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    for kernel in ("myers_tile", "jw_tile", "intersect_tile"):
        if launches[kernel] <= 0:
            raise AssertionError(f"goldens: kernel {kernel} never launched")
    print("goldens on the card: " + "; ".join(
        f"{g} {n} cases, max |sim - golden| {e:.3e} (margin {m:.3e})"
        for g, (n, e, m) in worst.items())
        + f"; tiles equal to the plain versions and the longhand; launches "
          f"myers_tile {launches['myers_tile']}, jw_tile "
          f"{launches['jw_tile']}, intersect_tile "
          f"{launches['intersect_tile']} [{line}]", flush=True)


def example_flows(line):
    """Steps 1-5 of the example-config flow (tests/torch_longhand.py) over
    HTTP against the bundled default config on each backend; the mesh
    backends on ``[cuda:0] * 4``."""
    import torch

    import torch_longhand as LH
    from sesam_duke_microservice_tpu_torch.core.config import (
        load_default_config)
    from sesam_duke_microservice_tpu_torch.engine import sharded_matcher as SM
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp

    card = torch.device("cuda", 0) if DEVICE == "cuda" else DEVICE
    for backend in EXAMPLE_BACKENDS:
        mesh = backend.startswith("sharded")
        if mesh:
            SM.set_serving_devices([card] * MESH_SHARDS)
        try:
            with mock.patch.dict(os.environ, {"MIN_RELEVANCE": "0.05"}):
                app = DukeApp(load_default_config(), backend=backend,
                              persistent=False, device=DEVICE)
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            with serving(app) as port:
                out = LH.example_flow(f"http://127.0.0.1:{port}",
                                      subset=backend == "ann")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ck.LAUNCHES)
        finally:
            if mesh:
                SM.set_serving_devices(None)
        need = ("myers_tile" if backend in ("device", "sharded-brute")
                else "myers_gathered")
        if launches[need] <= 0:
            raise AssertionError(f"example flow on {backend}: kernel {need} "
                                 "never launched")
        linkage = sum(not r["_deleted"] for r in out["linkage"])
        dedup = sum(not r["_deleted"] for r in out["dedup"])
        print(f"example flow on {backend}: linkage {linkage} links, dedup "
              f"{dedup}, equal to the longhand sets (confidences within "
              f"{LH.CONFIDENCE_TOL}); longhand pairs missing: linkage "
              f"{out['missing_linkage']}, dedup {out['missing_dedup']}; "
              f"{wall:.2f} s; launches myers_tile {launches['myers_tile']}, "
              f"myers_gathered {launches['myers_gathered']}, "
              f"retrieval_segmax {launches['retrieval_segmax']} [{line}]",
              flush=True)


class PointReads:
    """Counts a record store's point ``get`` calls."""

    def __init__(self, store):
        self.store, self.n = store, 0
        self.real = store.get

    def __enter__(self):
        def get(rid):
            self.n += 1
            return self.real(rid)

        self.store.get = get
        return self

    def __exit__(self, *exc):
        del self.store.get  # back to the class's method
        return False


def index_interface(line):
    """A durable ``device`` app fed 65,536 stresstest records (every 16th
    a copy), closed and restarted from its snapshot, so that its mirror
    is the store-backed ``LazyRecordMap``: two walks of that mirror by
    ``bulk_values`` and two by ``values()`` (walls and point reads); then
    ``find_candidate_matches`` for 64 linked records (each must hold every
    record the feed links it to), 4,096 deletes through the index (the
    live rows drop by exactly that, the masks go up by the incremental
    copy) and a query POST of copies of the deleted records (no link to a
    deleted id).  The deletes come after the restart: an index delete
    leaves the record store holding the rows, so a restart after it
    rightly replays the store instead of restoring the snapshot."""
    import tempfile

    import torch

    from sesam_duke_microservice_tpu_torch import telemetry
    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp
    from sesam_duke_microservice_tpu_torch.store.records import LazyRecordMap

    path = "/deduplication/people/crm"
    entities = stresstest_entities(CONFORMANCE_RECORDS, 2718, "k")
    entities = with_copies(entities, entities[: CONFORMANCE_RECORDS // 2],
                           16, 9)
    with tempfile.TemporaryDirectory(prefix="duke-conformance-") as tmp:
        config = parse_config(config_xml({"people": STRESS_SCHEMA},
                                         data_folder=tmp))
        app = DukeApp(config, backend="device", device=DEVICE)
        with serving(app) as port:
            _, ingest_s = ingest(port, path, entities)
        app = DukeApp(config, backend="device", device=DEVICE)
        wl = app.deduplications["people"]
        if wl.restore_route != "snapshot":
            app.close()
            raise AssertionError(f"conformance: restart took route "
                                 f"{wl.restore_route}, not snapshot")
        with serving(app) as port:
            index = wl.index
            mirror = index.records
            if not isinstance(mirror, LazyRecordMap):
                raise AssertionError("conformance: the restored mirror is "
                                     f"a {type(mirror).__name__}, not "
                                     "store-backed")
            # (4) the bulk walk of the restored mirror against values(),
            # in turns (bulk, values, values, bulk), each from an empty
            # LRU: values() caches what it decodes
            walks = {"bulk_values": [], "values": []}
            rows_of = {}
            for name in ("bulk_values", "values", "values", "bulk_values"):
                mirror._lru.clear()
                with PointReads(mirror._store) as reads:
                    t0 = time.perf_counter()
                    got = {r.record_id: r.to_dict()
                           for r in getattr(mirror, name)()}
                    walks[name].append((time.perf_counter() - t0, reads.n))
                rows_of.setdefault(name, got)
                want_reads = 0 if name == "bulk_values" else len(mirror)
                if reads.n != want_reads or len(got) != len(mirror):
                    raise AssertionError(
                        f"{name} walk: {reads.n} point reads, {len(got)} "
                        f"rows of {len(mirror)}")
            if rows_of["bulk_values"] != rows_of["values"]:
                raise AssertionError("bulk walk: rows differ from values()")
            print(f"bulk walk of the restored mirror ({len(mirror)} records, "
                  f"in turns bulk, values, values, bulk): bulk_values "
                  + ", ".join(f"{s:.3f} s" for s, _ in walks["bulk_values"])
                  + " with 0 point reads; values() "
                  + ", ".join(f"{s:.3f} s" for s, _ in walks["values"])
                  + f" with {len(mirror)} point reads each; rows equal "
                  f"[{line}]", flush=True)

            # (3) the index interface on the restored app
            rows = [r for r in feed(port, "/deduplication/people")
                    if not r["_deleted"]]
            partners = {}
            for r in rows:
                a, b = (f"crm__{r['entity1']}", f"crm__{r['entity2']}")
                partners.setdefault(a, set()).add(b)
                partners.setdefault(b, set()).add(a)
            linked = sorted(partners)
            if len(linked) < CONFORMANCE_DELETES:
                raise AssertionError(f"conformance: only {len(linked)} "
                                     "linked records")
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            with wl.lock:
                for rid in linked[:CONFORMANCE_PROBES]:
                    found = {c.record_id for c in
                             index.find_candidate_matches(mirror[rid])}
                    if not partners[rid] <= found:
                        raise AssertionError(
                            f"find_candidate_matches({rid}) lacks "
                            f"{sorted(partners[rid] - found)[:5]}")
            torch.cuda.synchronize()
            probe_s = time.perf_counter() - t0
            probe_launches = ck.LAUNCHES["myers_tile"]
            corpus = index.corpus
            gone = linked[-CONFORMANCE_DELETES:]
            live = corpus.live_rows
            full = telemetry.CORPUS_FULL_UPLOADS.single().value
            t0 = time.perf_counter()
            with wl.lock:
                for rid in gone:
                    index.delete(mirror[rid])
                delete_s = time.perf_counter() - t0
                after = corpus.live_rows
                if after != live - CONFORMANCE_DELETES:
                    raise AssertionError(
                        f"delete: live rows {live} -> {after}")
                if corpus._dirty_full:
                    raise AssertionError("delete: a full upload is pending")
                corpus.device_arrays()
            if (telemetry.CORPUS_FULL_UPLOADS.single().value != full
                    or corpus._dirty_full or corpus._mask_rows):
                raise AssertionError("delete: the masks were not copied "
                                     "incrementally")
            if any(rid in mirror or rid in index.id_to_row for rid in gone):
                raise AssertionError("delete: a deleted id is still indexed")
            # the query POST: copies of the deleted records under new ids
            before = {r["_id"] for r in rows}
            by_id = {e["_id"]: e for e in entities}
            dead = {rid.split("__", 1)[1] for rid in gone}
            query = [dict(by_id[e], _id=f"z{e}") for e in sorted(dead)]
            ck.reset_launch_counts()
            post_s = post(port, path, query)
            torch.cuda.synchronize()
            post_launches = ck.LAUNCHES["myers_tile"]
            new = [r for r in feed(port, "/deduplication/people")
                   if r["_id"] not in before and not r["_deleted"]]
            bad = [r for r in new if r["entity1"] in dead
                   or r["entity2"] in dead]
            if bad:
                raise AssertionError(f"query POST: {len(bad)} links to "
                                     f"deleted ids, e.g. {bad[:2]}")
            if post_launches <= 0:
                raise AssertionError("query POST: Myers W=1 never launched")
    print(f"index interface at {CONFORMANCE_RECORDS} records (durable "
          f"ingest {ingest_s:.1f} s, restored from the snapshot): "
          f"find_candidate_matches for {CONFORMANCE_PROBES} linked records "
          f"held every feed partner, {probe_s:.3f} s, Myers W=1 launches "
          f"{probe_launches}; {CONFORMANCE_DELETES} deletes {delete_s:.3f} "
          f"s, live rows {live} -> {after}, masks copied "
          f"incrementally (no full upload); query POST of "
          f"{len(query)} copies of the deleted records {post_s:.3f} s, "
          f"{len(new)} new links, none to a deleted id, Myers W=1 launches "
          f"{post_launches} [{line}]", flush=True)


def char_inputs(q, c, l, seed):
    """Small-alphabet chars so matches are real; random lengths with the
    edge cases (empty and full-width patterns and texts) forced in."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    qc = torch.randint(97, 102, (q, l), generator=g, device=DEVICE,
                       dtype=torch.int32)
    cc = torch.randint(97, 102, (c, l), generator=g, device=DEVICE,
                       dtype=torch.int32)
    ql = torch.randint(0, l + 1, (q,), generator=g, device=DEVICE,
                       dtype=torch.int32)
    cl = torch.randint(0, l + 1, (c,), generator=g, device=DEVICE,
                       dtype=torch.int32)
    ql[:3] = torch.tensor([0, l, 1], dtype=torch.int32)
    cl[:3] = torch.tensor([l, 0, l], dtype=torch.int32)
    cc[2] = qc[1]
    pos = torch.arange(l, device=DEVICE)
    qc = torch.where(pos[None, :] < ql[:, None], qc, 0).contiguous()
    cc = torch.where(pos[None, :] < cl[:, None], cc, 0).contiguous()
    return qc, ql, cc, cl


def check_wide_units(name, q, c, l, run, plain):
    """Hold a char-tile kernel, ``run(qc, ql, cc, cl)``, exactly (bit for
    bit) against its plain version on the wide UTF-16 alphabets of
    tests/wide_units.py (units of 256 and up, shared low bytes, surrogates,
    U+0000 inside the length, > 32 distinct units, runs), every row kind
    meeting every other."""
    import torch

    from wide_units import wide_unit_inputs

    qc, ql, cc, cl = (torch.from_numpy(a).to(DEVICE)
                      for a in wide_unit_inputs("all", q + l, q, c, l))
    got = run(qc, ql, cc, cl)
    torch.cuda.synchronize()
    if not torch.equal(got, plain(qc, ql, cc, cl)):
        raise AssertionError(f"{name} differs from its plain version on wide "
                             f"UTF-16 units at {(q, c, l)}")
    print(f"kernel {name} {(q, c, l)}: exact on wide UTF-16 units", flush=True)
    torch.cuda.empty_cache()


def name_inputs(q, c, l):
    """Rows of the stresstest's name column (the bench's first and last
    name pools, 15% perturbed; lowercase letters and a space), as 0-padded
    UTF-16 units: q query rows, then c corpus rows."""
    import torch

    names = [e["name"][:l] for e in stresstest_entities(q + c, 5678, "n")]
    chars = torch.zeros((q + c, l), dtype=torch.int32)
    for i, name in enumerate(names):
        chars[i, :len(name)] = torch.tensor([ord(ch) for ch in name],
                                            dtype=torch.int32)
    lens = torch.tensor([len(name) for name in names], dtype=torch.int32)
    chars, lens = chars.to(DEVICE), lens.to(DEVICE)
    return (chars[:q].contiguous(), lens[:q].contiguous(),
            chars[q:].contiguous(), lens[q:].contiguous())


def gathered_inputs(q, k, l, wide=False):
    """Each query's k candidates drawn from a pool of 4,096 rows of
    ``char_inputs`` (``wide``: of tests/wide_units.py's "all" rows)."""
    import torch

    if wide:
        from wide_units import wide_unit_inputs

        qc, ql, pool, pool_len = (torch.from_numpy(a).to(DEVICE) for a in
                                  wide_unit_inputs("all", q + l, q, 4096, l))
    else:
        qc, ql, pool, pool_len = char_inputs(q, 4096, l, seed=11 + k)
    gen = torch.Generator(device=DEVICE).manual_seed(k)
    pick = torch.randint(0, 4096, (q, k), generator=gen, device=DEVICE)
    return qc, ql, pool[pick].contiguous(), pool_len[pick].contiguous()


def set_inputs(rows, g, seed):
    """Sorted distinct ids (strictly increasing with small steps from a
    small base, so rows intersect) in the first n of g slots, SET_PAD
    after; n from 0 to g with the empty and full sets forced in."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    base = torch.randint(0, 8, (rows, 1), generator=gen, device=DEVICE)
    steps = torch.randint(1, 4, (rows, g), generator=gen, device=DEVICE)
    ids = (base + steps.cumsum(dim=1)).to(torch.int32)
    n = torch.randint(0, g + 1, (rows,), generator=gen, device=DEVICE,
                      dtype=torch.int32)
    n[:2] = torch.tensor([0, g], dtype=torch.int32)
    pos = torch.arange(g, device=DEVICE)
    ids = torch.where(pos[None, :] < n[:, None], ids, SET_PAD).contiguous()
    return ids, n


def bound(nbytes, ops, peak_ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the card's peak rate for their type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def myers_bound(qc, ql, cc, cl, peak_ops, ops_per_word_step=OPS_PER_WORD_STEP,
                ops_per_step=0):
    """Inputs read once and the (Q, C) int32 output written once; a pair
    with a non-empty pattern needs cl text steps of W words."""
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    q, l = qc.shape
    c = cc.shape[0]
    nbytes = 4 * (q * l + q + c * l + c) + 4 * q * c
    steps = float(cl.double().sum()) * float((ql > 0).sum())
    ops = steps * (ops_per_word_step * ck.kernel_words(l) + ops_per_step)
    return bound(nbytes, ops, peak_ops)


def jw_bound(qc, ql, cc, cl, max_prefix, peak_ops, shorter=True):
    """Inputs once, the (Q, C) f32 output once; per pair the lookup-based
    match over min(l1, l2) steps (``shorter=False``: the l1 query chars of
    each pair with a non-empty text, the earlier count), plus the walk
    over this run's matches and the common prefix (both counted by the flat
    ``pairwise`` Jaro)."""
    import torch

    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.ops import pairwise as pw

    q, l = qc.shape
    c = cc.shape[0]
    nbytes = 4 * (q * l + q + c * l + c) + 4 * q * c
    qn, cn = ql.long().clamp(0, l), cl.long().clamp(0, l)
    if shorter:
        chars = float(sum(torch.minimum(qn[s:e, None], cn[None, :]).sum()
                          for s, e in ck.row_blocks(q, c)))
    else:
        chars = float(qn.sum()) * float((cn > 0).sum())
    matches = prefix = 0
    for s, e in ck.row_blocks(q, c * l):
        n = e - s
        c1 = qc[s:e, None].expand(n, c, l).reshape(-1, l)
        l1 = ql[s:e, None].expand(n, c).reshape(-1)
        c2 = cc[None].expand(n, c, l).reshape(-1, l)
        l2 = cl[None].expand(n, c).reshape(-1)
        matches += int(pw.jaro_counts(c1, l1, c2, l2)[0].sum())
        prefix += int(pw.common_prefix_count(c1, c2, l1, l2,
                                             max_prefix=max_prefix).sum())
    ops = (JW_OPS_PER_CHAR * chars + JW_OPS_PER_MATCH * matches
           + JW_OPS_PER_PREFIX * prefix)
    return bound(nbytes, ops, peak_ops)


def gathered_bound(qc, ql, cc, cl, peak_ops):
    """Inputs once (the gathered (Q, K, L) chars dominate), the (Q, K)
    int32 output once; a pair with a non-empty pattern needs cl steps."""
    q, l = qc.shape
    k = cc.shape[1]
    nbytes = 4 * (q * l + q + q * k * l + q * k) + 4 * q * k
    steps = float((cl.double() * (ql > 0).double()[:, None]).sum())
    return bound(nbytes, steps * OPS_PER_WORD_STEP, peak_ops)


def intersect_bound(qg, qn, cg, cn, common, peak_ops, merge=False):
    """Inputs once, the (Q, C) int32 output once; a pair needs min(qn, cn)
    probes (``merge=True``: the merge of two non-empty sorted sets, #{a <=
    max b} + #{b <= max a} - |A ∩ B| steps, the entries each side consumes
    before one runs out -- the earlier count)."""
    import torch

    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    q, g = qg.shape
    c = cg.shape[0]
    nbytes = 4 * (q * g + q + c * g + c) + 4 * q * c
    na = qn.long().clamp(0, g)
    nb = cn.long().clamp(0, g)
    if not merge:
        probes = float(sum(torch.minimum(na[s:e, None], nb[None, :]).sum()
                           for s, e in ck.row_blocks(q, c)))
        return bound(nbytes, INTERSECT_OPS_PER_PROBE * probes, peak_ops)
    qmax = qg.gather(1, (na - 1).clamp_min(0)[:, None])          # (Q, 1)
    cmax = cg.gather(1, (nb - 1).clamp_min(0)[:, None])          # (C, 1)
    a_used = torch.searchsorted(qg, cmax.reshape(1, c).expand(q, c)
                                .contiguous(), right=True)
    b_used = torch.searchsorted(cg, qmax.reshape(1, q).expand(c, q)
                                .contiguous(), right=True).t()
    a_used = torch.minimum(a_used, na[:, None])
    b_used = torch.minimum(b_used, nb[None, :])
    both = (na > 0)[:, None] & (nb > 0)[None, :]
    steps = torch.where(both, a_used + b_used - common.long(), 0)
    return bound(nbytes, MERGE_OPS_PER_STEP * float(steps.double().sum()),
                 peak_ops)


def measure_sets(label, qg, qn, cg, cn, peak_ops):
    """``measure`` for the intersection kernel, and beside it the merge
    count's bound and the torch similarity map's time on its output (the
    map the kernel leaves to torch)."""
    import torch

    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.ops import pairwise as pw

    shape = (qg.shape[0], cg.shape[0], qg.shape[1])
    row = measure(
        f"intersect_tile{label}", shape,
        lambda: ck.set_intersection_tiles(qg, qn, cg, cn),
        lambda: ck.set_intersection_tiles_reference(qg, qn, cg, cn),
        lambda common: intersect_bound(qg, qn, cg, cn, common, peak_ops))
    common = ck.set_intersection_tiles(qg, qn, cg, cn)
    merge_ms, _ = intersect_bound(qg, qn, cg, cn, common, peak_ops,
                                  merge=True)
    equal = torch.zeros(common.shape, dtype=torch.bool, device=DEVICE)
    map_ms = cuda_ms(lambda: pw.sim_from_set_intersection(
        common, qn[:, None], cn[None, :], equal, formula="jaccard"), 10)
    sizes = (f"set sizes: queries mean {float(qn.float().mean()):.1f}, "
             f"corpus mean {float(cn.float().mean()):.1f}")
    print(f"kernel intersect_tile{label} {shape}: merge-count bound "
          f"{merge_ms:.3f} ms ({merge_ms / row['ms']:.1%} of the kernel); "
          f"the torch similarity map on its output {map_ms:.3f} ms; {sizes}",
          flush=True)
    return row


def measure(name, shape, run, plain, bound_of, launch=None):
    """Hold ``run()`` against ``plain()``, time both; one row of numbers:
    ``ms`` one wrapper call a timing (``cuda_ms``), beside it
    ``back_to_back_ms`` (``cuda_ms_back_to_back`` of the wrapper) and,
    where ``launch`` is given (a call of the kernel's C entry point alone,
    its status checked), ``entry_ms``, that call back to back: the
    wrapper's host work, some 25 us a call, outlasts a kernel of a few
    microseconds even back to back."""
    import torch

    got = run()
    torch.cuda.synchronize()
    want = plain()
    if got.dtype == torch.float32:
        err = float((got.double() - want.double()).abs().max()) \
            if got.numel() else 0.0
    else:
        err = int((got.long() - want.long()).abs().max()) \
            if got.numel() else 0
    if err != 0:
        raise AssertionError(f"{name} differs from its plain version at "
                             f"{shape}: max |err| = {err}")
    ms = cuda_ms(run, 10)
    extra = {"back_to_back_ms": cuda_ms_back_to_back(run, 10)}
    if launch is not None:
        extra["entry_ms"] = cuda_ms_back_to_back(launch, 10)
    plain_ms = cuda_ms(plain, 2)
    bound_ms, bound_by = bound_of(got)
    also = ", ".join(f"{k} {v:.4f}" for k, v in extra.items())
    print(f"kernel {name} {shape}: exact, {ms:.4f} ms ({also}; plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms by {bound_by}, "
          f"{bound_ms / ms:.1%} of it)", flush=True)
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, **extra}


def phase_kernels(shapes, real_sets, peak_ops):
    """Every kernel against its plain version at each recorded shape, and
    the intersection kernel again on the mixed workload's own gram and
    token rows (``real_sets``: {G: (qg, qn, cg, cn)}); returns {wrapper:
    {shape: row}}."""
    import torch

    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    rows = {name: {} for name in WRAPPER_SHAPES}
    for q, c, l in sorted(shapes["myers_distance_tiles"]):
        name = f"myers_tile W={ck.kernel_words(l)}"
        qc, ql, cc, cl = char_inputs(q, c, l, seed=q + l)
        rows["myers_distance_tiles"][q, c, l] = measure(
            name, (q, c, l),
            lambda: ck.myers_distance_tiles(qc, ql, cc, cl),
            lambda: ck.myers_distance_tiles_reference(qc, ql, cc, cl),
            lambda _: myers_bound(qc, ql, cc, cl, peak_ops))
        check_wide_units(name, q, c, l, ck.myers_distance_tiles,
                         ck.myers_distance_tiles_reference)
    q, c, l = NAMES_SHAPE
    qc, ql, cc, cl = name_inputs(q, c, l)
    names = measure(
        "myers_tile W=1 (stresstest name rows)", NAMES_SHAPE,
        lambda: ck.myers_distance_tiles(qc, ql, cc, cl),
        lambda: ck.myers_distance_tiles_reference(qc, ql, cc, cl),
        lambda _: myers_bound(qc, ql, cc, cl, peak_ops))
    synthetic = rows["myers_distance_tiles"].get(NAMES_SHAPE)
    if synthetic:
        print(f"myers_tile W=1 at {NAMES_SHAPE}: {synthetic['ms']:.3f} ms on "
              f"the synthetic rows, {names['ms']:.3f} ms on stresstest name "
              "rows", flush=True)
    kw = dict(prefix_scale=0.1, boost_threshold=0.7, max_prefix=4)
    for q, c, l in sorted(shapes["jaro_winkler_sim_tiles"]):
        qc, ql, cc, cl = char_inputs(q, c, l, seed=7 + l)
        cc[::3, :2] = qc[0, :2]               # shared prefixes: the boost
        none = torch.zeros((q, c), dtype=torch.bool, device=DEVICE)
        rows["jaro_winkler_sim_tiles"][q, c, l] = measure(
            "jw_tile", (q, c, l),
            lambda: ck.jaro_winkler_sim_tiles(qc, ql, cc, cl, none, **kw),
            lambda: ck.jaro_winkler_sim_tiles_reference(qc, ql, cc, cl,
                                                        none, **kw),
            lambda _: jw_bound(qc, ql, cc, cl, kw["max_prefix"], peak_ops))
        check_wide_units(
            "jw_tile", q, c, l,
            lambda *t: ck.jaro_winkler_sim_tiles(*t, none, **kw),
            lambda *t: ck.jaro_winkler_sim_tiles_reference(*t, none, **kw))
    for q, k, l in sorted(shapes["myers_distance_gathered"]):
        qc, ql, cc, cl = gathered_inputs(q, k, l)
        out = torch.empty((q, k), dtype=torch.int32, device=DEVICE)
        rows["myers_distance_gathered"][q, k, l] = measure(
            "myers_gathered", (q, k, l),
            lambda: ck.myers_distance_gathered(qc, ql, cc, cl),
            lambda: ck.myers_distance_gathered_reference(qc, ql, cc, cl),
            lambda _: gathered_bound(qc, ql, cc, cl, peak_ops),
            launch=lambda: ck._launched("myers_gathered", ck._kernel(
                "myers_gathered")(
                qc.data_ptr(), ql.data_ptr(), cc.data_ptr(), cl.data_ptr(),
                out.data_ptr(), q, k, l,
                torch.cuda.current_stream().cuda_stream)))
        qc, ql, cc, cl = gathered_inputs(q, k, l, wide=True)
        if not torch.equal(ck.myers_distance_gathered(qc, ql, cc, cl),
                           ck.myers_distance_gathered_reference(qc, ql, cc,
                                                                cl)):
            raise AssertionError("myers_gathered differs from its plain "
                                 f"version on wide UTF-16 units at {(q, k, l)}")
        print(f"kernel myers_gathered {(q, k, l)}: exact on wide UTF-16 units",
              flush=True)
    for q, c, g in sorted(shapes["set_intersection_tiles"]):
        qg, qn = set_inputs(q, g, seed=g)
        cg, cn = set_inputs(c, g, seed=g + 1)
        rows["set_intersection_tiles"][q, c, g] = measure_sets(
            "", qg, qn, cg, cn, peak_ops)
    for g, sets in sorted(real_sets.items()):
        measure_sets(" (mixed final-block rows)", *sets, peak_ops)
    return rows


# -- the segment-max kernel ------------------------------------------------------

# bf16 dense tensor-core operations per clock per SM on Hopper (a multiply
# and an add each; NVIDIA H100 architecture whitepaper: 1,024 dense bf16
# FMA per clock per SM); the peak is that x SMs x the card's max SM clock
BF16_FLOPS_PER_CLOCK_PER_SM = 4096
# one odd shape off the main path, with group filtering on
SEGMAX_ODD = (333, 3 * 1024, 256, 1024, 8, True)


def bf16_peak_flops_per_s() -> float:
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    return BF16_FLOPS_PER_CLOCK_PER_SM * sms * mhz * 1e6


def segmax_inputs(q, n, d, seed):
    """Unit rows in bf16 (queries and corpus), ~5% invalid and ~5%
    tombstoned rows, two groups, half the queries on a row of their own."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def unit(rows):
        x = torch.randn((rows, d), generator=g, device=DEVICE)
        return (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)

    valid = torch.rand((n,), generator=g, device=DEVICE) > 0.05
    deleted = torch.rand((n,), generator=g, device=DEVICE) < 0.05
    group = torch.randint(1, 3, (n,), generator=g, device=DEVICE,
                          dtype=torch.int32)
    qgroup = torch.randint(1, 3, (q,), generator=g, device=DEVICE,
                           dtype=torch.int32)
    qrow = torch.where(torch.rand((q,), generator=g, device=DEVICE) < 0.5,
                       torch.randint(0, n, (q,), generator=g, device=DEVICE),
                       -1).to(torch.int32)
    return unit(q), unit(n), valid, deleted, group, qrow, qgroup


def segmax_bound(q, n, d, seg, peak_flops):
    """Embeddings, the row masks and groups and the query rows and groups
    read once, the (Q, N/seg) f32 + int32 outputs written once; 2 N D Q
    operations at the bf16 dense peak."""
    nbytes = (2 * (q + n) * d + 6 * n + 8 * q) + 8 * q * (n // seg)
    return bound(nbytes, 2.0 * n * d * q, peak_flops)


def measure_segmax(shape, peak_flops, runs=10):
    """Hold the segment-max kernel against its plain version at ``shape``
    (``seg_max`` within the bar, ``seg_arg`` equal where decided), time
    both and the bare bf16 product; one row of numbers."""
    import torch

    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    q, n, d, tc, seg, gf = shape
    args = segmax_inputs(q, n, d, seed=q + seg)
    kw = dict(tc=tc, seg=seg, group_filtering=gf)
    got = ck.retrieval_segmax(*args, **kw)
    torch.cuda.synchronize()
    want = ck.retrieval_segmax_reference(*args, runner_up=True, **kw)
    err, bad = ck.segmax_disagreement(*got, *want, d)
    tol = ck.segmax_tolerance(d)
    if err > tol or bad:
        raise AssertionError(f"retrieval_segmax differs from its plain "
                             f"version at {shape}: max |err| {err} (bar "
                             f"{tol}), {bad} decided bins with another row")
    del want
    ms = cuda_ms(lambda: ck.retrieval_segmax(*args, **kw), runs)
    back_to_back_ms = cuda_ms_back_to_back(
        lambda: ck.retrieval_segmax(*args, **kw), runs)
    plain_ms = cuda_ms(lambda: ck.retrieval_segmax_reference(*args, **kw), 2)
    qe, ce = args[0], args[1]
    matmul_ms = cuda_ms(lambda: torch.matmul(ce, qe.T), runs)
    bound_ms, bound_by = segmax_bound(q, n, d, seg, peak_flops)
    print(f"kernel retrieval_segmax {shape}: max |seg_max err| {err:.3g} "
          f"(bar {tol:.3g}), seg_arg equal where decided; {ms:.3f} ms "
          f"(back_to_back_ms {back_to_back_ms:.4f}; plain "
          f"{plain_ms:.1f} ms, torch.matmul of the bf16 product alone "
          f"{matmul_ms:.3f} ms, bound {bound_ms:.3f} ms by {bound_by}, "
          f"{bound_ms / ms:.1%} of it)", flush=True)
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "back_to_back_ms": back_to_back_ms, "matmul_ms": matmul_ms}


def busiest(calls, pred=lambda s: True):
    """The recorded shape with the most calls (among those ``pred``
    keeps)."""
    return max((n, s) for s, n in calls.items() if pred(s))[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / PACKAGE / "csrc" / "myers_tile.cu").is_file():
        print(f"chip_smoke: {PACKAGE} is not beside this script",
              file=sys.stderr)
        return 2
    # the package, and tests/wide_units.py for the kernel phase's inputs
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    # the canary prober is on (the default) in every app, its background
    # cycle held off so that no phase's launch counts or feeds depend on
    # when it fires; the selfcheck phase runs its cycles by hand
    os.environ.setdefault("DUKE_PROBE_INTERVAL_S", "3600")
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    t_start = time.perf_counter()
    line = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    from sesam_duke_microservice_tpu_torch import native

    t0 = time.perf_counter()
    # the C++ host library builds with g++ while nvcc runs
    with ThreadPoolExecutor(1) as pool:
        host_lib = pool.submit(native.build_library)
        built = ck.build_library()
        host_lib = host_lib.result()
    print(f"build: {sorted(f'csrc/{s}.cu' for s in built)} with nvcc for "
          f"sm_90a, native/duke_native.cpp into {host_lib.name} with g++, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    (launches1, shapes1, device_rows), (launches2, shapes2, real_sets) = \
        phase_main_paths(line)
    launches3, shapes3, ann_rows = phase_ann(line, device_rows)
    _, shapes4 = phase_concurrent(line)
    phase_host_backend(line)

    peak_ops = int32_peak_ops_per_s()
    print(f"int32 ALU peak: {peak_ops / 1e12:.2f} Top/s ({INT32_LANES_PER_SM}"
          f" lanes x {torch.cuda.get_device_properties(0).multi_processor_count}"
          f" SMs x max SM clock) [{line}]", flush=True)
    shapes = {name: {} for name in WRAPPER_SHAPES}
    for recorded in (shapes1, shapes2, shapes4):
        for name, calls in recorded.items():
            for s, n in calls.items():
                shapes[name][s] = shapes[name].get(s, 0) + n
    myers = dict(shapes["myers_distance_tiles"])
    chunk = max(c for _, c, _ in myers)
    for l in EXTRA_WIDTHS:
        myers.setdefault((EXTRA_Q, chunk, l), 0)
    rows = phase_kernels(dict(shapes, myers_distance_tiles=myers), real_sets,
                         peak_ops)
    peak_flops = bf16_peak_flops_per_s()
    print(f"bf16 dense peak: {peak_flops / 1e12:.1f} TFLOP/s "
          f"({BF16_FLOPS_PER_CLOCK_PER_SM} flops/clock/SM x "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs x "
          f"max SM clock) [{line}]", flush=True)
    segmax_rows = {shape: measure_segmax(shape, peak_flops)
                   for shape in sorted(shapes3["retrieval_segmax"])}
    measure_segmax(SEGMAX_ODD, peak_flops, runs=3)
    phase_restart(line, device_rows, ann_rows)
    phase_control(line)
    phase_debug(line)
    phase_selfcheck(line, device_rows)
    phase_mesh(line)
    phase_multihost(line)
    phase_federation(line)
    phase_conformance(line)

    def one_word(s):
        return ck.kernel_words(s[2]) == 1

    picks = {
        "myers_tile": ("myers_distance_tiles",
                       busiest(shapes1["myers_distance_tiles"], one_word),
                       launches1, "myers_tile.cu", 151),
        "myersN_tile": ("myers_distance_tiles",
                        busiest(shapes1["myers_distance_tiles"],
                                lambda s: not one_word(s)),
                        launches1, "myers_tile.cu", 265),
        "jw_tile": ("jaro_winkler_sim_tiles",
                    busiest(shapes2["jaro_winkler_sim_tiles"]),
                    launches2, "jw_tile.cu", 387),
        "myers_gathered": ("myers_distance_gathered",
                           busiest(shapes2["myers_distance_gathered"]),
                           launches2, "myers_gathered.cu", 539),
        "intersect_tile": ("set_intersection_tiles",
                           busiest(shapes2["set_intersection_tiles"]),
                           launches2, "intersect_tile.cu", 653),
    }
    kernels = []
    for name, (wrapper, shape, launches, source, line_no) in picks.items():
        print(f"kernels line: {name} at {shape}", flush=True)
        kernels.append(dict(
            name=name, route="cuda", source=f"{PACKAGE}/csrc/{source}",
            replaces=f"{PALLAS}:{line_no}", launches=launches[name],
            library_ms=None, **rows[wrapper][shape]))
    # no single PyTorch call computes the masked strided segment max: the
    # bare product's time is printed beside it, not reported as library_ms
    shape = busiest(shapes3["retrieval_segmax"])
    print(f"kernels line: retrieval_segmax at {shape}", flush=True)
    row = dict(segmax_rows[shape])
    row.pop("matmul_ms")
    kernels.append(dict(
        name="retrieval_segmax", route="cuda",
        source=f"{PACKAGE}/csrc/retrieval_segmax.cu",
        replaces=f"{PALLAS}:798", launches=launches3["retrieval_segmax"],
        library_ms=None, **row))
    print(f"total wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
