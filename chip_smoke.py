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
7. print the per-kernel JSON line, the card's name and power limit, and
   the result line ``{"ok": true, "device": {...}}`` last.

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


def config_xml(workloads) -> str:
    """``workloads``: {name: schema XML}."""
    body = "".join(
        f'<Deduplication name="{n}" link-database-type="in-memory">'
        f"<duke>{schema}</duke></Deduplication>"
        for n, schema in workloads.items())
    return f"<DukeMicroService>{body}</DukeMicroService>"


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
    with contextlib.ExitStack() as stack:
        for name, key in WRAPPER_SHAPES.items():
            def recording(*args, _wrapper=getattr(ck, name), _key=key,
                          _seen=shapes[name], **kwargs):
                if args[0].is_cuda:
                    k = _key(args, kwargs)
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


SPLIT_FIELDS = ("retrieval_seconds", "compare_seconds", "dd_seconds")


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
    final = stats_since(stats, s0)
    host = final.compare_seconds - final.dd_seconds
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
            times.append((threads, d.compare_seconds - d.dd_seconds))
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
    wait = stats.retrieval_seconds
    final = stats.compare_seconds
    return (f"wall {wall:.3f} s: waiting on the device's block results "
            f"{wait:.3f} s, the dd rescore {stats.dd_seconds:.3f} s, host "
            f"finalization {final - stats.dd_seconds:.3f} s, the rest (HTTP, "
            f"JSON, extraction, upload, kernel launches) "
            f"{wall - wait - final:.3f} s (host clock) [{line}]")


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
        "mixed_oracle": MIXED_SCHEMA})), device="cuda")
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
    with equal confidences.  Returns (launches, shapes)."""
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
                      backend="ann", device="cuda")
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
    print(f"records/s (ann ingest, {INGEST_RECORDS} records in "
          f"{INGEST_BATCH}-record POSTs): {INGEST_RECORDS / ingest_s:.1f} "
          f"[{line}]")
    print(f"ann query POST ({QUERY_BATCH} records): {query_s:.3f} s, "
          f"{query_pairs} pairs rescored [{line}]")
    print(f"p50 POST latency (ann ingest POSTs): "
          f"{statistics.median(latencies) * 1e3:.1f} ms [{line}]")
    print(f"ann ingest {split}; pairs rescored {pairs0}", flush=True)
    for text in host_routes:
        print(text, flush=True)
    return launches, shapes


# -- the kernel phase -------------------------------------------------------------


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
    launches3, shapes3 = phase_ann(line, device_rows)

    peak_ops = int32_peak_ops_per_s()
    print(f"int32 ALU peak: {peak_ops / 1e12:.2f} Top/s ({INT32_LANES_PER_SM}"
          f" lanes x {torch.cuda.get_device_properties(0).multi_processor_count}"
          f" SMs x max SM clock) [{line}]", flush=True)
    shapes = {name: {} for name in WRAPPER_SHAPES}
    for recorded in (shapes1, shapes2):
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
