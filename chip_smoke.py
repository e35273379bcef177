#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build ``csrc/myers_tile.cu`` with nvcc for sm_90a (the build time is
   printed);
2. drive the main path: serve ``DukeApp(device="cuda")`` over HTTP, ingest
   131,072 stresstest records in 2,048-record POSTs, POST one 8,192-record
   query batch, ingest a second workload whose names run 33-120 chars (the
   4-word kernel), read both ``?since=0`` feeds, and check that both
   kernels were launched; re-score the final block of each workload with
   the plain functions on the same tensors (equal ``count_above``,
   ``top_index`` and ``top_logit``); check a 512-record workload's feed
   against a brute-force host oracle.  The (Q, C, L) shapes the kernel
   wrapper saw are recorded;
3. hold the Myers kernel against its plain PyTorch version on the card at
   every shape the main path gave it, plus the 2- and 8-word widths at a
   2,048-query block -- results must be exactly equal -- and time both
   with CUDA events beside the kernel's bound;
4. print the per-kernel JSON line, the card's name and power limit, and
   the result line ``{"ok": true, "device": {...}}`` last.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
PACKAGE = "sesam_duke_microservice_tpu_torch"

# H100 SXM device memory rate (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
# int32 lanes per Hopper SM (NVIDIA H100 architecture whitepaper: 64 INT32
# units per SM); the int32 ALU peak is lanes x SMs x the card's max SM clock
INT32_LANES_PER_SM = 64
# int32 operations the DP needs per 32-bit word per text step: the match
# word's table lookup, then Xv (or), Xh (and, add, carry add, carry shift,
# xor, or), Ph (or, not, or), Mh (and), the Ph and Mh shifts (shift, or,
# carry shift each), Pv (or, not, or) and Mv (and); plus 4 per text step
# for the score update
OPS_PER_WORD_STEP = 22
OPS_PER_STEP = 4

# widths not on this run's main path, held against the plain version at
# the ingest POST's 2,048-query block
EXTRA_WIDTHS = (64, 256)
EXTRA_Q = 2048
INGEST_RECORDS = 131072
INGEST_BATCH = 2048
QUERY_BATCH = 8192
LONG_RECORDS = 16384
ORACLE_RECORDS = 512

SCHEMA_XML = """
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


def config_xml(names) -> str:
    body = "".join(
        f'<Deduplication name="{n}" link-database-type="in-memory">'
        f"<duke>{SCHEMA_XML}</duke></Deduplication>" for n in names)
    return f"<DukeMicroService>{body}</DukeMicroService>"


FIRST = ["ole", "kari", "per", "anne", "nils", "ingrid", "lars", "berit",
         "jan", "liv", "arne", "astrid", "knut", "solveig", "odd", "randi"]
LAST = ["hansen", "johansen", "olsen", "larsen", "andersen", "pedersen",
        "nilsen", "kristiansen", "jensen", "karlsen", "johnsen", "pettersen"]
STREETS = ["holmenkollveien", "stortingsgata", "kirkeveien", "bygdoy alle",
           "karl johans gate", "nordre gate", "tollbugata", "akersgata"]


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
    (after one warm-up call)."""
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


def kernel_inputs(q, c, l, seed):
    """Small-alphabet chars so matches are real; random lengths with the
    edge cases (empty and full-width patterns and texts) forced in."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    qc = torch.randint(97, 102, (q, l), generator=g, device="cuda",
                       dtype=torch.int32)
    cc = torch.randint(97, 102, (c, l), generator=g, device="cuda",
                       dtype=torch.int32)
    ql = torch.randint(0, l + 1, (q,), generator=g, device="cuda",
                       dtype=torch.int32)
    cl = torch.randint(0, l + 1, (c,), generator=g, device="cuda",
                       dtype=torch.int32)
    ql[:3] = torch.tensor([0, l, 1], dtype=torch.int32)
    cl[:3] = torch.tensor([l, 0, l], dtype=torch.int32)
    cc[2] = qc[1]
    pos = torch.arange(l, device="cuda")
    qc = torch.where(pos[None, :] < ql[:, None], qc, 0).contiguous()
    cc = torch.where(pos[None, :] < cl[:, None], cc, 0).contiguous()
    return qc, ql, cc, cl


def kernel_bound(qc, ql, cc, cl, peak_ops):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (inputs read once, the (Q, C) int32 output written once) over the
    memory rate and the int32 operations this data needs over the int32
    ALU peak.  A pair needs cl text steps of W words each; an empty
    pattern needs none (its distance is cl)."""
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    q, l = qc.shape
    c = cc.shape[0]
    words = ck.kernel_words(l)
    nbytes = 4 * (q * l + q + c * l + c) + 4 * q * c
    steps = float(cl.double().sum()) * float((ql > 0).sum())
    ops = steps * (OPS_PER_WORD_STEP * words + OPS_PER_STEP)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels(shapes, peak_ops):
    """Kernel vs plain version at each (Q, C, L) shape; returns the
    measurements by shape."""
    import torch

    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    rows = {}
    for q, c, l in shapes:
        qc, ql, cc, cl = kernel_inputs(q, c, l, seed=q + l)
        got = ck.myers_distance_tiles(qc, ql, cc, cl)
        torch.cuda.synchronize()
        want = ck.myers_distance_tiles_reference(qc, ql, cc, cl)
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            raise AssertionError(
                f"Myers kernel differs from its plain version at Q={q} "
                f"C={c} L={l}: max |err| = {err}")
        ms = cuda_ms(lambda: ck.myers_distance_tiles(qc, ql, cc, cl), 10)
        plain_ms = cuda_ms(
            lambda: ck.myers_distance_tiles_reference(qc, ql, cc, cl), 2)
        bound_ms, bound_by = kernel_bound(qc, ql, cc, cl, peak_ops)
        rows[q, c, l] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"kernel Q={q} C={c} L={l} W={ck.kernel_words(l)}: exact, "
              f"{ms:.3f} ms (plain {plain_ms:.1f} ms, bound {bound_ms:.3f} "
              f"ms by {bound_by}, {bound_ms / ms:.1%} of it)", flush=True)
        del qc, ql, cc, cl, got, want
        torch.cuda.empty_cache()
    return rows


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


def check_rows(rows, what):
    if not rows:
        raise AssertionError(f"{what}: empty feed")
    for r in rows:
        if not (0.0 < r["confidence"] <= 1.0) or r["_deleted"]:
            raise AssertionError(f"{what}: bad feed row {r}")


def oracle_links(workload, entities):
    """Brute-force host oracle: every pair of the batch through the
    port's f64 ``Processor.compare``, thresholded as the service does."""
    from sesam_duke_microservice_tpu_torch.engine.processor import Processor

    records = workload.datasources["crm"].records_for_batch(entities)
    proc = Processor(workload.config.duke)
    threshold = workload.config.duke.threshold
    links = {}
    for i, r1 in enumerate(records):
        for r2 in records[i + 1:]:
            p = proc.compare(r1, r2)
            if p > threshold:
                a, b = sorted((r1.record_id, r2.record_id))
                links[f"{a}_{b}".replace(":", "_")] = p
    return links


def rescore_plain(workload, records):
    """Score ``records`` as one block twice on the workload's device
    tensors -- through the kernels, then with the kernel wrapper swapped
    for its plain version -- and fail unless count_above, top_index and
    top_logit are equal."""
    from sesam_duke_microservice_tpu_torch.engine import device_matcher as DM
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    cache = workload.index.scorer_cache

    def score():
        pending = cache.dispatch_block(records, group_filtering=False)
        count = pending.fetch.result()[0][: len(records)]
        return count, DM.resolve_block(pending)

    with workload.lock:
        k_count, kernel = score()
        with mock.patch.object(ck, "myers_distance_tiles",
                               ck.myers_distance_tiles_reference):
            p_count, plain = score()
    if not ((k_count == p_count).all()
            and (kernel.top_index == plain.top_index).all()
            and (kernel.top_logit == plain.top_logit).all()):
        raise AssertionError(f"{workload.name}: kernel and plain scoring "
                             "disagree on the final block")
    print(f"{workload.name}: final block re-scored with the plain functions:"
          f" equal count_above/top_index/top_logit over {len(records)} "
          f"queries x {workload.index.corpus.capacity} rows", flush=True)


def phase_main_path(line):
    """Drive the port's main path over HTTP on the card; returns the launch
    counts and the wrapper's CUDA calls by (Q, C, L) shape."""
    import torch

    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.engine import device_matcher as DM
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp, serve

    app = DukeApp(parse_config(config_xml(["people", "addresses", "oracle"])),
                  device="cuda")
    server = serve(app, port=0, host="127.0.0.1")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        people = app.deduplications["people"]
        ingest = stresstest_entities(INGEST_RECORDS, 1234, "p")
        queries = with_copies(stresstest_entities(QUERY_BATCH, 4321, "q"),
                              ingest, 16, 1)
        addresses = stresstest_entities(LONG_RECORDS, 99, "a",
                                        long_names=True)
        addresses = with_copies(addresses, addresses[: LONG_RECORDS // 2],
                                8, 2)

        # the kernel wrapper's CUDA calls by shape; the wrapper itself
        # counts the launches
        shapes = {}
        wrapper = ck.myers_distance_tiles

        def recording(qchars, qlen, cchars, clen):
            if qchars.is_cuda:
                key = (qchars.shape[0], cchars.shape[0], qchars.shape[1])
                shapes[key] = shapes.get(key, 0) + 1
            return wrapper(qchars, qlen, cchars, clen)

        with mock.patch.object(ck, "myers_distance_tiles", recording):
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            latencies = [post(port, "/deduplication/people/crm",
                              ingest[s:s + INGEST_BATCH])
                         for s in range(0, INGEST_RECORDS, INGEST_BATCH)]
            ingest_s = time.perf_counter() - t0
            stats = people.processor.stats
            split = (stats.retrieval_seconds, stats.compare_seconds)
            pairs0 = people.processor.stats.pairs_compared
            query_s = post(port, "/deduplication/people/crm", queries)
            query_pairs = people.processor.stats.pairs_compared - pairs0
            for s in range(0, LONG_RECORDS, INGEST_BATCH):
                post(port, "/deduplication/addresses/crm",
                     addresses[s:s + INGEST_BATCH])
            people_rows = feed(port, "/deduplication/people")
            address_rows = feed(port, "/deduplication/addresses")
            launches = dict(ck.LAUNCHES)

        print(f"main path: launches {launches}; wrapper calls by (Q, C, L) "
              f"{dict(sorted(shapes.items()))}", flush=True)
        for name, count in launches.items():
            if count <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     "main path")
        check_rows(people_rows, "people")
        check_rows(address_rows, "addresses")
        widths = {s.name: s.chars
                  for s in app.deduplications["addresses"].index.plan
                  .device_props}
        print(f"feeds: people {len(people_rows)} links, addresses "
              f"{len(address_rows)} links (char widths {widths})",
              flush=True)

        # each workload's final block again (the 1-word kernel on the
        # query POST's last 4,096-query block, the 4-word kernel on the
        # last 2,048-record address POST), kernels vs plain functions on
        # the same device tensors
        rescore_plain(people, people.datasources["crm"].records_for_batch(
            queries[-DM.query_buckets()[-1]:]))
        long_wl = app.deduplications["addresses"]
        rescore_plain(long_wl, long_wl.datasources["crm"].records_for_batch(
            addresses[-INGEST_BATCH:]))

        # a sixth of the batch copies one entity: more candidates per
        # query than the initial top-K, so K-escalation runs too
        oracle_entities = with_copies(
            stresstest_entities(ORACLE_RECORDS, 7, "o"),
            stresstest_entities(1, 8, "x"), 6, 3)
        post(port, "/deduplication/oracle/crm", oracle_entities)
        got = {r["_id"]: r["confidence"]
               for r in feed(port, "/deduplication/oracle")}
        want = oracle_links(app.deduplications["oracle"], oracle_entities)
        if got != want:
            raise AssertionError(
                f"oracle feed differs: {len(got)} links vs {len(want)} "
                f"expected; missing {sorted(set(want) - set(got))[:5]}, "
                f"extra {sorted(set(got) - set(want))[:5]}")
        print(f"oracle: {ORACLE_RECORDS}-record feed equals the host "
              f"oracle ({len(want)} links)", flush=True)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        app.close()
    torch.cuda.synchronize()

    records_per_s = INGEST_RECORDS / ingest_s
    print(f"records/s (ingest, {INGEST_RECORDS} records in "
          f"{INGEST_BATCH}-record POSTs): {records_per_s:.1f} [{line}]")
    print(f"pairs scored/s ({QUERY_BATCH}-record query POST, "
          f"{query_pairs} pairs in {query_s:.3f} s): "
          f"{query_pairs / query_s:.1f} [{line}]")
    print(f"p50 POST latency ({INGEST_BATCH}-record ingest POSTs): "
          f"{statistics.median(latencies) * 1e3:.1f} ms [{line}]")
    print(f"ingest wall {ingest_s:.3f} s: waiting on the device's block "
          f"results {split[0]:.3f} s, host finalization {split[1]:.3f} s, "
          f"the rest (HTTP, JSON, extraction, upload, kernel launches) "
          f"{ingest_s - sum(split):.3f} s (host clock) [{line}]")
    return launches, shapes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / PACKAGE / "csrc" / "myers_tile.cu").is_file():
        print(f"chip_smoke: {PACKAGE} is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    line = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    ck.build_library()
    print(f"build: csrc/myers_tile.cu with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    launches, shapes = phase_main_path(line)

    peak_ops = int32_peak_ops_per_s()
    print(f"int32 ALU peak: {peak_ops / 1e12:.2f} Top/s ({INT32_LANES_PER_SM}"
          f" lanes x {torch.cuda.get_device_properties(0).multi_processor_count}"
          f" SMs x max SM clock) [{line}]", flush=True)
    chunk = max(c for _, c, _ in shapes)
    extra = [(EXTRA_Q, chunk, l) for l in EXTRA_WIDTHS]
    rows = phase_kernels(sorted(set(shapes) | set(extra)), peak_ops)

    def busiest(one_word):
        """The main-path shape of the 1-word (or N-word) kernel with the
        most launches."""
        return max((n, s) for s, n in shapes.items()
                   if (ck.kernel_words(s[2]) == 1) == one_word)[1]

    print(f"kernels line: myers_tile at (Q, C, L) = {busiest(True)}, "
          f"myersN_tile at {busiest(False)}", flush=True)

    source = f"{PACKAGE}/csrc/myers_tile.cu"
    pallas = "sesam_duke_microservice_tpu/ops/pallas_kernels.py"
    kernels = [
        dict(name="myers_tile", route="cuda", source=source,
             replaces=f"{pallas}:151", launches=launches["myers_tile"],
             library_ms=None, **rows[busiest(True)]),
        dict(name="myersN_tile", route="cuda", source=source,
             replaces=f"{pallas}:265", launches=launches["myersN_tile"],
             library_ms=None, **rows[busiest(False)]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
