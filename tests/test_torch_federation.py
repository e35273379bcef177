"""The port's federation tier against the JAX package's (the counterpart of
tests/test_federation.py, the heat cases of tests/test_capacity.py and
tests/test_probes.py::TestRangeProber).

Every case runs the JAX package's function or federation and the port's
on the same inputs in one process: the partition map and its file, the
routing key, the opaque ``?since=`` cursor, the scatter-gather router
(feeds page by page with their tokens, frozen ranges, degraded groups,
the epoch fence and its re-check, the map rollback, transient retries),
live range migration (feeds and links across it, post-migration ingest,
the journal-slice replay, the interrupted resume), the heat map and the
fleet rollup's merge, the ``RangeProber`` under ``fed_down``, and a
federation folder carried from one package to the other.  The router
cases run on the ``host`` backend and, where the corpus matters, on the
``device`` backend at tests/conftest.py's small knobs (the port's plain
kernels on the CPU).

Link clocks are pinned per scatter thread (one counter per group), so the
two packages stamp the same links with the same timestamps whatever the
threads' interleaving: feeds, tokens and maps are held exactly.
"""

import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

import sesam_duke_microservice_tpu.core.config as jconfig
import sesam_duke_microservice_tpu.federation as jfed
import sesam_duke_microservice_tpu.federation.ranges as jranges
import sesam_duke_microservice_tpu.federation.router as jrouter
import sesam_duke_microservice_tpu.links.base as jlinkbase
import sesam_duke_microservice_tpu.service.prober as jprober
import sesam_duke_microservice_tpu.telemetry.heat as jheat
import sesam_duke_microservice_tpu.telemetry.registry as jregistry
import sesam_duke_microservice_tpu.telemetry.rollup as jrollup
import sesam_duke_microservice_tpu.utils.atomicio as jatomicio
import sesam_duke_microservice_tpu.utils.faults as jfaults
import sesam_duke_microservice_tpu_torch.core.config as tconfig
import sesam_duke_microservice_tpu_torch.federation as tfed
import sesam_duke_microservice_tpu_torch.federation.ranges as tranges
import sesam_duke_microservice_tpu_torch.federation.router as trouter
import sesam_duke_microservice_tpu_torch.links.base as tlinkbase
import sesam_duke_microservice_tpu_torch.service.prober as tprober
import sesam_duke_microservice_tpu_torch.telemetry.heat as theat
import sesam_duke_microservice_tpu_torch.telemetry.registry as tregistry
import sesam_duke_microservice_tpu_torch.telemetry.rollup as trollup
import sesam_duke_microservice_tpu_torch.utils.atomicio as tatomicio
import sesam_duke_microservice_tpu_torch.utils.faults as tfaults

from test_federation import FED_XML, duplicate_batch, norm
from torch_jax_cache import jax_cache_off  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KIND, NAME, DS = "deduplication", "people", "crm"

JAX = types.SimpleNamespace(
    name="jax", config=jconfig, fed=jfed, ranges=jranges, router=jrouter,
    linkbase=jlinkbase, prober=jprober, heat=jheat, registry=jregistry,
    rollup=jrollup, atomicio=jatomicio, faults=jfaults, kw={})
PORT = types.SimpleNamespace(
    name="port", config=tconfig, fed=tfed, ranges=tranges, router=trouter,
    linkbase=tlinkbase, prober=tprober, heat=theat, registry=tregistry,
    rollup=trollup, atomicio=tatomicio, faults=tfaults,
    kw={"device": "cpu"})
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _no_env_faults():
    for pkg in PKGS:
        pkg.faults.configure("")
    yield
    for pkg in PKGS:
        pkg.faults.configure(None)


def group_clock():
    """Link timestamps from one counter per scatter thread (``fed-scatter-
    g<i>``; every other thread shares one more): deterministic per group
    however the groups' threads interleave."""
    counters = {}
    lock = threading.Lock()

    def now():
        name = threading.current_thread().name
        g = (int(name.rsplit("g", 1)[1]) if name.startswith("fed-scatter-g")
             else 99)
        with lock:
            counters[g] = counters.get(g, 0) + 1
            return 1_700_000_000_000 + g * 10**9 + counters[g]

    return now


@pytest.fixture(autouse=True)
def group_clocks(monkeypatch):
    for pkg in PKGS:
        monkeypatch.setattr(pkg.linkbase, "now_millis", group_clock())


def make_fed(pkg, folder, n_groups=3, ranges_per_group=2, backend="host"):
    sc = pkg.config.parse_config(FED_XML.format(folder=folder),
                                 env={"MIN_RELEVANCE": "0.05"})
    return pkg.fed.Federation(sc, n_groups=n_groups,
                              ranges_per_group=ranges_per_group,
                              backend=backend, **pkg.kw)


def both(tmp_path, fn, **kwargs):
    """``fn(pkg, fed)`` on a fresh federation of each package (each in a
    folder of its own); {package name: result}."""
    out = {}
    for pkg in PKGS:
        fed = make_fed(pkg, tmp_path / pkg.name, **kwargs)
        try:
            out[pkg.name] = fn(pkg, fed)
        finally:
            pkg.faults.configure("")
            fed.close()
    return out


def feed_all(fed, token="", limit=5000):
    """Drain the federated feed: (rows, the final token, [page tokens])."""
    rows, tokens = [], []
    while True:
        page = fed.router.feed_page(KIND, NAME, token, limit)
        rows.extend(page["rows"])
        token = page["next_since"]
        tokens.append(token)
        if page["drained"]:
            return rows, token, tokens


def exact(rows):
    return sorted(json.dumps(r, sort_keys=True) for r in rows)


def owned_links(pkg, fed):
    pmap = fed.map
    out = []
    for g in fed.groups:
        for wl in g.workloads.values():
            for l in wl.link_database.get_all_links():
                if pmap.owner(pkg.ranges.route_key(l.id1)).group == g.idx:
                    out.append((l.id1, l.id2, l.status.value, l.kind.value,
                                round(l.confidence, 12)))
    return sorted(out)


def settle(fed):
    """Drain every group's write-behind link flush: a migration snapshots
    the durable link store and ships what the flusher has not applied
    yet through the journal slice, so without this the split between
    ``moved_links`` and ``replayed_slices`` follows the flusher thread's
    timing (the rows shipped are the same either way)."""
    for g in fed.groups:
        for wl in g.workloads.values():
            wl.link_database.drain()


def record_id(fed, entity):
    ds = fed.groups[0].workload(KIND, NAME).datasources[DS]
    return ds.record_id_for_entity(entity)


# -- the partition map, the routing key, the cursor ---------------------------


def test_route_key_equal_on_ten_thousand_ids():
    rng = np.random.default_rng(15)
    ids = [f"crm__{v}" for v in rng.integers(0, 2**62, 9000)]
    ids += [f"{g}__crm__{v}" for g, v in enumerate(
        rng.integers(0, 2**40, 990))]
    ids += ["", "crm__æøå", "crm__😀", "crm__\x00",
            "crm__" + "x" * 500, "a__b", "1__crm__0", "crm__-1", "crm__ ",
            "crm__\ud800"]
    assert len(ids) == 10000
    assert ([tranges.route_key(i) for i in ids]
            == [jranges.route_key(i) for i in ids])
    assert ([tranges.link_owner_key(i) for i in ids[:100]]
            == [jranges.link_owner_key(i) for i in ids[:100]])


def test_partition_map_file_bytes_equal(tmp_path):
    """Create, freeze, assign, reload: the persisted map is byte-equal
    after every step, each package loads the other's file, and the
    ownership helpers agree."""
    paths = {pkg.name: str(tmp_path / f"{pkg.name}.json") for pkg in PKGS}
    maps = {pkg.name: pkg.ranges.PartitionMap.create(3, 7,
                                                     path=paths[pkg.name])
            for pkg in PKGS}

    def files():
        return [open(paths[p.name], "rb").read() for p in PKGS]

    a, b = files()
    assert a == b
    rids = maps["jax"].range_ids()
    assert maps["port"].range_ids() == rids
    for rid, target in ((rids[0], 2), (rids[4], 0), (rids[4], 1)):
        epochs = [maps[p.name].freeze(rid) for p in PKGS]
        assert epochs[0] == epochs[1]
        a, b = files()
        assert a == b
        epochs = [maps[p.name].assign(rid, target) for p in PKGS]
        assert epochs[0] == epochs[1]
        a, b = files()
        assert a == b
    assert maps["port"].to_json() == maps["jax"].to_json()
    # each package loads the other's file and persists it unchanged
    for src, dst in ((JAX, PORT), (PORT, JAX)):
        loaded = dst.ranges.PartitionMap.load(paths[src.name])
        assert loaded.to_json() == maps[src.name].to_json()
        loaded.freeze(rids[1])
        maps[src.name].freeze(rids[1])
        assert open(paths[src.name], "rb").read() == open(
            paths[src.name], "rb").read()
    keys = [jranges.route_key(f"crm__{i}") for i in range(200)]
    for g in range(3):
        spans = {p.name: p.ranges.owned_spans(maps[p.name].ranges(), g)
                 for p in PKGS}
        assert spans["port"] == spans["jax"]
        assert ([tranges.span_covers(spans["port"], k) for k in keys]
                == [jranges.span_covers(spans["jax"], k) for k in keys])
    assert ([maps["port"].owner(k).range_id for k in keys]
            == [maps["jax"].owner(k).range_id for k in keys])


@pytest.mark.parametrize("ranges, match", [
    ([(0, 10), (11, 1 << 64)], "gap/overlap"),
    ([(0, 10)], "cover"),
    ([(5, 1 << 64)], "cover"),
])
def test_map_validation_errors_equal(ranges, match):
    msgs = []
    for pkg in PKGS:
        with pytest.raises(ValueError, match=match) as exc:
            pkg.ranges.PartitionMap._validate(
                [pkg.ranges.Range(lo, hi, 0) for lo, hi in ranges])
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_cursor_tokens_byte_equal():
    rng = np.random.default_rng(3)
    for _ in range(50):
        n = int(rng.integers(0, 12))
        positions = {f"{int(k):016x}": int(v) for k, v in zip(
            rng.integers(0, 2**63, n), rng.integers(0, 2**45, n))}
        version = int(rng.integers(1, 1000))
        token = jranges.encode_cursor(version, positions)
        assert tranges.encode_cursor(version, positions) == token
        assert tranges.decode_cursor(token) == jranges.decode_cursor(token)
    for token in ("", None, "12345", " 77 "):
        assert tranges.decode_cursor(token) == jranges.decode_cursor(token)
    import base64

    for bad in ("@@@not-base64@@@", base64.urlsafe_b64encode(
            b'{"f": 99, "r": {}}').decode(), "e30="):
        msgs = []
        for pkg in PKGS:
            with pytest.raises(pkg.ranges.BadCursor) as exc:
                pkg.ranges.decode_cursor(bad)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


# -- the heat map and the rollup's merge --------------------------------------


def test_heat_map_and_loadmap_equal():
    """Seeded skewed traffic over a map's ranges: bucket counts, the
    suggested splits, the ``/debug/loadmap`` payload and the scrape family
    are equal; a range whose bounds change starts over."""
    rng = np.random.default_rng(17)
    pmap = jranges.PartitionMap.create(3, 6)
    ranges = pmap.ranges()
    hot = ranges[2]
    keys = list(rng.integers(0, 2**63, 3000).astype(object) * 2)
    keys += [hot.lo + int(v) for v in rng.integers(0, (hot.hi - hot.lo) // 9,
                                                   2000)]
    out = {}
    for pkg in PKGS:
        hm = pkg.heat.HeatMap()
        for k in keys:
            hm.note(next(r for r in ranges if r.contains(k)), k)
        moved = pkg.ranges.Range(ranges[0].lo, ranges[0].hi // 2, 1)
        hm.note(moved, 5)
        fam = pkg.heat.collect_family(hm)
        out[pkg.name] = (hm.snapshot(), pkg.heat.loadmap(hm),
                         pkg.heat.loadmap(None),
                         (fam.name, fam.mtype, fam.help, fam.samples),
                         [pkg.heat.suggest_split(lo, hi, counts)
                          for _r, lo, hi, counts in hm.snapshot()],
                         pkg.heat.suggest_split(5, 6, [1] * 256),
                         pkg.heat.suggest_split(0, 1 << 32, [0] * 256))
    assert out["port"] == out["jax"]
    # range 0's counts started over when its bounds changed
    payload = out["port"][1]
    reset = sum(1 for k in keys if ranges[0].contains(k))
    assert reset > 0
    assert (sum(r["records_total"] for r in payload["ranges"])
            == len(keys) - reset + 1)


def test_merge_groups_equal():
    """The fleet merge over the same per-group snapshots: counters and
    histograms summed key-wise, gauges relabeled ``group=``."""
    rng = np.random.default_rng(5)

    def snaps(pkg, g):
        fs = pkg.registry.FamilySnapshot
        labels = (("kind", "deduplication"), ("workload", "people"))
        return [
            fs("duke_engine_batches_total", "counter", "Batches processed",
               [("", labels, float(rng.integers(0, 9)))]),
            fs("duke_corpus_rows", "gauge", "rows",
               [("", labels + (("state", "live"),), float(g + 1))]),
            fs("duke_engine_phase_seconds", "histogram", "phases",
               [("_bucket", labels + (("le", "0.1"),), float(g)),
                ("_bucket", labels + (("le", "+Inf"),), float(g + 2)),
                ("_sum", labels, 0.5 * g), ("_count", labels, g + 2.0)]),
        ] + ([fs("duke_links_rows", "gauge", "links",
                 [("", labels, 3.0)])] if g == 1 else [])

    state = rng.bit_generator.state
    out = {}
    for pkg in PKGS:
        rng.bit_generator.state = state
        merged = pkg.rollup.merge_groups(
            [(str(g), snaps(pkg, g)) for g in range(3)])
        out[pkg.name] = [(f.name, f.mtype, f.help, f.samples)
                         for f in merged]
    assert out["port"] == out["jax"]


# -- the scatter-gather router ------------------------------------------------


@pytest.mark.parametrize("backend", ["host", "device"])
def test_feed_pages_and_tokens_equal(tmp_path, backend):
    """Three ingest waves over three groups, the feed drained in pages of
    seven: every page's rows (with their timestamps) and token are equal,
    each record lands at the same group, and the map file is byte-equal."""
    def run(pkg, fed):
        for start in (0, 24, 48):
            result = fed.router.submit(KIND, NAME, DS,
                                       duplicate_batch(24, start=start))
            assert result["success"] is True
        pages, token = [], ""
        while True:
            page = fed.router.feed_page(KIND, NAME, token, 7)
            assert len(page["rows"]) <= 7
            pages.append((page["rows"], page["next_since"],
                          page["drained"], page["degraded_ranges"]))
            token = page["next_since"]
            if page["drained"] and not page["rows"]:
                break
        where = {}
        for g in fed.groups:
            wl = g.workload(KIND, NAME)
            for e in duplicate_batch(72):
                rid = record_id(fed, e)
                if wl.record_store.get(rid) is not None:
                    where.setdefault(rid, []).append(g.idx)
        full, _, _ = feed_all(fed)
        return (pages, where, exact(full), fed.router.outcomes_snapshot(),
                open(fed.map_path, "rb").read(), owned_links(pkg, fed))

    out = both(tmp_path, run, backend=backend)
    assert out["port"] == out["jax"]
    pages, where = out["port"][0], out["port"][1]
    assert len(pages) > 3 and all(len(v) == 1 for v in where.values())
    assert len(where) == 72


def test_gap_on_lagging_group_equal(tmp_path):
    """A dead group's ranges do not advance in the cursor; its rows arrive
    once it returns."""
    def run(pkg, fed):
        fed.router.submit(KIND, NAME, DS, duplicate_batch(36))
        full, _, _ = feed_all(fed)
        pkg.faults.configure("fed_down=1")
        page = fed.router.feed_page(KIND, NAME, "", 5000)
        assert 0 < len(page["rows"]) < len(full)
        pkg.faults.configure("")
        rest, token, _ = feed_all(fed, token=page["next_since"])
        assert norm(page["rows"] + rest) == norm(full)
        return (exact(page["rows"]), page["next_since"],
                page["degraded_ranges"], page["retry_after"], exact(rest),
                token, fed.router.degraded_range_ids())

    out = both(tmp_path, run)
    assert out["port"] == out["jax"]


def test_frozen_range_rejects_the_whole_batch_equal(tmp_path):
    def run(pkg, fed):
        frozen = next(r for r in fed.map.ranges() if r.group == 0)
        fed.map.freeze(frozen.range_id)
        with pytest.raises(pkg.router.FrozenRange) as exc:
            fed.router.submit(KIND, NAME, DS, duplicate_batch(40))
        got = (exc.value.range_ids, exc.value.retry_after, str(exc.value),
               fed.router.outcomes_snapshot())
        fed.map.assign(frozen.range_id, 0)
        for g in fed.groups:
            g.fence(fed.map.epoch)
        assert fed.router.submit(KIND, NAME, DS,
                                 duplicate_batch(40))["success"]
        return got + (exact(feed_all(fed)[0]),)

    out = both(tmp_path, run)
    assert out["port"] == out["jax"]


def test_partial_failure_reports_degraded_ranges_equal(tmp_path):
    def run(pkg, fed):
        pkg.faults.configure("fed_down=2")
        with pytest.raises(pkg.router.PartialIngestFailure) as exc:
            fed.router.submit(KIND, NAME, DS, duplicate_batch(40))
        live_rows = sum(g.workload(KIND, NAME).record_store.count()
                        for g in fed.groups[:2])
        assert live_rows > 0
        return (exc.value.degraded_ranges, exc.value.retry_after,
                list(exc.value.errors), str(exc.value), live_rows,
                fed.router.degraded_range_ids(),
                [(h["group"], h["up"], h["consecutive_failures"],
                  h["fence_epoch"], h["ranges"])
                 for h in fed.router.group_health()])

    out = both(tmp_path, run)
    assert out["port"] == out["jax"]
    assert out["port"][2] == [2]


def test_live_ranges_succeed_while_a_group_is_down(tmp_path):
    def run(pkg, fed):
        pkg.faults.configure("fed_down=2")
        live = [e for e in duplicate_batch(60)
                if fed.map.owner(pkg.ranges.route_key(
                    record_id(fed, e))).group != 2]
        assert fed.router.submit(KIND, NAME, DS, live)["success"] is True
        pkg.faults.configure("")
        return len(live), exact(feed_all(fed)[0])

    out = both(tmp_path, run)
    assert out["port"] == out["jax"]


def test_stale_router_epoch_is_fenced_equal(tmp_path):
    """A router holding a pre-freeze map never writes into a range's old
    owner, and a fencing refusal is not group ill-health."""
    def run(pkg, fed):
        stale_map = pkg.ranges.PartitionMap.load(fed.map.path)
        stale = pkg.router.FederationRouter(lambda: stale_map, fed.groups)
        moved = next(r for r in fed.map.ranges() if r.group == 0)
        epoch = fed.map.freeze(moved.range_id)
        fed.groups[0].fence(epoch)
        with pytest.raises(pkg.ranges.StaleRouterEpoch) as exc:
            fed.groups[0].ingest(KIND, NAME, DS, duplicate_batch(2),
                                 epoch=stale_map.epoch)
        fenced = (exc.value.fence_epoch, exc.value.presented,
                  str(exc.value))
        with pytest.raises((pkg.ranges.StaleRouterEpoch,
                            pkg.router.FrozenRange,
                            pkg.router.PartialIngestFailure)) as exc:
            stale.submit(KIND, NAME, DS, duplicate_batch(40))
        kind = type(exc.value).__name__
        fed.map.assign(moved.range_id, 0)
        for g in fed.groups:
            g.fence(stale_map.epoch + 5)
        with pytest.raises(pkg.ranges.StaleRouterEpoch):
            stale.submit(KIND, NAME, DS, duplicate_batch(8))
        assert stale.degraded_range_ids() == []
        assert all(row["up"] for row in stale.group_health())
        return fenced, kind, stale.outcomes_snapshot()

    out = both(tmp_path, run, n_groups=2)
    assert out["port"] == out["jax"]


def test_fence_recheck_after_write_withholds_ack(tmp_path, monkeypatch):
    def run(pkg, fed):
        group = fed.groups[0]
        wl = group.workload(KIND, NAME)
        real = wl.submit_batch

        def racing(*args, **kwargs):
            out = real(*args, **kwargs)
            group.fence(group.fence_epoch + 1)  # a freeze lands mid-write
            return out

        monkeypatch.setattr(wl, "submit_batch", racing)
        with pytest.raises(pkg.ranges.StaleRouterEpoch) as exc:
            group.ingest(KIND, NAME, DS, duplicate_batch(2),
                         epoch=fed.map.epoch)
        return str(exc.value), wl.record_store.count()

    out = both(tmp_path, run, n_groups=2)
    assert out["port"] == out["jax"]


def test_map_mutation_rolls_back_on_persist_failure(tmp_path, monkeypatch):
    def run(pkg, fed):
        rid = fed.map.ranges()[0].range_id
        before = (fed.map.version, fed.map.epoch, fed.map.to_json(),
                  open(fed.map_path, "rb").read())

        def broken(path, doc):
            raise OSError("disk full")

        with monkeypatch.context() as m:
            m.setattr(pkg.atomicio, "atomic_write_json", broken)
            with pytest.raises(OSError):
                fed.map.freeze(rid)
            with pytest.raises(OSError):
                fed.map.assign(rid, 1)
        after = (fed.map.version, fed.map.epoch, fed.map.to_json(),
                 open(fed.map_path, "rb").read())
        assert after == before and not fed.map.find(rid).frozen
        return after

    out = both(tmp_path, run, n_groups=2)
    assert out["port"] == out["jax"]


def test_group_retry_heals_transient_unavailability(tmp_path, monkeypatch):
    monkeypatch.setenv("DUKE_FED_RETRIES", "3")

    def run(pkg, fed):
        group = fed.groups[1]
        real = group.ingest
        calls = []

        def flaky(*args, **kwargs):
            calls.append(1)
            if len(calls) == 1:
                raise pkg.router.GroupUnavailable("transient blip")
            return real(*args, **kwargs)

        monkeypatch.setattr(group, "ingest", flaky)
        result = fed.router.submit(KIND, NAME, DS, duplicate_batch(40))
        stats = fed.router.range_stats_snapshot()
        return (result, len(calls), sorted(
            (rid, outcomes) for rid, (outcomes, _hist) in stats.items()),
            exact(feed_all(fed)[0]))

    out = both(tmp_path, run, n_groups=2)
    assert out["port"] == out["jax"]
    assert out["port"][1] == 2
    assert any("retried" in o for _rid, o in out["port"][2])


def test_degraded_mode_contract_equal(tmp_path):
    """With one group down, live ranges ingest, the dead ranges answer the
    503-shaped failure, and the merged feed serves every live row."""
    def run(pkg, fed):
        fed.router.submit(KIND, NAME, DS, duplicate_batch(48))
        full, _, _ = feed_all(fed)
        pkg.faults.configure("fed_down=1")
        live_batch, dead_batch = [], []
        for e in duplicate_batch(60, start=1000):
            owner = fed.map.owner(pkg.ranges.route_key(
                record_id(fed, e))).group
            (dead_batch if owner == 1 else live_batch).append(e)
        assert fed.router.submit(KIND, NAME, DS, live_batch)["success"]
        with pytest.raises(pkg.router.PartialIngestFailure) as exc:
            fed.router.submit(KIND, NAME, DS, dead_batch)
        page = fed.router.feed_page(KIND, NAME, "", 5000)
        return (exc.value.degraded_ranges, exc.value.retry_after,
                page["degraded_ranges"], exact(page["rows"]), exact(full),
                fed.router.outcomes_snapshot())

    out = both(tmp_path, run)
    assert out["port"] == out["jax"]


# -- live range migration -----------------------------------------------------


def _timeline_shape(timelines):
    """A retained timeline without its clocks and trace id."""
    return [dict({k: v for k, v in t.items()
                  if k not in ("started_unix", "trace_id")},
                 phases=[{k: v for k, v in p.items()
                          if k not in ("start_unix", "duration_ms")}
                         for p in t["phases"]])
            for t in timelines]


@pytest.mark.parametrize("backend", ["host", "device"])
def test_migration_keeps_feed_and_links_bit_identical(tmp_path, backend):
    """Across a live migration the feed (timestamps included) and the
    owned links are unchanged; after it, a new duplicate of a moved record
    links at the new owner.  Results, timelines, maps and feeds equal the
    JAX package's."""
    def run(pkg, fed):
        fed.router.submit(KIND, NAME, DS, duplicate_batch(36))
        before, token, _ = feed_all(fed)
        links = owned_links(pkg, fed)
        moved = next(r for r in fed.map.ranges() if r.group == 0)
        settle(fed)
        result = fed.migrate_range(moved.range_id, 1)
        assert result["moved_records"] > 0
        after, _, _ = feed_all(fed)
        assert exact(after) == exact(before)
        assert owned_links(pkg, fed) == links
        ident = next(i % 4 for i in range(36)
                     if moved.contains(pkg.ranges.route_key(
                         record_id(fed, {"_id": str(i)}))))
        new_id = next(str(k) for k in range(9000, 99999)
                      if moved.contains(pkg.ranges.route_key(
                          record_id(fed, {"_id": str(k)}))))
        fed.router.submit(KIND, NAME, DS, [{
            "_id": new_id, "name": f"person number {ident}",
            "email": f"p{ident}@x.no"}])
        rest, _, _ = feed_all(fed, token)
        assert any(new_id in (r["entity1"], r["entity2"]) for r in rest)
        return (result, exact(after), exact(rest), links,
                owned_links(pkg, fed), open(fed.map_path, "rb").read(),
                _timeline_shape(fed.migrator.timelines_snapshot()),
                fed.migrator.outcomes, fed.migration_status())

    out = both(tmp_path, run, n_groups=2, backend=backend)
    assert out["port"] == out["jax"]


def test_device_migration_lands_mirrors_and_drains_as_tombstones(tmp_path):
    """On ``device`` groups the moved rows append to the target's corpus,
    the resolution mirrors land as tombstones (resolvable, never
    retrieved) and the drain tombstones the source's moved rows: the
    corpora's row counts and live counts equal the JAX package's."""
    def run(pkg, fed):
        fed.router.submit(KIND, NAME, DS, duplicate_batch(48))
        moved = next(r for r in fed.map.ranges() if r.group == 0)
        settle(fed)
        result = fed.migrate_range(moved.range_id, 1)
        rows = []
        for g in fed.groups:
            index = g.workload(KIND, NAME).index
            rows.append((index.corpus.size, index.live_records))
        tgt_wl = fed.groups[1].workload(KIND, NAME)
        src = fed.groups[0].workload(KIND, NAME).index
        tgt = tgt_wl.index
        mirrored = sorted(
            rec.record_id for rec in tgt_wl.record_store.all_records()
            if rec.is_deleted()
            and not moved.contains(pkg.ranges.route_key(rec.record_id)))
        assert mirrored
        if pkg is PORT:
            # a mirror's row, and every moved row at the source, is a
            # tombstone the scan masks out
            for rid in mirrored:
                assert tgt.corpus.row_deleted[tgt.id_to_row[rid]]
            for rid, row in src.id_to_row.items():
                if moved.contains(pkg.ranges.route_key(rid)):
                    assert src.corpus.row_deleted[row]
        return (result, rows, mirrored,
                [tgt.find_record_by_id(r).get_value("NAME")
                 for r in mirrored])

    out = both(tmp_path, run, n_groups=2, backend="device")
    assert out["port"] == out["jax"]
    assert out["port"][0]["moved_records"] > 0


def test_migration_replays_the_journal_slice_equal(tmp_path, monkeypatch):
    """Links journaled but not yet applied at snapshot time ride the
    range's journal slice to the target."""
    monkeypatch.setenv("DUKE_JOURNAL", "1")

    def run(pkg, fed):
        fed.router.submit(KIND, NAME, DS, duplicate_batch(24))
        before = owned_links(pkg, fed)
        moved = next(r for r in fed.map.ranges() if r.group == 0)
        src = fed.groups[0].workload(KIND, NAME)
        journal = src.link_database.journal
        in_range = next(l for l in src.link_database.get_all_links()
                        if moved.contains(pkg.ranges.route_key(l.id1)))
        settle(fed)  # the stranded batch is then the slice's only one
        journal.append_batch([[in_range.id1, in_range.id2, "inferred",
                               "duplicate", 0.4242, 1234567890123]])
        result = fed.migrate_range(moved.range_id, 1)
        assert result["replayed_slices"] >= 1
        tgt = {(l.id1, l.id2, round(l.confidence, 6))
               for l in fed.groups[1].workload(KIND, NAME)
               .link_database.get_all_links()}
        assert (in_range.id1, in_range.id2, 0.4242) in tgt
        assert len(owned_links(pkg, fed)) == len(before)
        return result, owned_links(pkg, fed), exact(feed_all(fed)[0])

    out = both(tmp_path, run, n_groups=2)
    assert out["port"] == out["jax"]


def test_interrupted_migration_resumes_on_restart_equal(tmp_path):
    """A migration stopped after its freeze (state file and frozen map on
    disk) completes when the federation is rebuilt."""
    out = {}
    for pkg in PKGS:
        folder = tmp_path / pkg.name
        fed = make_fed(pkg, folder, n_groups=2)
        fed.router.submit(KIND, NAME, DS, duplicate_batch(24))
        before = exact(feed_all(fed)[0])
        links = owned_links(pkg, fed)
        moved = next(r for r in fed.map.ranges() if r.group == 0)
        fed.migrator._write_state({"range": moved.range_id, "source": 0,
                                   "target": 1})
        fed.map.freeze(moved.range_id)
        fed.close()
        fed2 = make_fed(pkg, folder, n_groups=2)
        try:
            r = fed2.map.find(moved.range_id)
            assert (r.group, r.frozen) == (1, False)
            assert not os.path.exists(fed2.migrator.state_path)
            assert exact(feed_all(fed2)[0]) == before
            assert owned_links(pkg, fed2) == links
            out[pkg.name] = (fed2.migrator.outcomes, before,
                             open(fed2.map_path, "rb").read(),
                             _timeline_shape(
                                 fed2.migrator.timelines_snapshot()))
        finally:
            fed2.close()
    assert out["port"] == out["jax"]
    assert out["port"][0]["resumed"] == 1


def test_migrate_rejects_bad_args_and_concurrency(tmp_path):
    def run(pkg, fed):
        got = []
        with pytest.raises(KeyError) as exc:
            fed.migrate_range("ffffffffffffffff", 1)
        got.append(str(exc.value))
        rid = fed.map.ranges()[0].range_id
        with pytest.raises(ValueError) as exc:
            fed.migrate_range(rid, 99)
        got.append(str(exc.value))
        own = fed.map.ranges()[0]
        got.append(fed.migrate_range(own.range_id, own.group))
        with fed._admin_lock:
            fed._migrating = "somerange"
        try:
            with pytest.raises(RuntimeError, match="in progress") as exc:
                fed.migrate_range(rid, 1)
            got.append(str(exc.value))
        finally:
            with fed._admin_lock:
                fed._migrating = None
        return got

    out = both(tmp_path, run, n_groups=2)
    assert out["port"] == out["jax"]


# -- a federation folder carried across packages -----------------------------


@pytest.mark.parametrize("first, second", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_federation_folder_carried_across(tmp_path, first, second):
    """A ``device`` federation folder written by one package, left with a
    migration interrupted after its snapshot (the state file and the
    frozen map on disk), is opened by the other: it resumes the migration
    and serves the same feed, timestamps included; then both packages'
    next ingest into the carried folder equals."""
    folder = tmp_path / "f"
    fed = make_fed(first, folder, n_groups=2, backend="device")
    fed.router.submit(KIND, NAME, DS, duplicate_batch(36))
    before = exact(feed_all(fed)[0])
    moved = next(r for r in fed.map.ranges() if r.group == 0)
    fed.migrator._write_state({"range": moved.range_id, "source": 0,
                               "target": 1})
    fed.map.freeze(moved.range_id)
    fed.close()
    assert os.path.exists(folder / "federation" / "migration.json")
    fed2 = make_fed(second, folder, n_groups=2, backend="device")
    try:
        r = fed2.map.find(moved.range_id)
        assert (r.group, r.frozen) == (1, False)
        assert fed2.migrator.outcomes["resumed"] == 1
        assert exact(feed_all(fed2)[0]) == before
        # the restored groups score new traffic against the carried rows
        fed2.router.submit(KIND, NAME, DS, duplicate_batch(12, start=500))
        after = norm(feed_all(fed2)[0])
    finally:
        fed2.close()
    control = make_fed(first, tmp_path / "control", n_groups=2,
                       backend="device")
    try:
        control.router.submit(KIND, NAME, DS, duplicate_batch(36))
        control.migrate_range(moved.range_id, 1)
        control.router.submit(KIND, NAME, DS,
                              duplicate_batch(12, start=500))
        assert norm(feed_all(control)[0]) == after
    finally:
        control.close()


# -- the range prober ---------------------------------------------------------


def test_range_prober_under_fed_down_equal(tmp_path):
    def run(pkg, fed):
        prober = pkg.prober.RangeProber(fed)
        first = prober.run_cycle()
        assert first and set(first.values()) == {"ok"}
        pkg.faults.configure("fed_down=1")
        second = prober.run_cycle()
        pkg.faults.configure("")
        down = sorted(r.range_id for r in fed.map.group_ranges(1))
        assert sorted(r for r, v in second.items() if v == "fail") == down
        assert prober.failing_ranges() == down
        snap = prober.snapshot()
        fams = [[(f.name, f.mtype, f.help, f.samples)
                 for f in prober.collector_for(g.idx)()]
                for g in fed.groups]
        return first, second, prober.failing_ranges(), snap, fams

    out = both(tmp_path, run, n_groups=2)
    assert out["port"] == out["jax"]


# -- entry points ----------------------------------------------------------------


def test_federation_without_a_gpu_raises_unless_cpu(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = tconfig.parse_config(FED_XML.format(folder=tmp_path),
                              env={"MIN_RELEVANCE": "0.05"})
    for backend in ("device", "ann"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfed.Federation(sc, n_groups=2, backend=backend)
    assert not os.path.exists(tmp_path / "federation" / "g0")
    fed = tfed.Federation(sc, n_groups=2, backend="device", device="cpu")
    try:
        assert fed.device.type == "cpu"
        wl = fed.groups[1].workload(KIND, NAME)
        assert wl.index.corpus.device.type == "cpu"
    finally:
        fed.close()
    # the host backend runs no device code: it needs no card
    fed = tfed.Federation(sc, n_groups=2)
    try:
        assert fed.device is None and fed.backend == "host"
    finally:
        fed.close()


def _cli(tmp_path, *args, env=None):
    xml = FED_XML.format(folder=tmp_path)
    full = dict(os.environ, CONFIG_STRING=xml, **(env or {}))
    full["PYTHONPATH"] = REPO + os.pathsep + full.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "sesam_duke_microservice_tpu_torch.service",
         *args], cwd=str(tmp_path), env=full, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def test_cli_federation_without_a_gpu_exits_with_an_error(tmp_path):
    proc = _cli(tmp_path, "--federation", "2", "--port", "0",
                env={"CUDA_VISIBLE_DEVICES": ""})
    _, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in err
    assert not os.path.exists(tmp_path / "federation" / "g0")


def test_cli_federation_serves_on_cpu_and_stops_on_sigterm(tmp_path):
    """``--federation 2 --device cpu`` serves the plane over the groups'
    folders, ingests and feeds, and SIGTERM stops it cleanly."""
    import signal
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = _cli(tmp_path, "--federation", "2", "--device", "cpu",
                "--port", str(port), "--host", "127.0.0.1")
    base = f"http://127.0.0.1:{port}"
    try:
        t0 = time.monotonic()
        while True:
            try:
                with urllib.request.urlopen(base + "/readyz", timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            assert time.monotonic() - t0 < 90
            time.sleep(0.2)
        req = urllib.request.Request(
            f"{base}/deduplication/people/crm",
            data=json.dumps(duplicate_batch(12)).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
        with urllib.request.urlopen(f"{base}/deduplication/people?since=",
                                    timeout=60) as r:
            assert json.loads(r.read())
            assert r.headers["X-Fed-Drained"] == "true"
        with urllib.request.urlopen(f"{base}/federation/map",
                                    timeout=60) as r:
            assert json.loads(r.read())["n_groups"] == 2
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-3000:]
    assert os.path.isdir(tmp_path / "federation" / "g1" / KIND / NAME)


def test_concurrent_submit_and_feed(tmp_path):
    """Scatter ingest and merged feeds interleave from many threads (the
    router holds no lock across group calls); the links equal a serial
    ingest's on the JAX package (each pair links whichever record came
    first)."""
    batches = [duplicate_batch(12, start=i * 12) for i in range(4)]
    fed = make_fed(PORT, tmp_path / "port", n_groups=2)
    errors = []

    def ingest(batch):
        try:
            fed.router.submit(KIND, NAME, DS, batch)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def poll():
        try:
            feed_all(fed)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    try:
        threads = ([threading.Thread(target=ingest, args=(b,))
                    for b in batches]
                   + [threading.Thread(target=poll) for _ in range(2)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors and not any(t.is_alive() for t in threads)
        rows = feed_all(fed)[0]
    finally:
        fed.close()
    serial = make_fed(JAX, tmp_path / "jax", n_groups=2)
    try:
        for batch in batches:
            serial.router.submit(KIND, NAME, DS, batch)
        want = feed_all(serial)[0]
    finally:
        serial.close()

    def pairs(rs):
        return sorted((r["_id"], r["_deleted"], round(r["confidence"], 9))
                      for r in rs)

    assert rows and pairs(rows) == pairs(want)
