"""The port's mesh backends (``sharded``, ``sharded-brute``) against the
JAX package's backends of the same name and the port's own ``device`` /
``ann``, on the CPU.

The JAX package serves them on its 8-device CPU mesh (tests/conftest.py);
the port on ``[cpu] * 8`` (``engine.sharded_matcher.set_serving_devices``),
eight logical shards in one process.  The cases of
tests/test_sharded_service.py and tests/test_mesh_parity.py: dedup and
linkage, deletes and tombstones, value-slot growth rebuilding on the
mesh, a snapshot restart onto the mesh, HTTP end to end, escalation that
fires, explain with the dd replay, and the dd gate's statistics.  Ordered
event tapes and link rows must be bit-identical to the JAX package's
mesh backends and to the port's single-device ones (for ``sharded``
against ``ann`` as sets: the per-shard top-C legally reorders the
candidate walk, tests/test_mesh_parity.py).
"""

import json
import threading
import urllib.request

import pytest
import torch

from sesam_duke_microservice_tpu.core.config import MatchTunables
from sesam_duke_microservice_tpu.core.config import parse_config as jparse
from sesam_duke_microservice_tpu.engine import sharded_matcher as JSM
from sesam_duke_microservice_tpu.engine.ann_matcher import (
    AnnIndex as JAnnIndex,
    AnnProcessor as JAnnProcessor,
)
from sesam_duke_microservice_tpu.engine.workload import (
    build_workload as jbuild,
)
from sesam_duke_microservice_tpu_torch import telemetry as ttelemetry
from sesam_duke_microservice_tpu_torch.core.config import (
    parse_config as tparse,
)
from sesam_duke_microservice_tpu_torch.engine import device_matcher as TDM
from sesam_duke_microservice_tpu_torch.engine import sharded_matcher as TSM
from sesam_duke_microservice_tpu_torch.engine.ann_matcher import (
    AnnIndex as TAnnIndex,
    AnnProcessor as TAnnProcessor,
)
from sesam_duke_microservice_tpu_torch.engine.workload import (
    build_workload as tbuild,
)

from test_dd import _records_with_person
from test_sharded_service import (
    DEDUP_XML,
    LINKAGE_XML,
    _escalation_batch,
    _seeded_batch,
)
from test_torch_growth import JAX, PORT, Tape
from torch_jax_cache import jax_cache_off  # noqa: F401

CPU = torch.device("cpu")
SINGLE = {"sharded-brute": "device", "sharded": "ann"}


@pytest.fixture(autouse=True)
def mesh8():
    """Eight logical CPU shards for every sharded workload these tests
    build; dropped afterwards so no later test inherits the mesh."""
    mesh = TSM.set_serving_devices([CPU] * 8)
    yield mesh
    TSM.set_serving_devices(None)


def _workload(pkg, xml, kind, name, backend, **kw):
    if pkg is JAX:
        sc = jparse(xml, env={"MIN_RELEVANCE": "0.05"})
        return jbuild(getattr(sc, kind)[name], sc, backend=backend,
                      persistent=False, **kw)
    sc = tparse(xml, env={"MIN_RELEVANCE": "0.05"})
    return tbuild(getattr(sc, kind)[name], sc, backend=backend,
                  device="cpu", persistent=False, **kw)


def _live_links(wl):
    return sorted((r["entity1"], r["entity2"], r["confidence"].hex())
                  for r in wl.links_since(0) if not r["_deleted"])


def _run_dedup(pkg, backend, batches):
    """(ordered event tape, live links) of ``batches`` through one
    package's ``people`` workload on ``backend``."""
    wl = _workload(pkg, DEDUP_XML, "deduplications", "people", backend)
    tape = Tape()
    wl.processor.add_match_listener(tape)
    try:
        with wl.lock:
            for batch in batches:
                wl.process_batch("crm", batch)
            return tape.events, _live_links(wl)
    finally:
        wl.close()


def _compare(backend, batches):
    jtape, jlinks = _run_dedup(JAX, backend, batches)
    ttape, tlinks = _run_dedup(PORT, backend, batches)
    stape, slinks = _run_dedup(PORT, SINGLE[backend], batches)
    assert ttape == jtape
    assert tlinks == jlinks
    assert tlinks == slinks
    if backend == "sharded-brute":
        assert ttape == stape
    else:
        assert sorted(ttape) == sorted(stape)
    return tlinks


@pytest.mark.parametrize("backend", ["sharded-brute", "sharded"])
def test_dedup_bit_identical_to_jax_mesh_and_single_device(backend):
    links = _compare(backend, [_seeded_batch(24),
                               _seeded_batch(12, prefix="b")])
    assert len(links) >= 10


@pytest.mark.parametrize("backend", ["sharded-brute", "sharded"])
def test_escalation_fires_and_matches(backend):
    """One 72-strong name cluster overflows the initial top-K (16) and
    top-C (64): the widening loop runs on the mesh, decided on the summed
    (brute force) or merged (ann) count, and the links still equal the
    JAX mesh's and the single device's."""
    start = sum(TDM.ESCALATIONS.values())
    links = _compare(backend, [_escalation_batch(72, 24)])
    assert sum(TDM.ESCALATIONS.values()) > start
    dup = [(a, b) for a, b, _ in links
           if a.startswith("dup") and b.startswith("dup")]
    assert len(dup) == 72 * 71 // 2


def test_linkage_group_exclusion_and_transform():
    out = {}
    for pkg in (JAX, PORT):
        wl = _workload(pkg, LINKAGE_XML, "record_linkages", "pairing",
                       "sharded")
        try:
            with wl.lock:
                wl.process_batch("left", [{"_id": "a", "name": "Turing"},
                                          {"_id": "b", "name": "Turing"}])
                assert wl.links_since(0) == []
                wl.process_batch("right", [{"_id": "c", "name": "Turing"}])
                keys = {r["_id"] for r in wl.links_since(0)}
                assert keys == {"1__left__a_2__right__c",
                                "1__left__b_2__right__c"}
                rows = wl.process_batch(
                    "right", [{"_id": "probe", "name": "Turing"}],
                    http_transform=True)
                assert {d["entityId"] for d in rows[0]["duke_links"]} == {
                    "a", "b"}
                assert {r["_id"] for r in wl.links_since(0)} == keys
                out[pkg.name] = (_live_links(wl), json.dumps(rows))
        finally:
            wl.close()
    assert out["port"] == out["jax"]


def test_delete_retracts_and_tombstones():
    out = {}
    for pkg in (JAX, PORT):
        wl = _workload(pkg, DEDUP_XML, "deduplications", "people",
                       "sharded-brute")
        try:
            with wl.lock:
                wl.process_batch("crm", [
                    {"_id": "1", "name": "Alan Turing", "email": "a@x.no"},
                    {"_id": "2", "name": "Alan Turing", "email": "a@x.no"}])
                assert len(_live_links(wl)) == 1
                wl.process_batch("crm", [{"_id": "2", "_deleted": True}])
                assert _live_links(wl) == []
                wl.process_batch("crm", [
                    {"_id": "3", "name": "Alan Turing", "email": "a@x.no"}])
                live = _live_links(wl)
                assert {(a, b) for a, b, _ in live} == {("1", "3")}
                out[pkg.name] = live
        finally:
            wl.close()
    assert out["port"] == out["jax"]


def test_value_slot_growth_rebuilds_on_the_mesh():
    wl = _workload(PORT, DEDUP_XML, "deduplications", "people", "sharded")
    try:
        with wl.lock:
            wl.process_batch("crm", [
                {"_id": "1", "name": "Ada Lovelace", "email": "a@x.no"}])
            first = wl.index.corpus
            wl.process_batch("crm", [
                {"_id": "2", "name": ["Zzz Yyy", "Ada Lovelace"],
                 "email": "a@x.no"}])
            live = _live_links(wl)
        assert {(a, b) for a, b, _ in live} == {("1", "2")}
        corpus = wl.index.corpus
        assert corpus is not first  # the growth rebuilt the corpus
        assert isinstance(corpus, TSM.ShardedDeviceCorpus)
        feats, valid, _, _ = corpus.device_arrays()
        assert len(feats) == len(valid) == 8
        assert all(v.shape[0] == corpus.capacity // 8 for v in valid)
        assert corpus.capacity % (8 * TDM._CHUNK) == 0
        assert int(sum(v.sum() for v in valid)) == 2
        assert corpus.device_bytes()["corpus_tensors"] > 0
    finally:
        wl.close()


def test_snapshot_restart_onto_the_mesh(tmp_path):
    """A persistent sharded workload restores its corpus from the snapshot
    onto the mesh (no re-extraction) and serves the same links."""
    xml = DEDUP_XML.replace(
        "<DukeMicroService>", f'<DukeMicroService dataFolder="{tmp_path}">'
    ).replace('link-database-type="in-memory"', 'link-database-type="h2"')
    sc = tparse(xml, env={"MIN_RELEVANCE": "0.05"})
    wc = sc.deduplications["people"]
    wl = tbuild(wc, sc, backend="sharded", device="cpu")
    with wl.lock:
        wl.process_batch("crm", _seeded_batch(18))
        before = _live_links(wl)
    wl.close()
    calls = []
    real = TSM.ShardedAnnIndex._extract

    def counting(self, records, plan=None):
        calls.append(len(records))
        return real(self, records, plan)

    TSM.ShardedAnnIndex._extract = counting
    try:
        wl2 = tbuild(wc, sc, backend="sharded", device="cpu")
    finally:
        TSM.ShardedAnnIndex._extract = real
    try:
        assert not calls and wl2.restore_route == "snapshot"
        assert isinstance(wl2.index.corpus, TSM.ShardedDeviceCorpus)
        with wl2.lock:
            assert _live_links(wl2) == before
            wl2.process_batch("crm", [
                {"_id": "again0", "name": "person number 0",
                 "email": "person.number.0@x.no"}])
            after = _live_links(wl2)
        assert len(after) > len(before)
        assert len(wl2.index.corpus.device_arrays()[1]) == 8
    finally:
        wl2.close()


def test_http_service_end_to_end():
    """The full REST surface over the sharded backend: POST, feed,
    transform, /stats, the mesh families on /metrics, and the rematch."""
    import os

    from sesam_duke_microservice_tpu_torch.service.app import DukeApp, serve

    saved = os.environ.get("MIN_RELEVANCE")
    os.environ["MIN_RELEVANCE"] = "0.05"
    try:
        app = DukeApp(tparse(DEDUP_XML), backend="sharded-brute",
                      device="cpu", persistent=False)
    finally:
        if saved is None:
            os.environ.pop("MIN_RELEVANCE", None)
        else:
            os.environ["MIN_RELEVANCE"] = saved
    server = serve(app, port=0, host="127.0.0.1")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(
            base + path, data=json.dumps(payload).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as resp:
            return resp.read().decode()

    try:
        status, body = post("/deduplication/people/crm", [
            {"_id": "1", "name": "Alan Turing", "email": "a@x.no"},
            {"_id": "2", "name": "Alan Turing", "email": "a@x.no"}])
        assert (status, body) == (200, {"success": True})
        rows = json.loads(get("/deduplication/people?since=0"))
        assert len(rows) == 1
        assert {rows[0]["entity1"], rows[0]["entity2"]} == {"1", "2"}
        status, body = post("/deduplication/people/crm/httptransform",
                            {"_id": "p", "name": "Alan Turing",
                             "email": "a@x.no"})
        assert status == 200
        assert {d["entityId"] for d in body["duke_links"]} == {"1", "2"}
        stats = json.loads(get("/stats"))
        assert stats["backend"] == "sharded-brute"
        assert stats["workloads"][0]["records_indexed"] == 2
        metrics = get("/metrics")
        assert "duke_mesh_devices 8" in metrics
        cap = app.deduplications["people"].index.corpus.capacity
        assert (f'duke_corpus_capacity_rows_per_shard{{kind="deduplication",'
                f'workload="people"}} {cap // 8}') in metrics
        assert "duke_mesh_dd_gathers_total{" in metrics
        status, body = post("/deduplication/people/rematch", [])
        assert status == 200 and body["devices"] == 8
        assert body["queries"] == 2 and body["events"] == 1
        assert json.loads(get("/deduplication/people?since=0")) == rows
    finally:
        server.shutdown()
        app.close()


# -- the processor level with the dd lift (tests/test_mesh_parity.py) --------


def _port_records(records):
    out = []
    for r in records:
        t = PORT.R.Record()
        for prop, values in r._values.items():
            for v in values:
                t.add_value(prop, v)
        out.append(t)
    return out


HOSTPROP = [("name", "Levenshtein", 0.3, 0.9),
            ("person", "PersonName", 0.4, 0.8)]


def _arm(pkg, name, schema):
    if pkg is JAX:
        idx = {"device": lambda: JAX.DM.DeviceIndex(
                   schema, tunables=MatchTunables()),
               "sharded-brute": lambda: JSM.ShardedDeviceIndex(
                   schema, tunables=MatchTunables()),
               "ann": lambda: JAnnIndex(schema, tunables=MatchTunables()),
               "sharded": lambda: JSM.ShardedAnnIndex(
                   schema, tunables=MatchTunables())}[name]()
        proc = {"device": JAX.DM.DeviceProcessor,
                "sharded-brute": JSM.ShardedDeviceProcessor,
                "ann": JAnnProcessor,
                "sharded": JSM.ShardedAnnProcessor}[name]
    else:
        idx = {"device": lambda: TDM.DeviceIndex(schema, device="cpu"),
               "sharded-brute": lambda: TSM.ShardedDeviceIndex(
                   schema, device="cpu"),
               "ann": lambda: TAnnIndex(schema, device="cpu"),
               "sharded": lambda: TSM.ShardedAnnIndex(
                   schema, device="cpu")}[name]()
        proc = {"device": TDM.DeviceProcessor,
                "sharded-brute": TSM.ShardedDeviceProcessor,
                "ann": TAnnProcessor,
                "sharded": TSM.ShardedAnnProcessor}[name]
    return proc(schema, idx)


def _run_arm(pkg, name, records):
    schema = pkg.schema(HOSTPROP, threshold=0.8, maybe=0.6)
    proc = _arm(pkg, name, schema)
    tape = Tape()
    links = pkg.Links()
    proc.add_match_listener(tape)
    proc.add_match_listener(pkg.L.LinkMatchListener(links))
    proc.deduplicate(records if pkg is JAX else _port_records(records))
    rows = sorted((l.id1, l.id2, l.status.value, l.kind.value,
                   l.confidence.hex()) for l in links.get_all_links())
    return tape.events, rows, proc


@pytest.fixture
def device_finalize(monkeypatch):
    monkeypatch.setenv("DUKE_DEVICE_FINALIZE", "1")


@pytest.mark.parametrize("sharded", ["sharded-brute", "sharded"])
def test_mesh_tape_links_and_dd_lift_bit_identical(sharded, device_finalize):
    records = _records_with_person(40, seed=5)
    jtape, jrows, _ = _run_arm(JAX, sharded, records)
    ttape, trows, tproc = _run_arm(PORT, sharded, records)
    stape, srows, _ = _run_arm(PORT, SINGLE[sharded], records)
    assert ttape and ttape == jtape
    assert trows == jrows == srows
    if sharded == "sharded-brute":
        assert ttape == stape
    else:
        assert sorted(ttape) == sorted(stape)
    # the dd lift decided real pairs on the lead device
    assert tproc.stats.pairs_device_certified > 0
    cache = tproc.database.scorer_cache
    assert cache._dd_gathers > 0 and cache._dd_gather_rows > 0


def test_mesh_dd_gate_stats_equal_single_device_and_jax(device_finalize):
    records = _records_with_person(24, seed=9)
    _, _, mesh = _run_arm(PORT, "sharded-brute", records)
    _, _, base = _run_arm(PORT, "device", records)
    _, _, jmesh = _run_arm(JAX, "sharded-brute", records)
    assert base.stats.pairs_device_certified > 0
    for field in ("pairs_device_certified", "dd_residue_margin",
                  "dd_residue_kind", "dd_residue_truncation",
                  "candidates_retrieved", "pairs_rescored"):
        assert getattr(mesh.stats, field) == getattr(base.stats, field), field
        assert getattr(mesh.stats, field) == getattr(jmesh.stats, field), \
            field


def test_explain_replays_dd_on_sharded_backend(device_finalize):
    from sesam_duke_microservice_tpu.engine import explain as JX
    from sesam_duke_microservice_tpu_torch.engine import explain as TX

    out = {}
    for pkg, X in ((JAX, JX), (PORT, TX)):
        schema = pkg.schema([("name", "Levenshtein", 0.3, 0.9),
                             ("city", "Exact", 0.4, 0.8),
                             ("amount", "Numeric", 0.4, 0.7)])
        a = pkg.record("a", name="acme corp", city="oslo", amount="100")
        b = pkg.record("b", name="acme corp", city="oslo", amount="100")
        z = pkg.record("z", name="zzzzz", city="bergen", amount="7")
        idx = (JSM.ShardedDeviceIndex(schema, tunables=MatchTunables())
               if pkg is JAX else TSM.ShardedDeviceIndex(schema, device="cpu"))
        for r in (a, b, z):
            idx.index(r)
        idx.commit()
        near = X.device_breakdown(idx, a, b)
        far = X.device_breakdown(idx, a, z)
        assert near["device_finalize_enabled"] is True
        assert near["decided_path"] == "device_certified"
        assert near["certified_dd_margin"] > 0
        assert far["decided_path"] == "band_skip"
        out[pkg.name] = {k: near[k] for k in (
            "decided_path", "band_verdict", "dd_unsafe", "dd_logit",
            "certified_dd_margin")}
    assert out["port"] == out["jax"]


def test_serving_mesh_gauge_and_default():
    assert ttelemetry.MESH_DEVICES.single().value == 8
    assert TSM.serving_mesh(CPU).size == 8
    TSM.set_serving_devices(None)
    assert ttelemetry.MESH_DEVICES.single().value == 0
    mesh = TSM.serving_mesh(CPU)  # no card: one shard on the CPU
    assert mesh.devices == (CPU,)
    assert ttelemetry.MESH_DEVICES.single().value == 1
