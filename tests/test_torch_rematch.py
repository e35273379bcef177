"""The port's ring bulk re-match (``engine.rematch``) against the JAX
package's, on the CPU (the cases of tests/test_rematch.py).

Records bulk-imported without scoring, then ``ring_rematch``: the backfill
must equal what scoring produced, on the ``device``, ``sharded-brute`` and
``sharded`` backends (the port's mesh: ``[cpu] * 8``), tombstoned and
deleted rows stay out, a second pass asserts nothing new, and the stats
and links equal the JAX package's ``ring_rematch`` on its 8-device mesh --
run in a child interpreter with its own timeout
(tests/torch_rematch_jax_child.py), since the JAX ring aborts a process in
which certain service tests ran before it.  ``POST /{kind}/{name}/rematch``
answers with the JAX package's stats keys, 404 for an unknown workload,
400 on the ``host`` backend, and a datasource named ``rematch`` keeps the
route as a batch POST.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest
import torch

from sesam_duke_microservice_tpu_torch.core.config import parse_config
from sesam_duke_microservice_tpu_torch.engine import rematch as TR
from sesam_duke_microservice_tpu_torch.engine import sharded_matcher as TSM
from sesam_duke_microservice_tpu_torch.engine.rematch import ring_rematch
from sesam_duke_microservice_tpu_torch.ops.arena import ARENA
from sesam_duke_microservice_tpu_torch.parallel.sharded import ShardedCorpus
from sesam_duke_microservice_tpu_torch.engine.workload import build_workload

from test_rematch import XML, _batch, _bulk_import
from torch_rematch_scenarios import SCENARIOS, live_links

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
STATS_KEYS = {"queries", "corpus_rows", "pairs_ranked", "survivor_pairs",
              "events", "seconds", "devices"}


@pytest.fixture(autouse=True)
def mesh8():
    TSM.set_serving_devices([CPU] * 8)
    yield
    TSM.set_serving_devices(None)


@pytest.fixture(scope="module")
def jax_rematch(tmp_path_factory):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["DUKE_AOT_DIR"] = str(tmp_path_factory.mktemp("aot"))
    try:
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "torch_rematch_jax_child.py")],
            env=env, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"the JAX rematch child ran past its timeout: {e}")
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _workload(backend):
    sc = parse_config(XML, env={"MIN_RELEVANCE": "0.05"})
    return build_workload(sc.deduplications["people"], sc, backend=backend,
                          device="cpu", persistent=False)


def _scored_links(entities):
    wl = _workload("device")
    try:
        with wl.lock:
            wl.process_batch("crm", entities)
            return live_links(wl)
    finally:
        wl.close()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_ring_rematch_equals_jax_and_backfills_scoring(scenario,
                                                       jax_rematch):
    backend, entities = SCENARIOS[scenario]
    wl = _workload(backend)
    try:
        with wl.lock:
            _bulk_import(wl, entities)
            assert wl.links_since(0) == []
            stats = ring_rematch(wl)
            got = live_links(wl)
            assert set(stats) == STATS_KEYS
            stats.pop("seconds")
            assert stats == jax_rematch[scenario]["stats"]
            assert got == jax_rematch[scenario]["links"]
            # idempotence: a second pass asserts nothing new
            before = [r["_updated"] for r in wl.links_since(0)]
            ring_rematch(wl)
            assert [r["_updated"] for r in wl.links_since(0)] == before
    finally:
        wl.close()
    if scenario == "tombstones":
        assert {(a, b) for a, b, _ in got} == {("1", "2")}
    else:
        assert stats["devices"] == 8
        want = _scored_links(entities)
        assert len(want) >= 8 and got == want
        assert stats["queries"] == 30 and stats["events"] == len(want)


@pytest.mark.parametrize("backend", ["device", "sharded-brute"])
def test_ring_rematch_in_several_query_blocks(backend):
    """Query blocks of 7 rows (5 passes over 30 live rows, each padded to
    the mesh): the same links and stats as one block."""
    entities = SCENARIOS[backend][1]
    runs = []
    for block in (None, 7):
        wl = _workload(backend)
        try:
            with wl.lock:
                _bulk_import(wl, entities)
                stats = ring_rematch(wl, query_block_rows=block)
                stats.pop("seconds")
                runs.append((stats, live_links(wl)))
        finally:
            wl.close()
    assert runs[0] == runs[1]
    assert runs[0][0]["pairs_ranked"] == 30 * 30


@pytest.mark.parametrize("backend,shards,capacity,records", [
    ("sharded-brute", 8, 0, 30), ("sharded-brute", 8, 1024, 150),
    ("sharded", 8, 0, 30), ("device", 1, 0, 30), ("device", 1, 4096, 100)])
def test_ring_rematch_reads_the_resident_corpus(backend, shards, capacity,
                                                records, monkeypatch):
    """Where the corpus's own device tensors lie in the ring's layout (a
    mesh index on its mesh, a device index on a one-shard mesh on its
    device) the pass reads them, leased from the arena, and places no
    second copy: the same stats and links as the copy path, also where
    each shard is cut to the chunks that hold rows (a pre-sized capacity;
    150 rows fill shard 0 of 128 and one chunk of shard 1)."""
    TSM.set_serving_devices([CPU] * shards)
    monkeypatch.setenv("DEVICE_INITIAL_CAPACITY", str(capacity))
    entities = _batch(records)
    runs = []
    for resident in (True, False):
        with monkeypatch.context() as m:
            if resident:
                def refuse(*args):
                    raise AssertionError("placed a second corpus copy")

                m.setattr(ShardedCorpus, "place", refuse)
            else:
                m.setattr(TR, "_resident_arrays", lambda *args: None)
            wl = _workload(backend)
            try:
                with wl.lock:
                    _bulk_import(wl, entities)
                    stats = ring_rematch(wl)
                    stats.pop("seconds")
                    runs.append((stats, live_links(wl)))
            finally:
                wl.close()
    assert runs[0] == runs[1]
    assert runs[0][0]["devices"] == shards and len(runs[0][1]) >= 8


def test_ring_rematch_respects_tombstones_on_the_mesh():
    wl = _workload("sharded-brute")
    try:
        with wl.lock:
            _bulk_import(wl, SCENARIOS["tombstones"][1])
            row2 = next(row for rid, row in wl.index.id_to_row.items()
                        if rid.endswith("2"))
            wl.index.corpus.tombstone(row2)
            stats = ring_rematch(wl)
            assert stats["queries"] == 1  # row 2 tombstoned, 3 deleted
            assert live_links(wl) == []
    finally:
        wl.close()


def _serve(app):
    from sesam_duke_microservice_tpu_torch.service.app import serve

    server = serve(app, port=0, host="127.0.0.1")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, body=b""):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("backend", ["device", "sharded-brute"])
def test_rematch_http_endpoint(backend, monkeypatch):
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp

    monkeypatch.setenv("MIN_RELEVANCE", "0.05")
    app = DukeApp(parse_config(XML), backend=backend, device="cpu",
                  persistent=False)
    server, base = _serve(app)
    try:
        wl = app.deduplications["people"]
        with wl.lock:
            _bulk_import(wl, _batch(12))
        status, body = _post(base + "/deduplication/people/rematch")
        assert status == 200
        stats = json.loads(body)
        assert set(stats) == STATS_KEYS
        assert stats["queries"] == 12 and stats["events"] >= 4
        # a device backend's rematch also rides the serving mesh
        assert stats["devices"] == 8
        with urllib.request.urlopen(base + "/deduplication/people?since=0",
                                    timeout=60) as resp:
            assert len(json.loads(resp.read())) == stats["events"]
        status, _ = _post(base + "/deduplication/nope/rematch")
        assert status == 404
        metrics = urllib.request.urlopen(base + "/metrics",
                                         timeout=60).read().decode()
        assert ('route="/deduplication/:name/rematch",method="POST",'
                'status="200"') in metrics
    finally:
        server.shutdown()
        app.close()


def test_rematch_on_host_backend_is_a_400(monkeypatch):
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp

    app = DukeApp(parse_config(XML), backend="host", persistent=False)
    server, base = _serve(app)
    try:
        status, body = _post(base + "/deduplication/people/rematch")
        assert status == 400
        assert b"device-family backend" in body
    finally:
        server.shutdown()
        app.close()


def test_rematch_past_the_arena_budget_is_a_503(monkeypatch):
    """The pass leases the corpus's tensors from the arena: a corpus the
    budget cannot fit answers 503, as a scoring POST does."""
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp

    monkeypatch.setenv("MIN_RELEVANCE", "0.05")
    app = DukeApp(parse_config(XML), backend="sharded-brute", device="cpu",
                  persistent=False)
    server, base = _serve(app)
    try:
        wl = app.deduplications["people"]
        with wl.lock:
            _bulk_import(wl, _batch(12))
        monkeypatch.setattr(ARENA, "_budget_bytes", lambda: 1.0)
        status, body = _post(base + "/deduplication/people/rematch")
        assert status == 503, body
        assert b"HBM budget exhausted" in body
    finally:
        server.shutdown()
        app.close()


def test_dataset_named_rematch_stays_a_batch_post(monkeypatch):
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp

    monkeypatch.setenv("MIN_RELEVANCE", "0.05")
    xml = XML.replace('value="crm"', 'value="rematch"')
    app = DukeApp(parse_config(xml), device="cpu", persistent=False)
    server, base = _serve(app)
    try:
        status, body = _post(base + "/deduplication/people/rematch",
                             json.dumps(_batch(3)).encode())
        assert (status, json.loads(body)) == (200, {"success": True})
        assert len(app.deduplications["people"].index.records) == 3
    finally:
        server.shutdown()
        app.close()
