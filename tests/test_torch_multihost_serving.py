"""The port's serving group on two OS processes, against a single-process
JAX app.  The counterpart of tests/test_multihost_serving.py.

Two processes join a ``torch.distributed`` job (gloo), two CPU shards
each, a global mesh of 4 (tests/torch_multihost_serving_child.py): process
0 is the HTTP frontend and op dispatcher, process 1 the follower replay
loop, which also serves its replica read plane.  Real HTTP against the
frontend -- ingest with duplicates, concurrent POSTs, a deletion, an
http-transform, a hot config reload, ingest after it, the ``?since=``
feed, ``/stats``, a ring rematch across both processes -- on
``sharded-brute`` and ``sharded``.  The live and retracted link sets and
the transform's links must equal the JAX package's single-process
``device`` app's on the same batches (confidences to 9 decimals, the JAX
test's bar); the follower's replica feed must equal the frontend's, byte
for byte, at ``X-Replica-Lag: 0``.

Then a canary prober cycle, which scores on the frontend's own shards as
a mesh of one process, off the op stream, and a ``POST /explain`` on the
group, whose retrieval goes through the op stream onto the global mesh:
both must return and leave the group serving in lockstep, and an
explained candidate held on the follower's shards must be retrieved at
the rank the JAX package's sharded ``ann`` index gives it.  Each child
gets its own 90 s timeout and a data folder of its own under the test's
``tmp_path`` (its working directory).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from sesam_duke_microservice_tpu.core.config import parse_config as jparse
from sesam_duke_microservice_tpu.engine.workload import (
    build_workload as jbuild,
)

from test_sharded_service import DEDUP_XML, _seeded_batch
from torch_jax_cache import jax_cache_off  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "torch_multihost_serving_child.py")
CHILD_TIMEOUT_S = 90

B1 = _seeded_batch(24)
B2 = _seeded_batch(12, prefix="b")
CONC = [_seeded_batch(6, prefix=f"c{t}-") for t in range(4)]
DELETE = [{"_id": "1", "_deleted": True}]
B3 = _seeded_batch(9, prefix="d")
PROBE = dict(B1[3], _id="probe-x")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, payload, timeout=60, ctype="application/json"):
    body = payload if isinstance(payload, bytes) else json.dumps(
        payload).encode()
    req = urllib.request.Request(url, body, {"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def _live(rows):
    return sorted((r["entity1"], r["entity2"], round(r["confidence"], 9))
                  for r in rows if not r["_deleted"])


def _retracted(rows):
    return sorted((r["entity1"], r["entity2"]) for r in rows
                  if r["_deleted"])


class Group:
    """Both processes of a two-process group, the frontend's and the
    follower's replica plane's base URLs."""

    def __init__(self, backend, xml, folder, extra_env=None):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        # one intra-op thread a child: under ``pytest -n 6`` several
        # groups' children share the cores, and torch's default of one
        # thread a core spends the small ops' time in hand-offs
        env.setdefault("OMP_NUM_THREADS", "1")
        env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
                   CONFIG_STRING=xml, MIN_RELEVANCE="0.05",
                   DUKE_DISPATCH_HOST="127.0.0.1",
                   DUKE_REPLICA_HTTP_PORT=str(free_port()))
        env.update(extra_env or {})
        port = free_port()
        self.base = f"http://127.0.0.1:{port}"
        self.replica = f"http://127.0.0.1:{env['DUKE_REPLICA_HTTP_PORT']}"
        coordinator = f"127.0.0.1:{free_port()}"
        self.procs = [subprocess.Popen(
            [sys.executable, CHILD, str(rank), coordinator, str(port),
             backend], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=str(folder)) for rank in (0, 1)]

    def wait_up(self, deadline_s=CHILD_TIMEOUT_S):
        t0 = time.monotonic()
        while time.monotonic() - t0 < deadline_s:
            for p in self.procs:
                if p.poll() is not None:
                    _, err = p.communicate(timeout=10)
                    raise AssertionError(
                        f"child died rc={p.returncode}:\n{err[-4000:]}")
            for base in (self.base, self.replica):
                try:
                    if _get(base + "/readyz", timeout=2)[0] != 200:
                        break
                except (urllib.error.URLError, OSError):
                    break
            else:
                return
            time.sleep(0.2)
        raise AssertionError("the group never came up")

    def stop(self):
        """SIGTERM the frontend (its dispatcher sends the followers the
        shutdown op); every child must exit 0 within its timeout."""
        if self.procs[0].poll() is None:
            self.procs[0].send_signal(signal.SIGTERM)
        outs = []
        for p in self.procs:
            try:
                outs.append(p.communicate(timeout=CHILD_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate())
        for p, (_, err) in zip(self.procs, outs):
            assert p.returncode == 0, f"child rc={p.returncode}:\n{err[-4000:]}"


@pytest.fixture(scope="module")
def jax_oracle():
    """The JAX package's single-process device app on the same batches:
    (live links, retracted links, the transform's links)."""
    sc = jparse(DEDUP_XML, env={"MIN_RELEVANCE": "0.05"})
    wl = jbuild(sc.deduplications["people"], sc, backend="device",
                persistent=False)
    try:
        with wl.lock:
            for batch in [B1, B2] + CONC + [DELETE]:
                wl.process_batch("crm", batch)
            transform = {(link["entityId"], round(link["confidence"], 9))
                         for row in wl.process_batch("crm", [PROBE],
                                                     http_transform=True)
                         for link in row["duke_links"]}
            wl.process_batch("crm", B3)
            rows = wl.links_since(0)
    finally:
        wl.close()
    return _live(rows), _retracted(rows), transform


def _durable_xml(tmp_path):
    # a durable link DB: an in-memory one is emptied by a hot reload
    return DEDUP_XML.replace(
        "<DukeMicroService>",
        f'<DukeMicroService dataFolder="{tmp_path}">').replace(
        ' link-database-type="in-memory"', "")


def _replica_caught_up(group, want_body, deadline_s=30):
    """The follower's replica feed, polled until it equals the frontend's
    (links ops carry no handshake)."""
    t0 = time.monotonic()
    while True:
        status, headers, body = _get(
            group.replica + "/deduplication/people?since=0")
        if body == want_body or time.monotonic() - t0 > deadline_s:
            return status, headers, body
        time.sleep(0.05)


@pytest.mark.parametrize("backend", ["sharded-brute", "sharded"])
def test_two_process_serving_full_rest_surface(backend, tmp_path,
                                               jax_oracle):
    xml = _durable_xml(tmp_path / backend)
    group = Group(backend, xml, tmp_path)
    ingest = f"{group.base}/deduplication/people/crm"
    try:
        group.wait_up()
        for batch in (B1, B2):
            status, body = _post(ingest, batch)
            assert status == 200 and json.loads(body)["success"] is True
        errors = []

        def poster(batch):
            try:
                if _post(ingest, batch)[0] != 200:
                    errors.append("status")
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

        threads = [threading.Thread(target=poster, args=(b,)) for b in CONC]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=CHILD_TIMEOUT_S)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        assert _post(ingest, DELETE)[0] == 200
        status, body = _post(ingest + "/httptransform", PROBE)
        assert status == 200
        transform = {(link["entityId"], round(link["confidence"], 9))
                     for link in json.loads(body)["duke_links"]}
        # a hot reload: the follower swaps its replicas in lockstep
        status, _ = _post(f"{group.base}/config", xml.encode(),
                          ctype="application/xml")
        assert status in (200, 302)
        assert _post(ingest, B3)[0] == 200

        status, _, feed = _get(f"{group.base}/deduplication/people?since=0")
        rows = json.loads(feed)
        live, retracted = _live(rows), _retracted(rows)
        stats = json.loads(_get(f"{group.base}/stats")[2])
        assert stats["workloads"][0]["records_indexed"] > 0
        # the follower serves the same feed from its replica
        status, headers, body = _replica_caught_up(group, feed)
        assert status == 200 and body == feed
        assert headers.get("X-Replica-Lag") == "0"
        metrics = _get(f"{group.base}/metrics")[2].decode()
        assert "duke_dispatch_followers 1" in metrics
        assert "duke_follower_evictions_total 0" in metrics
        # the ring rematch across both processes re-emits the feed's
        # links: an intact link DB stays as it was
        status, body = _post(f"{group.base}/deduplication/people/rematch",
                             [])
        assert status == 200
        rstats = json.loads(body)
        assert rstats["devices"] == 4 and rstats["queries"] > 0
        assert rstats["events"] == len(live)
        assert _live(json.loads(_get(
            f"{group.base}/deduplication/people?since=0")[2])) == live
    finally:
        group.stop()
    assert (live, retracted, transform) == jax_oracle


def test_prober_cycle_and_explain_return_on_the_group(tmp_path):
    """The prober's shadow workload runs on the frontend alone (the
    frontend's own shards as a mesh of one process) and the explain
    replay through the op stream: both return and leave the group in
    lockstep."""
    group = Group("sharded", DEDUP_XML, tmp_path,
                  {"DUKE_PROBE_INTERVAL_S": "0.5"})
    ingest = f"{group.base}/deduplication/people/crm"
    try:
        group.wait_up()
        assert _post(ingest, B1)[0] == 200
        t0 = time.monotonic()
        while True:
            probes = json.loads(_get(f"{group.base}/debug/probes")[2])
            done = [w for w in probes["workloads"] if w["ok_cycles"] >= 1]
            if done or time.monotonic() - t0 > CHILD_TIMEOUT_S / 2:
                break
            time.sleep(0.2)
        assert done, probes
        assert not probes["mismatches"]
        rows = json.loads(_get(
            f"{group.base}/deduplication/people?since=0")[2])
        pair = next(r for r in rows if not r["_deleted"])
        status, body = _post(f"{group.base}/explain", {
            "name": "people", "id1": f"crm__{pair['entity1']}",
            "id2": f"crm__{pair['entity2']}"})
        assert status == 200
        explain = json.loads(body)
        assert explain["retrieval"]["retrieved"] is True
        # the group still serves in lockstep after both
        assert _post(ingest, B2)[0] == 200
        metrics = _get(f"{group.base}/metrics")[2].decode()
        assert "duke_dispatch_followers 1" in metrics
        assert "duke_dispatch_down 0" in metrics
    finally:
        group.stop()


# 164 records before the explained pair: at the test knobs (DEVICE_CHUNK
# 64, a global mesh of 4) the capacity is 256 rows, 64 a shard, so the
# candidate's row lies on the follower's shards (rows 128-255)
FILLER = _seeded_batch(140, prefix="f")
FAR = {"_id": "far", "name": "solitary candidate", "email": "solo@x.no"}
FAR_COPY = dict(FAR, _id="far-copy")
EXPLAIN_POSTS = [B1, FILLER, [FAR], [FAR_COPY]]


def _reference_retrievals():
    """The explained pair's retrieval provenance from the JAX package's
    sharded ``ann`` index on its in-process CPU mesh, and from the port's
    on a single-process global mesh of 4 CPU shards, fed the group's
    POSTs; with the candidate's shard in the port's layout."""
    import torch

    from sesam_duke_microservice_tpu.engine import explain as JX
    from sesam_duke_microservice_tpu_torch.core.config import (
        parse_config as tparse)
    from sesam_duke_microservice_tpu_torch.engine import (
        explain as TX, sharded_matcher as TSM)
    from sesam_duke_microservice_tpu_torch.engine.workload import (
        build_workload as tbuild)

    out = {}
    for name, parse, build, X, kw in (
            ("jax", jparse, jbuild, JX, {}),
            ("port", tparse, tbuild, TX, {"device": "cpu"})):
        if name == "port":
            TSM.set_serving_devices([torch.device("cpu")] * 4)
        sc = parse(DEDUP_XML, env={"MIN_RELEVANCE": "0.05"})
        wl = build(sc.deduplications["people"], sc, backend="sharded",
                   persistent=False, **kw)
        try:
            with wl.lock:
                for batch in EXPLAIN_POSTS:
                    wl.process_batch("crm", batch)
                find = wl.index.find_record_by_id
                out[name] = X.retrieval_provenance(
                    wl, find("crm__far-copy"), find("crm__far"))
                if name == "port":
                    local = wl.index.corpus.capacity // wl.index.mesh.size
                    out["shard"] = wl.index.id_to_row["crm__far"] // local
        finally:
            wl.close()
            if name == "port":
                TSM.set_serving_devices(None)
    return out


def test_explain_ranks_a_candidate_on_the_follower_shards(tmp_path):
    """``POST /explain`` on a group whose mesh spans processes gives the
    JAX package's retrieval provenance for a candidate held on the
    follower's shards: retrieved, at its rank among the whole corpus's
    rows (a frontend-only replay would rank among its own rows and say
    the candidate was never retrieved)."""
    group = Group("sharded", DEDUP_XML, tmp_path)
    ingest = f"{group.base}/deduplication/people/crm"
    try:
        # the references build while the children start
        ref = _reference_retrievals()
        assert ref["shard"] >= 2  # the follower holds global shards 2, 3
        assert ref["jax"]["retrieved"] is True
        group.wait_up()
        for batch in EXPLAIN_POSTS:
            assert _post(ingest, batch)[0] == 200
        status, body = _post(f"{group.base}/explain", {
            "name": "people", "id1": "crm__far-copy", "id2": "crm__far"})
        assert status == 200
        got = json.loads(body)["retrieval"]
        for key in ("retrieved", "rank"):
            assert got[key] == ref["jax"][key] == ref["port"][key], key
        # the explain op kept the group in lockstep
        assert _post(ingest, B2)[0] == 200
        metrics = _get(f"{group.base}/metrics")[2].decode()
        assert "duke_dispatch_followers 1" in metrics
        assert "duke_dispatch_down 0" in metrics
    finally:
        group.stop()
