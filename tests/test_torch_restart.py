"""Restart from durable state: the port's persistent service against the JAX
package's, over real HTTP, in two tmp data folders.

JAX ``DukeApp(backend="device"|"ann", persistent=True)`` and the port's
``DukeApp(device="cpu", persistent=True)`` take the same POSTs; then:

  * both data folders hold the same state: ``records.sqlite`` and
    ``linkdatabase.sqlite`` row by row, ``corpus_snapshot.npz`` key by key
    (``__fingerprint``, ``__content`` and ``__checksum`` included), and an
    empty journal after ``close()``;
  * each restarts from its snapshot (the route is asserted: the port's
    ``Workload.restore_route``, the JAX package's lazy record mirror) and
    from a replay of the store once the snapshot is gone, serving the
    same feed and the same events on the next POST;
  * cross-open: a copy of the JAX folder served by the port and the
    port's by the JAX package, again from the snapshot;
  * grown value slots and char widths ride in the snapshot, and so does a
    long-text property demoted to the host side (the port restores it; the
    JAX package checks its fingerprint before re-applying the demotion, so
    it replays such a snapshot, its own included); deletion tombstones
    survive the restart, and a store mutated after the save, a changed
    fingerprint, a flipped byte or a truncated file reject the snapshot
    into a replay.

Both link clocks are fixed (a counter each), so feeds and link rows
compare with their timestamps.  Mirrors tests/test_store.py's restart
cases and tests/test_device_matcher.py ``TestSnapshot``.
"""

import contextlib
import itertools
import json
import os
import shutil
import sqlite3
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from sesam_duke_microservice_tpu.core.config import parse_config as jparse
from sesam_duke_microservice_tpu.links import base as jlinkbase
from sesam_duke_microservice_tpu.ops import encoder as JE
from sesam_duke_microservice_tpu.ops import features as JF
from sesam_duke_microservice_tpu.service.app import DukeApp as JApp
from sesam_duke_microservice_tpu.service.app import serve as jserve
from sesam_duke_microservice_tpu.store.records import (
    LazyRecordMap as JLazy,
)
from sesam_duke_microservice_tpu.store.records import (
    SqliteRecordStore as JStore,
)
from sesam_duke_microservice_tpu_torch import telemetry as tport_telemetry
from sesam_duke_microservice_tpu_torch.core.config import (
    parse_config as tparse,
)
from sesam_duke_microservice_tpu_torch.engine import device_matcher as tdm
from sesam_duke_microservice_tpu_torch.links import base as tlinkbase
from sesam_duke_microservice_tpu_torch.ops import embedding as TH
from sesam_duke_microservice_tpu_torch.ops import features as TF
from sesam_duke_microservice_tpu_torch.service.app import DukeApp as TApp
from sesam_duke_microservice_tpu_torch.service.app import serve as tserve
from sesam_duke_microservice_tpu_torch.store.records import LazyRecordMap

from test_torch_slice import _Tape
from torch_jax_cache import jax_cache_off  # noqa: F401

CONFIG = """
<DukeMicroService dataFolder="{folder}">
  <Deduplication name="people">
    <duke>
      <schema>
        <threshold>0.9</threshold>
        <maybe-threshold>0.7</maybe-threshold>
        <property><name>NAME</name>
          <comparator>levenshtein</comparator><low>0.3</low><high>0.88</high>
        </property>
        <property><name>ADDR</name>
          <comparator>levenshtein</comparator><low>0.4</low><high>0.7</high>
        </property>
        <property><name>SSN</name>
          <comparator>exact</comparator><low>0.3</low><high>0.95</high>
        </property>
      </schema>
      <data-source class="io.sesam.dukemicroservice.IncrementalDeduplicationDataSource">
        <param name="dataset-id" value="crm"/>
        <column name="name" property="NAME"/>
        <column name="addr" property="ADDR"/>
        <column name="ssn" property="SSN"/>
      </data-source>
    </duke>
  </Deduplication>
</DukeMicroService>
"""

_FIRST = ["anne", "bjorn", "carl", "dina", "erik", "frida", "geir", "hege",
          "ivar", "jonas", "kari", "lars"]
_LAST = ["hansen", "johansen", "olsen", "larsen", "andersen", "pedersen",
         "nilsen", "kristiansen"]
_STREETS = ["storgata", "kirkeveien", "bygdoy alle", "nordre gate"]


def _entities(n, seed, prefix, *, long_names=False):
    """Seeded people: every third one a near-duplicate of an earlier one
    (one edit in the name), so each batch links within and across
    batches."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if out and i % 3 == 2:
            src = out[int(rng.integers(len(out)))]
            name = src["name"]
            pos = int(rng.integers(len(name)))
            ent = dict(src, _id=f"{prefix}{i}",
                       name=name[:pos] + "x" + name[pos + 1:])
        else:
            name = (f"{_FIRST[int(rng.integers(len(_FIRST)))]} "
                    f"{_LAST[int(rng.integers(len(_LAST)))]}")
            if long_names:
                name += " " + " ".join(
                    _LAST[int(rng.integers(len(_LAST)))] for _ in range(5))
            ent = {"_id": f"{prefix}{i}", "name": name,
                   "addr": f"{_STREETS[int(rng.integers(4))]} "
                           f"{int(rng.integers(1, 40))}",
                   "ssn": str(int(rng.integers(1, 30)))}
        out.append(ent)
    return out


def _growth_batch(demote=False):
    """Multi-valued SSNs (value slots grow to 4) and 40-60-char names (the
    NAME width doubles past 32); with ``demote``, one 300-char address
    (ADDR demotes to the host side)."""
    out = _entities(12, 77, "g", long_names=True)
    out[0]["ssn"] = ["3", "5", "7"]
    out[4]["ssn"] = ["11", "12"]
    if demote:
        out[5]["addr"] = "gate " * 60
    return out


@pytest.fixture(autouse=True)
def _fixed_clocks_and_knobs(monkeypatch):
    # one link clock per package, each a counter: both packages make the
    # same links in the same order, so their timestamps agree
    for base in (jlinkbase, tlinkbase):
        ticks = itertools.count(1_700_000_000_000)
        monkeypatch.setattr(base, "now_millis", lambda t=ticks: next(t))
    # char widths grow with the data, from the base both feature modules
    # read at import
    assert JF.MAX_CHARS == TF.MAX_CHARS
    monkeypatch.delenv("DEVICE_MAX_CHARS", raising=False)
    for knob in ("DUKE_WRITE_BEHIND", "DUKE_JOURNAL", "DUKE_RECOVERY_OVERLAP",
                 "SNAPSHOT_COMPRESS", "DUKE_FAULTS"):
        monkeypatch.delenv(knob, raising=False)
    # the ann backend on its scan route with both numpy encoders
    monkeypatch.setenv("DUKE_TPU_PALLAS", "0")
    monkeypatch.setenv("DEVICE_ANN_FUSED", "0")
    monkeypatch.setattr(JE, "_native_embed", lambda: None)
    monkeypatch.setattr(TH, "_native_embed", lambda: None)


def _fallbacks():
    """The port's snapshot rejections by reason since process start
    (``duke_snapshot_fallbacks_total``)."""
    return {dict(labels)["reason"]: value for _, labels, value
            in tport_telemetry.SNAPSHOT_FALLBACKS.collect().samples}


def _jax_app(folder, backend):
    return JApp(jparse(CONFIG.format(folder=folder)), backend=backend,
                persistent=True)


def _port_app(folder, backend):
    return TApp(tparse(CONFIG.format(folder=folder)), backend=backend,
                device="cpu", persistent=True)


@contextlib.contextmanager
def _served(*apps):
    servers = [serve(app, port=0, host="127.0.0.1")
               for app, serve in zip(apps, (jserve, tserve))]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    try:
        yield [s.server_address[1] for s in servers]
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(timeout=10)
        for app in apps:
            app.close()


def _post(port, body, path="/deduplication/people/crm"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        assert resp.status == 200
        return resp.read()


def _feed(port):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/deduplication/people?since=0",
            timeout=60) as resp:
        assert resp.status == 200
        assert resp.headers.get("X-Recovering") is None
        return resp.read()


def _folder(root):
    return os.path.join(root, "deduplication", "people")


def _route(app):
    wl = app.deduplications["people"]
    if isinstance(app, TApp):
        return wl.restore_route
    return "snapshot" if isinstance(wl.index.records, JLazy) else "replay"


def _table(path, sql):
    conn = sqlite3.connect(path)
    try:
        return conn.execute(sql).fetchall()
    finally:
        conn.close()


def _assert_same_folders(jdir, tdir):
    """Both packages left the same durable state behind."""
    j, t = _folder(jdir), _folder(tdir)
    assert sorted(os.listdir(j)) == sorted(os.listdir(t))
    for name in ("records.sqlite", "linkdatabase.sqlite"):
        for table in (("records", "meta") if name == "records.sqlite"
                      else ("links",)):
            sql = f"SELECT * FROM {table} ORDER BY rowid"
            rows = _table(os.path.join(t, name), sql)
            assert rows == _table(os.path.join(j, name), sql), (name, table)
            assert rows, (name, table)
    for d in (j, t):
        assert os.path.getsize(os.path.join(d, "linkdatabase.journal")) == 0
    with np.load(os.path.join(j, "corpus_snapshot.npz")) as jz, \
            np.load(os.path.join(t, "corpus_snapshot.npz")) as tz:
        assert sorted(tz.files) == sorted(jz.files)
        for key in jz.files:
            a, b = jz[key], tz[key]
            assert (a.dtype.str, a.shape) == (b.dtype.str, b.shape), key
            assert np.array_equal(a, b), key
        return {k: tz[k] for k in tz.files if k.startswith("__")}


def _next_post_events(apps, ports, batch):
    tapes = []
    for app, port in zip(apps, ports):
        tape = _Tape()
        app.deduplications["people"].processor.add_match_listener(tape)
        _post(port, batch)
        tapes.append(tape.events)
    assert tapes[1] == tapes[0]
    assert any(e[0] == "matches" for e in tapes[1])
    return tapes[1]


@pytest.mark.parametrize("backend,int8", [("device", "0"), ("ann", "0"),
                                          ("ann", "1")],
                         ids=["device", "ann-bf16", "ann-int8"])
def test_restart_and_cross_open_match_jax(backend, int8, tmp_path,
                                          monkeypatch):
    monkeypatch.setenv("DUKE_EMB_INT8", int8)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    batches = [_entities(40, 11, "a"), _growth_batch(),
               [{"_id": "a1", "_deleted": True}]]
    apps = (_jax_app(jdir, backend), _port_app(tdir, backend))
    assert [_route(app) for app in apps] == ["replay", None]
    with _served(*apps) as ports:
        for batch in batches:
            for port in ports:
                _post(port, batch)
        feed = _feed(ports[1])
        assert _feed(ports[0]) == feed
    rows = json.loads(feed)
    assert any(r["_deleted"] for r in rows) and len(rows) > 10
    meta = _assert_same_folders(jdir, tdir)
    # the snapshot carries the grown plan: value slots and the NAME width
    assert list(meta["__device_props"]) == ["NAME", "ADDR", "SSN"]
    assert list(meta["__value_slots"]) == [1, 1, 4]
    assert int(meta["__char_widths"][0]) >= 64
    if backend == "ann":
        assert list(meta["__bf16_keys"]) == (
            [] if int8 == "1" else ["feat\x1f__ann__\x1femb"])

    # restart each from its own snapshot
    apps = (_jax_app(jdir, backend), _port_app(tdir, backend))
    assert [_route(app) for app in apps] == ["snapshot", "snapshot"]
    plan = apps[1].deduplications["people"].index.plan
    assert [s.v for s in plan.device_props] == [1, 1, 4]
    assert plan.device_props[0].chars == int(meta["__char_widths"][0])
    with _served(*apps) as ports:
        assert _feed(ports[0]) == _feed(ports[1]) == feed
        _next_post_events(apps, ports, _entities(9, 12, "b"))
        feed = _feed(ports[1])
        assert _feed(ports[0]) == feed
    _assert_same_folders(jdir, tdir)

    # cross-open: each package serves a copy of the other's folder
    xj, xt = str(tmp_path / "port-by-jax"), str(tmp_path / "jax-by-port")
    shutil.copytree(tdir, xj)
    shutil.copytree(jdir, xt)
    apps = (_jax_app(xj, backend), _port_app(xt, backend))
    assert [_route(app) for app in apps] == ["snapshot", "snapshot"]
    with _served(*apps) as ports:
        assert _feed(ports[0]) == _feed(ports[1]) == feed
        _next_post_events(apps, ports, _entities(9, 13, "c"))
        assert _feed(ports[0]) == _feed(ports[1])

    # the replay route: no snapshot
    for d in (jdir, tdir):
        os.remove(os.path.join(_folder(d), "corpus_snapshot.npz"))
    before = _fallbacks()
    apps = (_jax_app(jdir, backend), _port_app(tdir, backend))
    assert [_route(app) for app in apps] == ["replay", "replay"]
    assert _fallbacks() == before  # no snapshot, no rejection
    with _served(*apps) as ports:
        assert _feed(ports[0]) == _feed(ports[1]) == feed
        _next_post_events(apps, ports, _entities(6, 14, "d"))
        assert _feed(ports[0]) == _feed(ports[1])
    _assert_same_folders(jdir, tdir)


def test_demoted_property_restores_from_snapshot(tmp_path):
    """A long-text property demoted to the host side stays demoted across
    a restart: the port restores the demoted plan from its own snapshot
    and from the JAX package's (the same file, key by key), while the JAX
    package replays (see the module docstring); all serve one feed."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    apps = (_jax_app(jdir, "device"), _port_app(tdir, "device"))
    with _served(*apps) as ports:
        for batch in (_entities(30, 31, "a"), _growth_batch(demote=True)):
            for port in ports:
                _post(port, batch)
        feed = _feed(ports[1])
        assert _feed(ports[0]) == feed
    meta = _assert_same_folders(jdir, tdir)
    assert list(meta["__device_props"]) == ["NAME", "SSN"]
    assert list(meta["__value_slots"]) == [1, 4]
    xt = str(tmp_path / "jax-by-port")
    shutil.copytree(jdir, xt)
    before = sum(_fallbacks().values())
    apps = (_jax_app(jdir, "device"), _port_app(tdir, "device"),
            _port_app(xt, "device"))
    assert [_route(app) for app in apps] == ["replay", "snapshot",
                                             "snapshot"]
    assert sum(_fallbacks().values()) == before
    for app in apps[1:]:
        plan = app.deduplications["people"].index.plan
        assert [s.name for s in plan.device_props] == ["NAME", "SSN"]
        assert [p.name for p in plan.host_props] == ["ADDR"]
    with _served(*apps[:2]) as ports:
        assert _feed(ports[0]) == _feed(ports[1]) == feed
        _next_post_events(apps[:2], ports, _entities(9, 32, "b"))
        assert _feed(ports[0]) == _feed(ports[1])
    wl = apps[2].deduplications["people"]
    with wl.lock:
        assert [json.loads(json.dumps(r)) for r in wl.links_since(0)] == \
            json.loads(feed)
    apps[2].close()


def test_tombstones_and_a_stale_snapshot(tmp_path):
    """A deleted record stays deleted across a restart (a fresh duplicate
    of it does not link to it), and a store row changed after the
    snapshot was saved rejects the snapshot into a replay that serves the
    changed value -- in both packages."""
    dirs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    apps = (_jax_app(dirs["jax"], "device"), _port_app(dirs["port"], "device"))
    with _served(*apps) as ports:
        for port in ports:
            _post(port, [{"_id": "1", "name": "maria garcia", "ssn": "4"},
                         {"_id": "2", "name": "maria garcia", "ssn": "4"},
                         {"_id": "3", "name": "ola nordmann", "ssn": "9"}])
            _post(port, [{"_id": "2", "_deleted": True}])
    for name, app in (("jax", _jax_app(dirs["jax"], "device")),
                      ("port", _port_app(dirs["port"], "device"))):
        assert _route(app) == "snapshot"
        wl = app.deduplications["people"]
        with wl.lock:
            wl.process_batch("crm", [{"_id": "4", "name": "maria garcia",
                                      "ssn": "4"}])
            live = {frozenset((r["entity1"], r["entity2"]))
                    for r in wl.links_since(0) if not r["_deleted"]}
        assert live == {frozenset(("1", "4"))}, name
        app.close()

    for name, d in dirs.items():
        store = JStore(os.path.join(_folder(d), "records.sqlite"))
        rec = store.get("crm__3")
        rec.add_value("NAME", "changed behind the snapshot")
        store.put(rec)
        store.close()
    before = _fallbacks().get("content", 0)
    for app in (_jax_app(dirs["jax"], "device"),
                _port_app(dirs["port"], "device")):
        assert _route(app) == "replay"
        rec = app.deduplications["people"].index.find_record_by_id("crm__3")
        assert rec.get_values("NAME") == ["ola nordmann",
                                          "changed behind the snapshot"]
        app.close()
    assert _fallbacks()["content"] == before + 1


def test_snapshot_rejections_replay_and_never_raise(tmp_path, monkeypatch):
    """Each rejection (fingerprint, checksum, corrupt file) replays,
    counts its reason, and serves the same feed; a lazy restore keeps its
    stamp coherent across an update, so the next restart rides the
    snapshot again."""
    d = str(tmp_path / "port")
    app = _port_app(d, "device")
    wl = app.deduplications["people"]
    with wl.lock:
        wl.process_batch("crm", _entities(30, 21, "r"))
        feed = wl.links_since(0)
    app.close()
    snap = os.path.join(_folder(d), "corpus_snapshot.npz")
    grams = os.environ["DEVICE_MAX_GRAMS"]

    app = _port_app(d, "device")
    wl = app.deduplications["people"]
    assert wl.restore_route == "snapshot"
    assert isinstance(wl.index.records, LazyRecordMap)
    with wl.lock:
        wl.process_batch("crm", [{"_id": "r3", "name": "updated three"}])
        feed = wl.links_since(0)
    app.close()
    good = open(snap, "rb").read()
    app = _port_app(d, "device")
    assert app.deduplications["people"].restore_route == "snapshot"
    assert app.deduplications["people"].index.find_record_by_id(
        "crm__r3").get_value("NAME") == "updated three"
    app.close()

    def damaged(kind):
        if kind == "fingerprint":
            monkeypatch.setenv("DEVICE_MAX_GRAMS", str(int(grams) + 1))
            return good
        monkeypatch.setenv("DEVICE_MAX_GRAMS", grams)
        if kind == "corrupt":
            return good[: len(good) // 2]
        with np.load(snap) as z:
            entries = {k: z[k] for k in z.files}
        key = "feat\x1fNAME\x1fchars"
        entries[key] = entries[key].copy()
        entries[key].flat[0] ^= 1
        path = str(tmp_path / "x.npz")
        np.savez(path, **entries)
        return open(path, "rb").read()

    for kind in ("fingerprint", "checksum", "corrupt"):
        data = damaged(kind)
        with open(snap, "wb") as f:
            f.write(data)
        before = _fallbacks().get(kind, 0)
        app = _port_app(d, "device")
        wl = app.deduplications["people"]
        assert wl.restore_route == "replay", kind
        assert _fallbacks()[kind] == before + 1, kind
        with wl.lock:
            assert wl.links_since(0) == feed, kind
        app.close()
        with open(snap, "wb") as f:
            f.write(good)


def _mirror_matches_device(corpus):
    """The device copy equals the host mirror, row for row."""
    feats, valid, deleted, group = corpus.device_arrays()
    for prop, tensors in corpus.feats.items():
        for name, arr in tensors.items():
            want = arr.astype(np.int32) if arr.dtype == np.uint16 else arr
            assert np.array_equal(feats[prop][name].numpy(), want), name
    for dev, host in ((valid, corpus.row_valid), (deleted, corpus.row_deleted),
                      (group, corpus.row_group)):
        assert np.array_equal(dev.numpy(), host)


def test_warm_upload_races_writers(monkeypatch):
    """The background upload of a restored corpus and the ingest path's
    appends and tombstones share the corpus' upload lock: with the
    interpreter switching threads every microsecond, an uploader looping
    ``device_arrays`` beside a writer re-indexing records leaves a device
    copy equal to the host mirror; a failed warm upload is raised by the
    next ``device_arrays``, never swallowed."""
    monkeypatch.setattr(tdm, "_WARM_UPLOAD_MIN_ROWS", 0)
    schema = tparse(CONFIG.format(folder="unused")).deduplications[
        "people"].duke
    index = tdm.DeviceIndex(schema, device="cpu")
    ds = tparse(CONFIG.format(folder="unused")).deduplications[
        "people"].duke.data_sources[0]
    from sesam_duke_microservice_tpu_torch.service.datasource import (
        IncrementalDataSource,
    )

    source = IncrementalDataSource(ds)
    batches = [source.records_for_batch(_entities(40, 100 + k, f"k{k % 5}_"))
               for k in range(30)]
    stop = threading.Event()
    errors = []

    def uploader():
        try:
            while not stop.is_set():
                index.corpus.device_arrays()
        except BaseException as e:  # reported by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=uploader) for _ in range(3)]
        for t in threads:
            t.start()
        for batch in batches:  # ids repeat: tombstones and appends
            for record in batch:
                index.index(record)
            index.commit()
            index.warm_upload_async()
        stop.set()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads) and not errors
    finally:
        sys.setswitchinterval(old)
        stop.set()
    _mirror_matches_device(index.corpus)

    def broken(*args, **kwargs):
        raise RuntimeError("device copy failed")

    real = tdm._to_device
    index.corpus._dirty_full = True
    monkeypatch.setattr(tdm, "_to_device", broken)
    index.warm_upload_async()
    deadline = time.monotonic() + 30
    while index.corpus.warm_error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    monkeypatch.setattr(tdm, "_to_device", real)
    with pytest.raises(RuntimeError, match="warm corpus upload failed"):
        index.corpus.device_arrays()


def test_store_ahead_of_the_index_forces_a_replay(tmp_path, monkeypatch):
    """A batch whose store write committed but whose scoring pass failed
    (here an update of a record the corpus holds, so the id sets still
    agree) latches the workload: no later batch stamps the store hash, so
    the next start rejects the snapshot (``content``) instead of scoring
    the stale features, and replays the store, which holds the update."""
    d = str(tmp_path / "port")
    app = _port_app(d, "device")
    wl = app.deduplications["people"]
    with wl.lock:
        wl.process_batch("crm", _entities(12, 41, "a"))
    real = wl.processor.deduplicate

    def failing(records):
        raise RuntimeError("scoring failed")

    monkeypatch.setattr(wl.processor, "deduplicate", failing)
    with wl.lock, pytest.raises(RuntimeError, match="scoring failed"):
        wl.process_batch("crm", [{"_id": "a0", "name": "ola nordmann"}])
    monkeypatch.setattr(wl.processor, "deduplicate", real)
    with wl.lock:
        wl.process_batch("crm", _entities(6, 42, "b"))
    assert wl._store_dirty
    app.close()
    before = _fallbacks().get("content", 0)
    app = _port_app(d, "device")
    wl = app.deduplications["people"]
    assert wl.restore_route == "replay"
    assert _fallbacks()["content"] == before + 1
    assert wl.index.find_record_by_id("crm__a0").get_value(
        "NAME") == "ola nordmann"
    assert not wl._store_dirty
    app.close()


def test_uncompressed_snapshot_matches_jax(tmp_path, monkeypatch):
    """``SNAPSHOT_COMPRESS=0`` writes a plain ``np.savez`` archive: the same
    arrays as the JAX package's, larger than the compressed one, restored
    from the snapshot by either package."""
    monkeypatch.setenv("SNAPSHOT_COMPRESS", "0")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    apps = (_jax_app(jdir, "device"), _port_app(tdir, "device"))
    with _served(*apps) as ports:
        for port in ports:
            _post(port, _entities(24, 51, "u"))
    _assert_same_folders(jdir, tdir)
    plain = os.path.getsize(os.path.join(_folder(tdir), "corpus_snapshot.npz"))
    for app in (_jax_app(jdir, "device"), _port_app(tdir, "device")):
        assert _route(app) == "snapshot"
        app.close()
    monkeypatch.setenv("SNAPSHOT_COMPRESS", "1")
    app = _port_app(tdir, "device")
    app.close()
    assert os.path.getsize(
        os.path.join(_folder(tdir), "corpus_snapshot.npz")) < plain
