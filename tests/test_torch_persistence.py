"""The port's durable state, unit by unit against the JAX package.

Each case runs the same operations through the JAX class and the port's
and asserts equal results: record-store rows and ``content_hash``, link
rows, byte-equal journal files, equal ``unapplied()`` and
``applied_watermark()``, and the same write-behind, recovery and factory
behaviour.  Mirrors tests/test_store.py (store basics, reopen, the
connection pool, the incremental hash), tests/test_links.py and the
journal / write-behind cases of tests/test_crash_recovery.py.
"""

import logging
import os
import sqlite3
import threading
import time
import types

import pytest

from sesam_duke_microservice_tpu import links as jlinks
from sesam_duke_microservice_tpu.core import records as jrecords
from sesam_duke_microservice_tpu.links import journal as jjournal
from sesam_duke_microservice_tpu.links import replica as jreplica
from sesam_duke_microservice_tpu.links import write_behind as jwb
from sesam_duke_microservice_tpu.store import records as jstore
from sesam_duke_microservice_tpu.utils import atomicio as jatomic
from sesam_duke_microservice_tpu.utils import backoff as jbackoff
from sesam_duke_microservice_tpu.utils import faults as jfaults
from sesam_duke_microservice_tpu.utils import sqlite as jsqlite
from sesam_duke_microservice_tpu_torch import links as tlinks
from sesam_duke_microservice_tpu_torch.core import records as trecords
from sesam_duke_microservice_tpu_torch.links import journal as tjournal
from sesam_duke_microservice_tpu_torch.links import write_behind as twb
from sesam_duke_microservice_tpu_torch.store import records as tstore
from sesam_duke_microservice_tpu_torch.utils import atomicio as tatomic
from sesam_duke_microservice_tpu_torch.utils import backoff as tbackoff
from sesam_duke_microservice_tpu_torch.utils import faults as tfaults
from sesam_duke_microservice_tpu_torch.utils import sqlite as tsqlite
from torch_jax_cache import jax_cache_off  # noqa: F401

JAX = types.SimpleNamespace(
    name="jax", Record=jrecords.Record, ID=jrecords.ID_PROPERTY_NAME,
    store=jstore, links=jlinks, journal=jjournal, wb=jwb,
    encode_link=jreplica.encode_link, sqlite=jsqlite, atomic=jatomic)
PORT = types.SimpleNamespace(
    name="port", Record=trecords.Record, ID=trecords.ID_PROPERTY_NAME,
    store=tstore, links=tlinks, journal=tjournal, wb=twb,
    encode_link=twb.encode_link, sqlite=tsqlite, atomic=tatomic)
BOTH = (JAX, PORT)


@pytest.fixture(autouse=True)
def _no_env_faults():
    # neither package's fault plan may come from the environment here
    jfaults.configure("")
    tfaults.configure("")
    yield
    jfaults.configure(None)
    tfaults.configure(None)


def _record(pkg, rid, **props):
    r = pkg.Record()
    r.add_value(pkg.ID, rid)
    for k, v in props.items():
        r.add_value(k, v)
    return r


def _rows(store):
    return [(r.record_id, r.to_dict()) for r in store.all_records()]


def _L(pkg, id1, id2, conf=0.95, status="inferred", kind="duplicate",
       ts=None):
    return pkg.links.Link(id1, id2, pkg.links.LinkStatus(status),
                          pkg.links.LinkKind(kind), conf, ts)


def _links(db):
    return sorted((l.id1, l.id2, l.status.value, l.kind.value,
                   l.confidence, l.timestamp) for l in db.get_all_links())


# -- record store -------------------------------------------------------------


def _store_ops(pkg, store):
    out = []
    store.put(_record(pkg, "a__1", NAME="ann"))
    store.put(_record(pkg, "a__2", NAME="bob"))
    out.append(store.count())
    out.append(store.get("a__1").to_dict())
    out.append(store.get("missing"))
    store.put(_record(pkg, "a__1", NAME="anna"))  # replace on the same id
    out.append((store.count(), store.get("a__1").get_value("NAME")))
    out.append([r.record_id for r in store.all_records()])
    with pytest.raises(ValueError):
        store.put(pkg.Record())
    # duplicate ids within one batch: the last occurrence wins
    store.put_many([_record(pkg, "b__1", NAME="v1"),
                    _record(pkg, "b__1", NAME="v2")])
    out.append(store.get("b__1").get_value("NAME"))
    out.append(_rows(store))
    out.append(store.content_hash())
    return out


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_store_basics_match(kind):
    def make(pkg):
        return (pkg.store.InMemoryRecordStore() if kind == "memory"
                else pkg.store.SqliteRecordStore(":memory:"))

    got = [_store_ops(pkg, make(pkg)) for pkg in BOTH]
    assert got[0] == got[1]
    if kind == "sqlite":
        assert got[1][-1] != tstore.EMPTY_CONTENT_HASH.hex()


def test_store_files_cross_open(tmp_path):
    """The port's records.sqlite opens in the JAX package and the JAX
    package's in the port: same rows, same content hash, same meta row."""
    recs = {
        "x__1": dict(NAME="åse", EMAIL="a@x.no"),
        "x__2": dict(NAME="\U0001F600 emoji", EMAIL="b@x.no"),
        "x__3": dict(NAME="plain"),
    }
    paths = {}
    for pkg in BOTH:
        path = str(tmp_path / f"{pkg.name}.sqlite")
        store = pkg.store.SqliteRecordStore(path)
        store.put_many([_record(pkg, rid, **v) for rid, v in recs.items()])
        store.put(_record(pkg, "x__3", NAME="replaced"))
        store.close()
        paths[pkg.name] = path
    dumps = {}
    for name, path in paths.items():
        conn = sqlite3.connect(path)
        dumps[name] = (
            conn.execute("SELECT id, data FROM records ORDER BY rowid")
            .fetchall(),
            conn.execute("SELECT key, value FROM meta").fetchall())
        conn.close()
    assert dumps["jax"] == dumps["port"]
    for reader, writer in ((PORT, "jax"), (JAX, "port")):
        store = reader.store.SqliteRecordStore(paths[writer])
        other = (JAX if reader is PORT else PORT).store.SqliteRecordStore(
            paths[reader.name])
        assert _rows(store) == _rows(other)
        assert store.content_hash() == other.content_hash()
        assert sorted(store.row_digests()) == sorted(other.row_digests())
        store.close()
        other.close()


def test_content_hash_incremental_equals_rebuild(tmp_path):
    hashes = {}
    for pkg in BOTH:
        path = str(tmp_path / f"{pkg.name}.sqlite")
        store = pkg.store.SqliteRecordStore(path)
        empty = store.content_hash()
        store.put_many([_record(pkg, f"id{i}", name=f"n{i}")
                        for i in range(20)])
        store.put_many([_record(pkg, "id3", name="replaced")])
        store.put_many([_record(pkg, "id3", name="replaced")])
        store.put_many([_record(pkg, "id5", name="a"),
                        _record(pkg, "id5", name="b")])
        incremental = store.content_hash()
        assert incremental != empty
        store.close()
        # drop the meta row: reopening rebuilds the same hash from rows
        conn = sqlite3.connect(path)
        conn.execute("DELETE FROM meta WHERE key='content_hash'")
        conn.commit()
        conn.close()
        store = pkg.store.SqliteRecordStore(path)
        assert store.content_hash() == incremental
        store.close()
        hashes[pkg.name] = incremental
    assert hashes["jax"] == hashes["port"]


@pytest.mark.parametrize("values", [
    {"NAME": ["ann"]},
    {"NAME": ["a", "b"], "EMAIL": ["x@y"]},
    {"NAME": ["åse é中"], "X": ["\U0001F600"]},
    {"NAME": ["quote \" back\\slash \n nl"]},
])
def test_record_digest_matches(values):
    """The port's one digest (core.records) is the JAX store's, memo and
    store-seeded memo included."""
    recs = {}
    for pkg in BOTH:
        r = _record(pkg, "rid-1")
        for k, vals in values.items():
            for v in vals:
                r.add_value(k, v)
        recs[pkg.name] = r
    tdig = trecords.record_digest(recs["port"])
    assert tdig == jstore.record_digest(recs["jax"])
    assert trecords.serialize_record(recs["port"]) == \
        jstore.serialize_record(recs["jax"])
    recs["port"].add_value("NAME", "more")
    assert trecords.record_digest(recs["port"]) != tdig
    store = tstore.SqliteRecordStore(":memory:")
    rec = _record(PORT, "y", NAME="z")
    store.put(rec)
    assert rec._digest_cache == trecords.record_digest(_record(PORT, "y",
                                                               NAME="z"))
    store.close()


def test_lazy_record_map_matches():
    out = {}
    for pkg in BOTH:
        store = pkg.store.SqliteRecordStore(":memory:")
        store.put_many([_record(pkg, f"r{i}", NAME=f"n{i}")
                        for i in range(6)])
        lazy = pkg.store.LazyRecordMap(store)
        seen = [len(lazy), "r2" in lazy, "zz" in lazy,
                lazy.get("r2").to_dict(), lazy.get("zz")]
        lazy["r9"] = _record(pkg, "r9", NAME="written")
        seen += ["r9" in lazy, sorted(lazy), lazy["r9"].to_dict(),
                 sorted(r.record_id for r in lazy.values())]
        lazy.prefetch(["r3", "r4", "r9", "zz"])
        seen.append(sorted(lazy._lru))
        with pytest.raises(KeyError):
            lazy["zz"]
        out[pkg.name] = seen
        store.close()
    assert out["jax"] == out["port"]


def test_connection_pool_prunes_dead_threads(tmp_path):
    pool = tsqlite.SqliteConnectionPool(str(tmp_path / "p.sqlite"))
    pool.conn()

    def worker():
        pool.conn()

    for _ in range(8):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    # a fresh thread's acquisition prunes the 8 dead threads' connections
    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert len(pool._conns) == 2
    pool.close()
    with pytest.raises(sqlite3.ProgrammingError):
        pool.conn()
    shared = tsqlite.SqliteConnectionPool(":memory:")
    assert shared.conn() is shared.conn()
    shared.close()


# -- link databases -----------------------------------------------------------


def _link_ops(pkg, db):
    out = []
    db.assert_link(_L(pkg, "a", "b", ts=100))
    db.assert_link(_L(pkg, "a", "c", ts=200))
    out.append(sorted(l.key() for l in db.get_all_links_for("a")))
    out.append([l.key() for l in db.get_all_links_for("c")])
    out.append(db.get_all_links_for("zzz"))
    # identical re-assert keeps the timestamp
    db.assert_link(_L(pkg, "a", "b", conf=0.95 + 1e-9, ts=999))
    out.append(_links(db))
    db.assert_link(_L(pkg, "a", "b", conf=0.8, ts=1000))
    db.assert_link(_L(pkg, "a", "b", conf=0.8, status="retracted",
                      ts=1500))
    out.append(_links(db))
    db.assert_links([_L(pkg, "c", "d", ts=1600), _L(pkg, "e", "f", ts=1700),
                     _L(pkg, "c", "d", conf=0.95 + 1e-9, ts=1800),
                     _L(pkg, "e", "f", conf=0.5, kind="maybe", ts=1900)])
    out.append([l.key() for l in db.get_changes_since(200)])
    out.append([l.key() for l in db.get_changes_page(0, 2)])
    out.append(sorted(l.key() for l in db.get_links_for_ids(["a", "f"])))
    out.append(db.count())
    for link in db.get_all_links_for("c"):
        link.retract()
        db.assert_link(link)
    out.append([(l.key(), l.status.value)
                for l in db.get_changes_since(1900)])
    out.append(db.get_changes_since(10 ** 15))
    return out


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_link_database_matches(kind, tmp_path):
    def make(pkg):
        if kind == "memory":
            return pkg.links.InMemoryLinkDatabase()
        return pkg.links.SqliteLinkDatabase(
            str(tmp_path / f"{pkg.name}.sqlite"))

    got = [_link_ops(pkg, make(pkg)) for pkg in BOTH]
    assert got[0] == got[1]


def test_link_sqlite_files_cross_open(tmp_path):
    for pkg in BOTH:
        db = pkg.links.SqliteLinkDatabase(str(tmp_path / f"{pkg.name}.sqlite"))
        db.assert_links([_L(pkg, "a", "b", ts=42),
                         _L(pkg, "c", "d", conf=0.6, kind="maybe", ts=43)])
        db.close()
    schemas = {}
    for pkg in BOTH:
        conn = sqlite3.connect(str(tmp_path / f"{pkg.name}.sqlite"))
        schemas[pkg.name] = conn.execute(
            "SELECT type, name, sql FROM sqlite_master ORDER BY name"
        ).fetchall()
        conn.close()
    assert schemas["jax"] == schemas["port"]
    for reader, writer in ((PORT, JAX), (JAX, PORT)):
        db = reader.links.SqliteLinkDatabase(
            str(tmp_path / f"{writer.name}.sqlite"))
        assert _links(db) == [("a", "b", "inferred", "duplicate", 0.95, 42),
                              ("c", "d", "inferred", "maybe", 0.6, 43)]
        db.close()


# -- the journal --------------------------------------------------------------

ROWS1 = [("a", "b", "inferred", "duplicate", 0.9, 111)]
ROWS2 = [("c", "d", "inferred", "maybe", 0.5, 222),
         ("e", "f", "retracted", "duplicate", 0.7, 333)]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_journal_roundtrip_and_watermark(tmp_path):
    files, states = {}, {}
    for pkg in BOTH:
        path = str(tmp_path / f"{pkg.name}.journal")
        j = pkg.journal.LinkJournal(path, sync="none")
        assert j.append_batch(ROWS1) == 1
        assert j.append_batch(ROWS2) == 2
        j.mark_applied(1)
        assert j.pending_batches == 1
        j.close()
        files[pkg.name] = _bytes(path)
        j2 = pkg.journal.LinkJournal(path)
        states[pkg.name] = (j2.pending_batches, j2.applied_watermark(),
                            j2.unapplied(), j2.append_batch(ROWS1))
        j2.close()
        files[pkg.name + "2"] = _bytes(path)
    assert files["jax"] == files["port"] and files["jax2"] == files["port2"]
    assert states["jax"] == states["port"]
    assert states["port"] == (1, 1, [(2, [list(r) for r in ROWS2])], 3)
    # each package replays the other's file
    for reader, writer in ((PORT, JAX), (JAX, PORT)):
        path = str(tmp_path / f"x-{writer.name}.journal")
        with open(path, "wb") as f:
            f.write(files[writer.name])
        j = reader.journal.LinkJournal(path)
        assert (j.applied_watermark(), j.unapplied()) == (
            1, [(2, [list(r) for r in ROWS2])])
        j.close()


@pytest.mark.parametrize("damage", ["torn_header", "flipped_payload"])
def test_journal_damaged_tail_truncated(tmp_path, damage):
    """A torn tail (half a frame header) or a corrupt frame truncates from
    there, counted, never fatal; both packages cut at the same byte."""
    out = {}
    for pkg in BOTH:
        path = str(tmp_path / f"{pkg.name}.journal")
        j = pkg.journal.LinkJournal(path, sync="none")
        j.append_batch(ROWS1)
        first = os.path.getsize(path)
        j.append_batch(ROWS2)
        j.close()
        raw = bytearray(_bytes(path))
        if damage == "torn_header":
            raw += b"B\x07\x00\x00"
            keep = len(raw) - 4
        else:
            raw[first + 20] ^= 0xFF
            keep = first
        with open(path, "wb") as f:
            f.write(bytes(raw))
        j2 = pkg.journal.LinkJournal(path)
        assert os.path.getsize(path) == keep
        seqs = [seq for seq, _ in j2.unapplied()]
        nxt = j2.append_batch([("e", "f", "inferred", "duplicate", 0.7, 3)])
        if pkg is PORT:
            assert j2.torn_tails == 1
        j2.close()
        out[pkg.name] = (seqs, nxt, _bytes(path))
    assert out["jax"] == out["port"]
    assert out["port"][0] == ([1, 2] if damage == "torn_header" else [1])


@pytest.mark.parametrize("sync", ["fsync", "fdatasync", "none"])
def test_journal_compacts_to_empty_when_applied(tmp_path, sync):
    for pkg in BOTH:
        path = str(tmp_path / f"{pkg.name}.journal")
        j = pkg.journal.LinkJournal(path, sync=sync)
        for i in range(3):
            seq = j.append_batch([("a", f"b{i}", "inferred", "duplicate",
                                   0.9, i)])
            j.mark_applied(seq)
        assert j.applied_watermark() == 3
        j.close()
        assert os.path.getsize(path) == 0
        j2 = pkg.journal.LinkJournal(path)
        assert j2.unapplied() == [] and j2.applied_watermark() == 0
        j2.close()


def test_journal_sync_policy_and_recovery_scopes(monkeypatch):
    for value in ("fsync", "none", "fdatasync", "bogus", None):
        if value is None:
            monkeypatch.delenv("DUKE_JOURNAL_SYNC", raising=False)
        else:
            monkeypatch.setenv("DUKE_JOURNAL_SYNC", value)
        assert tjournal.sync_policy() == jjournal.sync_policy()
    assert tjournal.DEFAULT_SYNC_POLICY == jjournal.DEFAULT_SYNC_POLICY
    assert not tjournal.recovery_active(None)
    tjournal.recovery_begin("/a")
    assert tjournal.recovery_active("/a") and not tjournal.recovery_active("/b")
    with tjournal.recovery_in_progress(""):
        assert tjournal.recovery_active("/b")
    tjournal.recovery_end("/a")
    assert not tjournal.recovery_active(None)


# -- write-behind -------------------------------------------------------------


def test_commit_journals_before_flush(tmp_path):
    for pkg in BOTH:
        entered, release = threading.Event(), threading.Event()

        class Slow(pkg.links.InMemoryLinkDatabase):
            def assert_links(self, links):
                entered.set()
                release.wait(10)
                super().assert_links(links)

        j = pkg.journal.LinkJournal(str(tmp_path / f"{pkg.name}.journal"),
                                    sync="none")
        db = pkg.wb.WriteBehindLinkDatabase(Slow(), journal=j)
        db.assert_link(_L(pkg, "a", "b", ts=1))
        db.commit()
        assert entered.wait(10)
        assert j.pending_batches >= 1  # journaled while the flush hangs
        release.set()
        db.drain()
        assert j.pending_batches == 0 and j.applied_watermark() == 1
        db.close()
        assert os.path.getsize(j.path) == 0


def test_recover_replays_exactly_once(tmp_path, monkeypatch):
    monkeypatch.setenv("DUKE_FLUSH_RETRIES", "0")
    out = {}
    for pkg in BOTH:
        class Broken(pkg.links.SqliteLinkDatabase):
            def assert_links(self, links):
                raise OSError("disk gone")

        jpath = str(tmp_path / f"{pkg.name}.journal")
        spath = str(tmp_path / f"{pkg.name}.sqlite")
        db = pkg.wb.WriteBehindLinkDatabase(
            Broken(spath), journal=pkg.journal.LinkJournal(jpath,
                                                           sync="none"))
        db.assert_link(_L(pkg, "a", "b", conf=0.91, ts=1000))
        db.assert_link(_L(pkg, "c", "d", conf=0.92, ts=1001))
        db.commit()
        deadline = time.monotonic() + 10
        while db.flush_error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert db.flush_error is not None  # latched; rows only journaled
        with pytest.raises(RuntimeError, match="flush failed"):
            db.drain()
        db.close()
        stranded = _bytes(jpath)
        inner = pkg.links.SqliteLinkDatabase(spath)
        db2 = pkg.wb.WriteBehindLinkDatabase(
            inner, journal=pkg.journal.LinkJournal(jpath))
        replayed = (db2.recover(), db2.recover())
        out[pkg.name] = (stranded, replayed, _links(inner),
                         os.path.getsize(jpath))
        if pkg is PORT:
            assert db2.replayed == 1
        db2.close()
    assert out["jax"] == out["port"]
    assert out["port"][1:] == ((1, 0), [
        ("a", "b", "inferred", "duplicate", 0.91, 1000),
        ("c", "d", "inferred", "duplicate", 0.92, 1001)], 0)


def test_flush_retry_heals_transient_error(tmp_path, monkeypatch):
    for pkg in BOTH:
        monkeypatch.setenv("DUKE_FLUSH_RETRIES", "3")
        attempts = []

        class Flaky(pkg.links.InMemoryLinkDatabase):
            def assert_links(self, links):
                attempts.append(len(links))
                if len(attempts) == 1:
                    raise OSError("transient EIO")
                super().assert_links(links)

        db = pkg.wb.WriteBehindLinkDatabase(
            Flaky(), journal=pkg.journal.LinkJournal(
                str(tmp_path / f"{pkg.name}.journal"), sync="none"))
        db.assert_link(_L(pkg, "a", "b"))
        db.commit()
        db.drain()  # the retry healed it
        assert db.flush_error is None and len(attempts) == 2
        assert db.count() == 1
        db.close()


def test_journal_failure_fails_commit_before_ack(tmp_path):
    for pkg in BOTH:
        j = pkg.journal.LinkJournal(str(tmp_path / f"{pkg.name}.journal"),
                                    sync="none")
        db = pkg.wb.WriteBehindLinkDatabase(pkg.links.InMemoryLinkDatabase(),
                                            journal=j)
        os.close(j._fd)  # the journal device goes away
        j._fd = os.open(os.devnull, os.O_RDONLY)
        db.assert_link(_L(pkg, "a", "b"))
        with pytest.raises(OSError):
            db.commit()
        os.close(j._fd)
        j._fd = os.open(j.path, os.O_RDWR | os.O_CREAT | os.O_APPEND)
        db.commit()  # the batch stayed buffered
        db.drain()
        assert db.count() == 1
        db.close()


def test_encode_decode_link_match():
    for status, kind in (("inferred", "duplicate"), ("retracted", "maybe"),
                         ("asserted", "different")):
        jl = _L(JAX, "b", "a", 0.75, status, kind, ts=5)
        tl = _L(PORT, "b", "a", 0.75, status, kind, ts=5)
        assert twb.encode_link(tl) == jreplica.encode_link(jl)
        back = twb.decode_link(list(jreplica.encode_link(jl)))
        assert twb.encode_link(back) == twb.encode_link(tl)


# -- the factory --------------------------------------------------------------


def test_factory_matches(tmp_path, monkeypatch):
    for knob in ("DUKE_WRITE_BEHIND", "DUKE_JOURNAL", "DUKE_RECOVERY_OVERLAP"):
        monkeypatch.delenv(knob, raising=False)
    shapes = {}
    for pkg in BOTH:
        L = pkg.links
        assert isinstance(L.create_link_database("in-memory"),
                          L.InMemoryLinkDatabase)
        assert isinstance(L.create_link_database("h2", None),
                          L.InMemoryLinkDatabase)
        db = L.create_link_database("h2", str(tmp_path / pkg.name / "rl"),
                                    is_record_linkage=True)
        assert isinstance(db, L.WriteBehindLinkDatabase)
        assert db.inner.path.endswith("recordlinkdatabase.sqlite")
        db.close()
        with pytest.raises(ValueError, match="unknown 'link-database-type'"):
            L.create_link_database("bogus")
        monkeypatch.setenv("DUKE_WRITE_BEHIND", "0")
        bare = L.create_link_database("h2", str(tmp_path / pkg.name / "a"))
        monkeypatch.delenv("DUKE_WRITE_BEHIND")
        monkeypatch.setenv("DUKE_JOURNAL", "0")
        nojournal = L.create_link_database("h2", str(tmp_path / pkg.name / "b"))
        monkeypatch.delenv("DUKE_JOURNAL")
        shapes[pkg.name] = (type(bare).__name__, type(nojournal).__name__,
                            nojournal.journal is None,
                            sorted(os.listdir(tmp_path / pkg.name / "rl")))
        bare.close()
        nojournal.close()
    assert shapes["jax"] == shapes["port"]
    assert shapes["port"][:3] == ("SqliteLinkDatabase",
                                  "WriteBehindLinkDatabase", True)


@pytest.mark.parametrize("overlap", ["1", "0"])
def test_factory_recovers_a_stranded_batch(tmp_path, monkeypatch, overlap):
    """A batch journaled and never applied (a crash before the flush)
    replays when the factory opens the folder: inline with
    DUKE_RECOVERY_OVERLAP=0, behind the write fence otherwise."""
    monkeypatch.setenv("DUKE_RECOVERY_OVERLAP", overlap)
    monkeypatch.delenv("DUKE_JOURNAL", raising=False)
    out = {}
    for pkg in BOTH:
        d = str(tmp_path / pkg.name)
        db = pkg.links.create_link_database("h2", d)
        db.assert_link(_L(pkg, "a", "b", ts=5))
        db.commit()
        db.close()
        j = pkg.journal.LinkJournal(os.path.join(d, "linkdatabase.journal"))
        j.append_batch([("x", "y", "inferred", "duplicate", 0.8, 6)])
        j.close()
        db2 = pkg.links.create_link_database("h2", d)
        db2.drain()
        rows = _links(db2)
        db2.assert_link(_L(pkg, "p", "q", ts=7))  # waits out the fence
        db2.commit()
        db2.drain()
        out[pkg.name] = (rows, _links(db2), db2.journal.pending_batches,
                         db2.journal.applied_watermark())
        db2.close()
        assert os.path.getsize(os.path.join(d, "linkdatabase.journal")) == 0
    assert out["jax"] == out["port"]
    assert [r[:2] for r in out["port"][0]] == [("a", "b"), ("x", "y")]


def test_overlapped_recovery_fences_writes_and_serves_reads(tmp_path,
                                                            monkeypatch):
    """While the replay runs the wrapper reports ``recovering``, the
    data folder's scope is active, reads serve the committed prefix and
    a write waits for the replay to finish."""
    monkeypatch.delenv("DUKE_JOURNAL", raising=False)
    monkeypatch.delenv("DUKE_RECOVERY_OVERLAP", raising=False)
    d = str(tmp_path / "wl")
    db = tlinks.create_link_database("h2", d)
    db.close()
    j = tjournal.LinkJournal(os.path.join(d, "linkdatabase.journal"))
    j.append_batch([("x", "y", "inferred", "duplicate", 0.8, 6)])
    j.close()
    gate = threading.Event()
    real = tlinks.SqliteLinkDatabase.assert_links

    def held(self, links):
        gate.wait(10)
        return real(self, links)

    monkeypatch.setattr(tlinks.SqliteLinkDatabase, "assert_links", held)
    db = tlinks.create_link_database("h2", d)
    try:
        assert db.recovering and tjournal.recovery_active(d)
        assert db.inner.get_changes_since(0) == []  # the prefix: nothing
        writer = threading.Thread(
            target=lambda: (db.assert_link(_L(PORT, "p", "q", ts=7)),
                            db.commit()))
        writer.start()
        writer.join(0.3)
        assert writer.is_alive()  # fenced behind the replay
        gate.set()
        writer.join(10)
        db.drain()
        assert not db.recovering and not tjournal.recovery_active(d)
        assert [l.key() for l in db.get_changes_since(0)] == [("x", "y"),
                                                              ("p", "q")]
        assert db.replayed == 1
    finally:
        gate.set()
        db.close()


def test_opt_out_warns_about_a_stranded_journal(tmp_path, monkeypatch,
                                                caplog):
    d = str(tmp_path / "wl")
    os.makedirs(d)
    j = tjournal.LinkJournal(os.path.join(d, "linkdatabase.journal"))
    j.append_batch([("x", "y", "inferred", "duplicate", 0.8, 6)])
    j.close()
    for knob in ("DUKE_JOURNAL", "DUKE_WRITE_BEHIND"):
        monkeypatch.setenv(knob, "0")
        with caplog.at_level(logging.WARNING, logger="links"):
            caplog.clear()
            db = tlinks.create_link_database("h2", d)
        assert any("NOT being replayed" in r.getMessage()
                   for r in caplog.records), knob
        db.close()
        monkeypatch.setenv(knob, "1")
    db = tlinks.create_link_database("h2", d)  # re-enabled: it replays
    assert {l.key() for l in db.get_all_links()} == {("x", "y")}
    db.close()


# -- small utilities ----------------------------------------------------------


def test_atomic_writes_and_backoff_match(tmp_path, monkeypatch):
    for pkg in BOTH:
        pkg.atomic.atomic_write_json(str(tmp_path / f"{pkg.name}.json"),
                                     {"a": [1, 2], "b": "å"})
        pkg.atomic.atomic_write_bytes(str(tmp_path / f"{pkg.name}.bin"),
                                      b"\x00\x01payload")
    assert _bytes(tmp_path / "jax.json") == _bytes(tmp_path / "port.json")
    assert _bytes(tmp_path / "jax.bin") == _bytes(tmp_path / "port.bin")
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    import random

    for attempt in (1, 2, 5, 40):
        random.seed(attempt)
        a = jbackoff.full_jitter_delay(attempt, 0.05, 2.0)
        random.seed(attempt)
        assert tbackoff.full_jitter_delay(attempt, 0.05, 2.0) == a


def test_fault_spec_arms_only_crash_sites():
    plan = tfaults.FaultPlan("seed=3;drop=0.5@x;crash_at=mid_flush:2,"
                             "flush_fail=1")
    assert not plan.crash_hit("mid_flush") and plan.crash_hit("mid_flush")
    assert not plan.crash_hit("mid_flush")
    assert not plan.crash_hit("pre_flush")
    with pytest.raises(ValueError):
        tfaults.FaultPlan("crash_at=mid_flush")
    tfaults.configure("crash_at=pre_flush:5")
    assert tfaults.active().crash_hit("pre_flush") is False
    tfaults.configure(None)
