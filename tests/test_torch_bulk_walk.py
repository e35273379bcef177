"""The store-backed record mirror's bulk walk, held against the JAX package.

``store.records.LazyRecordMap`` keeps only the id set in memory and decodes
a row from SQLite on first touch.  Its ``values()`` pays one point
``SELECT`` per id; ``bulk_values()`` walks the store's cursor once and
skips ids that are no longer members.  Checked here:

  * ``pop``, ``discard``, ``keys`` and ``bulk_values`` give the JAX
    package's answers on the same rows (exact, no tolerance);
  * a walk of a few hundred rows through ``bulk_values`` makes 0 point
    reads and yields the rows ``values()`` yields, popped ids skipped;
  * the serving group's bootstrap stream (``Dispatcher._stream_state``)
    of a corpus restored from its snapshot -- whose mirror is store-backed
    -- streams every live record with 0 point reads, after deletes through
    the index interface.
"""

import pytest

from sesam_duke_microservice_tpu.store import records as jstore
from sesam_duke_microservice_tpu_torch.core.config import parse_config
from sesam_duke_microservice_tpu_torch.engine.workload import build_workload
from sesam_duke_microservice_tpu_torch.parallel import dispatch as TD
from sesam_duke_microservice_tpu_torch.store import records as tstore
from sesam_duke_microservice_tpu_torch.utils import faults as TF

from test_sharded_service import DEDUP_XML, _seeded_batch
from test_torch_persistence import JAX, PORT, _record
from torch_threads import torch_threads_per_worker  # noqa: F401

N_ROWS = 300
POPPED = range(0, N_ROWS, 7)


@pytest.fixture(autouse=True)
def _no_env_faults():
    TF.configure("")
    yield
    TF.configure(None)


def _filled(pkg, store):
    store.put_many([_record(pkg, f"r{i}", NAME=f"name {i}", N=str(i))
                    for i in range(N_ROWS)])
    return pkg.store.LazyRecordMap(store)


class _PointReads:
    """Counts the store's point ``get`` calls (the bulk cursor is
    ``all_records``)."""

    def __init__(self, store, monkeypatch):
        self.n = 0
        real = store.get

        def get(rid):
            self.n += 1
            return real(rid)

        monkeypatch.setattr(store, "get", get)


def test_mirror_interface_equals_jax(tmp_path):
    out = {}
    for pkg in (JAX, PORT):
        store = pkg.store.SqliteRecordStore(str(tmp_path / f"{pkg.name}.db"))
        lazy = _filled(pkg, store)
        seen = [lazy.pop("r3").to_dict(), lazy.pop("r3", "gone"),
                lazy.pop("zz", None)]
        lazy.discard("r4")
        lazy.discard("zz")
        seen += [len(lazy), "r3" in lazy, "r4" in lazy, lazy.get("r4"),
                 sorted(lazy.keys()),
                 [r.record_id for r in lazy.bulk_values()],
                 sorted(r.record_id for r in lazy.values())]
        out[pkg.name] = seen
        store.close()
    assert out["jax"] == out["port"]


def test_bulk_values_walks_without_point_reads(tmp_path, monkeypatch):
    store = tstore.SqliteRecordStore(str(tmp_path / "records.sqlite"))
    lazy = _filled(PORT, store)
    for i in POPPED:
        lazy.pop(f"r{i}")
    reads = _PointReads(store, monkeypatch)
    bulk = [r.to_dict() for r in lazy.bulk_values()]
    assert reads.n == 0
    assert len(bulk) == N_ROWS - len(POPPED)
    # the per-id walk decodes the same rows, one point read each
    per_id = [r.to_dict() for r in lazy.values()]
    assert reads.n == len(per_id)
    key = lambda d: d["ID"]  # noqa: E731
    assert sorted(bulk, key=key) == sorted(per_id, key=key)
    # the JAX package's walk of the same rows
    jst = jstore.SqliteRecordStore(str(tmp_path / "records.sqlite"))
    jlazy = jstore.LazyRecordMap(jst)
    for i in POPPED:
        jlazy.pop(f"r{i}")
    assert [r.to_dict() for r in jlazy.bulk_values()] == bulk
    jst.close()
    store.close()


def _persistent_xml(folder):
    return DEDUP_XML.replace(
        "<DukeMicroService>", f'<DukeMicroService dataFolder="{folder}">'
    ).replace(' link-database-type="in-memory"', "")


def test_follower_bootstrap_streams_a_restored_mirror_in_bulk(
        tmp_path, monkeypatch):
    sc = parse_config(_persistent_xml(tmp_path),
                      env={"MIN_RELEVANCE": "0.05"})
    wc = sc.deduplications["people"]
    wl = build_workload(wc, sc, backend="device", device="cpu")
    with wl.lock:
        wl.process_batch("crm", _seeded_batch(N_ROWS))
    wl.close()
    wl = build_workload(wc, sc, backend="device", device="cpu")
    try:
        assert wl.restore_route == "snapshot"
        index = wl.index
        assert isinstance(index.records, tstore.LazyRecordMap)
        for i in POPPED:
            index.delete(index.records[f"crm__{i}"])
        monkeypatch.setattr(TD, "_REC_BATCH", 64)
        d = TD.Dispatcher(app=None)
        frames = []
        d.broadcast = frames.append
        reads = _PointReads(index.records._store, monkeypatch)
        d._stream_state(("deduplication", "people"), index)
        assert reads.n == 0
        streamed = [r for op in frames if op[0] == "recs" for r in op[2]]
        assert all(len(op[2]) <= 64 for op in frames if op[0] == "recs")
        want = list(index.records.values())
        assert len(streamed) == len(want) == N_ROWS - len(POPPED)
        assert (sorted(r.record_id for r in streamed)
                == sorted(r.record_id for r in want))
        by_id = {r.record_id: r.to_dict() for r in want}
        assert all(r.to_dict() == by_id[r.record_id] for r in streamed)
    finally:
        wl.close()
