"""The port's ``CandidateIndex`` interface on its device backends against
the JAX package's.

``find_candidate_matches`` (score one record through the backend's scorer
and return the live records among its survivors) and ``delete`` (pop the
id, tombstone its row, fold the record out of the mirror and its content
hash) on ``device``, ``ann``, ``sharded-brute`` and ``sharded``; the mesh
backends run on ``[cpu] * 8`` in the port and on the JAX package's
8-device CPU mesh (tests/conftest.py).  Twins of
tests/test_device_matcher.py (the deleted-record exclusion, the query
widening of a transform probe, the interface case and the incremental
masks after a delete), tests/test_ann.py (its delete and interface cases)
and tests/test_feature_cache.py (the live-rows oracle), each compared
with the JAX index on the same records.  Every comparison is exact:
candidate id sets, ordered event tapes, link rows, host masks, live
counts and the content hash are equal, no tolerance.  A delete reaches
the device by the incremental mask copy: ``corpus._dirty_full`` stays
false and ``duke_corpus_full_uploads_total`` does not move.
"""

import numpy as np
import pytest
import torch

from sesam_duke_microservice_tpu.core.config import MatchTunables
from sesam_duke_microservice_tpu.engine import sharded_matcher as JSM
from sesam_duke_microservice_tpu.engine.ann_matcher import (
    AnnIndex as JAnnIndex,
    AnnProcessor as JAnnProcessor,
)
from sesam_duke_microservice_tpu.ops import encoder as JE
from sesam_duke_microservice_tpu.ops import scoring as JS
from sesam_duke_microservice_tpu_torch import telemetry as ttelemetry
from sesam_duke_microservice_tpu_torch.engine import device_matcher as TDM
from sesam_duke_microservice_tpu_torch.engine import sharded_matcher as TSM
from sesam_duke_microservice_tpu_torch.engine.ann_matcher import (
    AnnIndex as TAnnIndex,
    AnnProcessor as TAnnProcessor,
)
from sesam_duke_microservice_tpu_torch.ops import embedding as TH
from sesam_duke_microservice_tpu_torch.ops import scoring as TS

from test_torch_feature_cache import dedup_schema, random_records
from test_torch_growth import BOTH, JAX, PORT, Run
from torch_jax_cache import jax_cache_off  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

CPU = torch.device("cpu")
BACKENDS = ["device", "ann", "sharded-brute", "sharded"]


@pytest.fixture(autouse=True)
def mesh8(monkeypatch):
    """Eight logical CPU shards for the port's mesh indexes; both
    packages' numpy encoders (bit-identical) for the ``ann`` ones."""
    monkeypatch.setattr(JE, "_native_embed", lambda: None)
    monkeypatch.setattr(TH, "_native_embed", lambda: None)
    mesh = TSM.set_serving_devices([CPU] * 8)
    yield mesh
    TSM.set_serving_devices(None)


def _index(pkg, backend, schema):
    if pkg is JAX:
        cls = {"device": JAX.DM.DeviceIndex, "ann": JAnnIndex,
               "sharded-brute": JSM.ShardedDeviceIndex,
               "sharded": JSM.ShardedAnnIndex}[backend]
        return cls(schema, tunables=MatchTunables())
    cls = {"device": TDM.DeviceIndex, "ann": TAnnIndex,
           "sharded-brute": TSM.ShardedDeviceIndex,
           "sharded": TSM.ShardedAnnIndex}[backend]
    return cls(schema, device="cpu")


def _run(pkg, backend, schema=None):
    schema = schema or dedup_schema(pkg)
    index = _index(pkg, backend, schema)
    if backend in ("ann", "sharded"):
        proc = (JAnnProcessor if pkg is JAX else TAnnProcessor)(schema, index)
    else:
        proc = pkg.DM.DeviceProcessor(schema, index)
    return Run(pkg, schema, index=index, proc=proc)


def _ids(records):
    return sorted(r.record_id for r in records)


@pytest.mark.parametrize("backend", BACKENDS)
def test_find_candidate_matches_equals_jax(backend):
    """tests/test_device_matcher.py's interface case: a probe copying a
    corpus record's values finds it; the candidate id sets of every query
    equal the JAX index's."""
    got = {}
    for pkg in BOTH:
        run = _run(pkg, backend)
        records = random_records(20, seed=5, pkg=pkg)
        run.feed(records)
        r0 = records[0]
        probe = pkg.record("probe", name=r0.get_value("name"),
                           city=r0.get_value("city"),
                           amount=r0.get_value("amount"))
        cands = [_ids(run.index.find_candidate_matches(probe))]
        assert r0.record_id in cands[0]
        # every indexed record as a query: its self row is masked out
        for r in records:
            ids = _ids(run.index.find_candidate_matches(r))
            assert r.record_id not in ids
            cands.append(ids)
        got[pkg.name] = cands
    assert got["port"] == got["jax"]
    assert any(len(c) > 1 for c in got["port"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_transform_probe_widens_query_side_only(backend):
    """A non-indexed probe whose second value is the matching one scores
    through a wider query value axis; the corpus plan stays at one."""
    got = {}
    for pkg in BOTH:
        run = _run(pkg, backend)
        run.feed([pkg.record("a", name="acme inc", city="oslo",
                             amount="100"),
                  pkg.record("x", name="other thing", city="tromso",
                             amount="5")])
        probe = pkg.record("probe", name=["zzz unrelated", "acme inc"],
                           city="oslo", amount="100")
        ids = _ids(run.index.find_candidate_matches(probe))
        assert "a" in ids
        assert all(s.v == 1 for s in run.index.plan.device_props)
        got[pkg.name] = ids
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_delete_excludes_the_record_like_jax(backend):
    """tests/test_ann.py's and tests/test_device_matcher.py's deleted-record
    cases: after ``delete`` the id is gone from the mirror and no later
    query or candidate list meets it; a dukeDeleted re-index stays
    resolvable by id.  Tapes and link rows equal the JAX package's."""
    runs = {}
    for pkg in BOTH:
        run = _run(pkg, backend)
        a = pkg.record("a", name="acme corp", city="oslo", amount="100")
        b = pkg.record("b", name="acme corp", city="oslo", amount="100")
        d = pkg.record("d", name="acme corp", city="oslo", amount="100")
        run.feed([a, b, d])
        assert "a" in _ids(run.index.find_candidate_matches(b))
        run.index.delete(a)
        assert run.index.find_record_by_id("a") is None
        assert "a" not in run.index.id_to_row
        dead = pkg.record("d", name="acme corp", city="oslo", amount="100")
        dead.add_value("dukeDeleted", "true")
        run.index.index(dead)
        run.index.commit()
        assert run.index.find_record_by_id("d") is not None
        c = pkg.record("c", name="acme corp", city="oslo", amount="100")
        assert _ids(run.index.find_candidate_matches(c)) == ["b"]
        run.feed([c])
        assert run.index.live_records == 2
        runs[pkg.name] = run
    jrun, trun = runs["jax"], runs["port"]
    assert trun.tape.events == jrun.tape.events
    assert trun.rows() == jrun.rows()
    last = [e for e in trun.tape.events if e[0] == "match" and e[1] == "c"]
    assert {e[2] for e in last} == {"b"}


@pytest.mark.parametrize("backend", BACKENDS)
def test_delete_masks_go_up_incrementally(backend):
    """tests/test_device_matcher.py's mask case: re-indexes, a delete and
    new ids; the device masks equal the host mirror and the JAX package's
    mirror, and the tombstones went up by the incremental mask copy."""
    mirrors = {}
    for pkg in BOTH:
        index = _index(pkg, backend, dedup_schema(pkg))
        for r in random_records(40, seed=1, pkg=pkg):
            index.index(r)
        index.commit()
        index.corpus.device_arrays()
        b2 = random_records(20, seed=1, pkg=pkg)  # same ids: re-index
        for r in b2:
            index.index(r)
        index.commit()
        index.delete(b2[0])
        if pkg is PORT:
            corpus = index.corpus
            assert not corpus._dirty_full and corpus._mask_rows
            full = ttelemetry.CORPUS_FULL_UPLOADS.single().value
            _, valid, deleted, group = corpus.device_arrays()
            assert ttelemetry.CORPUS_FULL_UPLOADS.single().value == full
            assert not corpus._dirty_full and not corpus._mask_rows
            if isinstance(valid, (list, tuple)):  # per-shard tensors
                valid, deleted, group = (torch.cat(list(t)) for t in
                                         (valid, deleted, group))
            np.testing.assert_array_equal(valid.numpy(), corpus.row_valid)
            np.testing.assert_array_equal(deleted.numpy(),
                                          corpus.row_deleted)
            np.testing.assert_array_equal(group.numpy(), corpus.row_group)
        else:
            index.corpus.device_arrays()
            assert not index.corpus._dirty_masks
        c = index.corpus
        mirrors[pkg.name] = (c.row_valid[:c.size].tolist(),
                             c.row_deleted[:c.size].tolist(),
                             c.row_group[:c.size].tolist(),
                             sorted(index.id_to_row.items()), c.live_rows)
        index.close()
    assert mirrors["port"] == mirrors["jax"]
    assert mirrors["port"][4] == 39


@pytest.mark.parametrize("backend", BACKENDS)
def test_live_rows_counter_matches_mask_formula(backend):
    """tests/test_feature_cache.py's live-rows oracle through upserts,
    deletes and a dukeDeleted append, in both packages."""
    counts = {}
    for pkg in BOTH:
        run = _run(pkg, backend)
        index = run.index

        def oracle():
            c = index.corpus
            return int(c.row_valid.sum() - c.row_deleted[c.row_valid].sum())

        seen = []
        run.feed(random_records(20, seed=31, pkg=pkg))
        seen.append((index.corpus.live_rows, oracle()))
        run.feed(random_records(10, seed=31, pkg=pkg))
        seen.append((index.corpus.live_rows, oracle()))
        for r in random_records(5, seed=31, pkg=pkg):
            index.delete(r)
        # a second delete of a deleted id changes nothing
        index.delete(random_records(1, seed=31, pkg=pkg)[0])
        seen.append((index.corpus.live_rows, oracle()))
        tomb = pkg.record("t0", name="acme corp", city="oslo", amount="100")
        tomb.add_value("dukeDeleted", "true")
        index.index(tomb)
        index.commit()
        seen.append((index.corpus.live_rows, oracle()))
        counts[pkg.name] = seen
    assert counts["port"] == counts["jax"] == [(20, 20), (20, 20), (15, 15),
                                               (15, 15)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_content_hash_after_delete_equals_jax(backend):
    """The mirror's running content hash folds a deleted record out: equal
    to the JAX index's after the same sequence, and to a fresh index of
    the surviving records."""
    hashes = {}
    for pkg in BOTH:
        run = _run(pkg, backend)
        records = random_records(30, seed=8, pkg=pkg)
        run.feed(records)
        run.feed(random_records(6, seed=9, pkg=pkg))  # re-index r0..r5
        for r in records[10:16]:
            run.index.delete(r)
        run.index.delete(pkg.record("never", name="x"))
        fresh = _run(pkg, backend)
        fresh.feed(list(run.index.records.values()))
        assert fresh.index._content_hash == run.index._content_hash
        hashes[pkg.name] = run.index._content_hash
    assert hashes["port"] == hashes["jax"]
    assert hashes["port"] != bytes(32)


def test_logit_to_probability_equals_jax():
    """``ops.scoring.logit_to_probability`` (f64 on numpy) bit for bit."""
    logits = np.concatenate([
        np.linspace(-40.0, 40.0, 801, dtype=np.float32),
        np.array([0.0, -0.0, 1e-30, -1e-30, 88.0, -88.0], np.float32)])
    got = TS.logit_to_probability(logits)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, JS.logit_to_probability(logits))
    assert TS.logit_to_probability(np.float32(0.0)) == 0.5
