"""The port's shared-memory parallel feature extraction
(``sesam_duke_microservice_tpu_torch.ops.parallel_extract``).

Counterparts of ``tests/test_parallel_extract.py`` with two workers: the
process-pool path gives tensors bit-identical to the serial extractor for
every feature kind (the embedding, uint16 char units and multi-valued
slots included), gates on the slab size, and ``extract_batch`` routes
through it and retries serially when it reports failure.  Across packages:
the port's parallel tensors equal the JAX package's serial extraction of
the same records, bit for bit.
"""

import random

import numpy as np
import pytest

from sesam_duke_microservice_tpu.core import comparators as JC
from sesam_duke_microservice_tpu.core.config import DukeSchema as JSchema
from sesam_duke_microservice_tpu.core.records import Property as JProperty
from sesam_duke_microservice_tpu.core.records import Record as JRecord
from sesam_duke_microservice_tpu.ops import encoder as JE
from sesam_duke_microservice_tpu.ops import features as JF
from sesam_duke_microservice_tpu_torch.core import comparators as C
from sesam_duke_microservice_tpu_torch.core.config import DukeSchema
from sesam_duke_microservice_tpu_torch.core.records import (
    ID_PROPERTY_NAME,
    Property,
    Record,
)
from sesam_duke_microservice_tpu_torch.ops import embedding as E
from sesam_duke_microservice_tpu_torch.ops import features as F
from sesam_duke_microservice_tpu_torch.ops import parallel_extract as PX


def _schema(comparators=C, schema_cls=DukeSchema, prop_cls=Property):
    return schema_cls(
        threshold=0.8, maybe_threshold=None,
        properties=[
            prop_cls(ID_PROPERTY_NAME, id_property=True),
            prop_cls("name", comparators.Levenshtein(), 0.3, 0.9),
            prop_cls("city", comparators.QGram(), 0.3, 0.85),
            prop_cls("amount", comparators.Numeric(), 0.4, 0.7),
            prop_cls("code", comparators.WeightedLevenshtein(), 0.3, 0.8),
            prop_cls("tags", comparators.JaccardIndex(), 0.3, 0.8),
        ],
        data_sources=[],
    )


def _records(n, with_unicode=True, record_cls=Record):
    rng = random.Random(11)
    out = []
    for i in range(n):
        r = record_cls()
        r.add_value(ID_PROPERTY_NAME, f"r{i}")
        name = f"acme {rng.randint(0, 999)} corp {i % 77}"
        if with_unicode and i % 7 == 0:
            name += " \U0001D4B3å"
        if with_unicode and i % 13 == 0:
            name += " \ud800 Ł䅁"
        r.add_value("name", name)
        if i % 5:  # some records lack the property entirely
            r.add_value("city", rng.choice(["oslo", "bergen", "tromsø"]))
        r.add_value("amount", str(rng.randint(1, 10 ** 6)))
        r.add_value("code", f"AB-{rng.randint(0, 99999)}")
        r.add_value("tags", " ".join(rng.sample(["x", "y", "zz", "w"], 2)))
        if i % 11 == 0:  # multi-valued slot
            r.add_value("name", f"alias {i}")
        out.append(r)
    return out


@pytest.fixture(autouse=True)
def _force_two_workers(monkeypatch):
    monkeypatch.setenv("DEVICE_EXTRACT_WORKERS", "2")
    monkeypatch.setenv("DEVICE_EXTRACT_PARALLEL_MIN", "64")
    yield
    PX._shutdown()


def _assert_same(got, want, *, jax_bf16=False):
    assert set(got) == set(want)
    for prop in want:
        assert set(got[prop]) == set(want[prop]), prop
        for name, b in want[prop].items():
            a = got[prop][name]
            if jax_bf16 and prop == E.ANN_PROP and name == E.ANN_TENSOR:
                b = np.asarray(b).view(np.uint16)
            assert a.dtype == b.dtype, (prop, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{prop}.{name}")


def test_parallel_matches_serial_bit_exact():
    schema = _schema()
    plan = F.SchemaFeatures.plan(schema, values_per_record=2)
    enc = E.RecordEncoder(schema, 64)
    records = _records(700)

    before = dict(PX.STATS)
    par = PX.extract_batch_parallel(plan, records, encoder=enc)
    assert par is not None
    assert PX.STATS["slabs"] == before["slabs"] + 1
    assert PX.STATS["tasks"] == before["tasks"] + 2
    ser = F._extract_serial(plan, records)
    ser[E.ANN_PROP] = enc.corpus_tensors(records)
    _assert_same(par, ser)


def test_enabled_gating(monkeypatch):
    assert not PX.enabled(10)          # below the slab threshold
    assert PX.enabled(100000)
    # the pool is off by default, on any host
    monkeypatch.delenv("DEVICE_EXTRACT_WORKERS")
    assert PX.workers() == 0 and not PX.enabled(100000)
    monkeypatch.setenv("DEVICE_EXTRACT_WORKERS", "0")
    assert not PX.enabled(100000)


def test_extract_batch_routes_through_parallel(monkeypatch):
    """_extract_direct uses the pool above the threshold and extracts
    serially when the pool path reports failure."""
    monkeypatch.setenv("DUKE_FEATURE_CACHE_MB", "0")
    schema = _schema()
    plan = F.SchemaFeatures.plan(schema)
    records = _records(200, with_unicode=False)

    calls = {"n": 0}
    real = PX.extract_batch_parallel

    def spy(plan_, records_, *, encoder=None):
        calls["n"] += 1
        return real(plan_, records_, encoder=encoder)

    monkeypatch.setattr(PX, "extract_batch_parallel", spy)
    out = F.extract_batch(plan, records)
    assert calls["n"] == 1 and "name" in out

    monkeypatch.setattr(PX, "extract_batch_parallel",
                        lambda plan_, records_, encoder=None: None)
    out2 = F.extract_batch(plan, records)  # the serial retry
    _assert_same(out2, out)


def test_broken_pool_retries_serially_and_counts(monkeypatch):
    """A worker that dies mid-task breaks the pool: the slab is extracted
    serially, counted, and the next slab gets a fresh pool."""
    monkeypatch.setenv("DUKE_FEATURE_CACHE_MB", "0")
    schema = _schema()
    plan = F.SchemaFeatures.plan(schema)
    records = _records(130, with_unicode=False)
    want = F._extract_serial(plan, records)

    monkeypatch.setattr(PX, "_worker_extract", _die)
    before = PX.STATS["serial_retries"]
    assert F.extract_batch(plan, records).keys() == want.keys()
    assert PX.STATS["serial_retries"] == before + 1
    monkeypatch.undo()
    monkeypatch.setenv("DEVICE_EXTRACT_WORKERS", "2")
    monkeypatch.setenv("DEVICE_EXTRACT_PARALLEL_MIN", "64")
    _assert_same(PX.extract_batch_parallel(plan, records), want)


def test_worker_error_propagates_without_a_serial_retry(monkeypatch):
    """Only a broken pool is retried serially: an exception a worker
    raises reaches the caller, and no retry is counted."""
    monkeypatch.setenv("DUKE_FEATURE_CACHE_MB", "0")
    plan = F.SchemaFeatures.plan(_schema())
    records = _records(130, with_unicode=False)
    monkeypatch.setattr(PX, "_worker_extract", _raise)
    before = PX.STATS["serial_retries"]
    with pytest.raises(ValueError, match="worker fault"):
        F.extract_batch(plan, records)
    assert PX.STATS["serial_retries"] == before


def _die(task):
    import os

    os._exit(3)


def _raise(task):
    raise ValueError("worker fault")


def test_parallel_bit_identical_to_jax_serial():
    """The port's pool (C++ hashing, q-grams and embeddings in its workers)
    against the JAX package's serial extraction of the same records (C++
    on its side too)."""
    assert JE._native_embed() is not None
    tschema = _schema()
    jschema = _schema(JC, JSchema, JProperty)
    tplan = F.SchemaFeatures.plan(tschema, values_per_record=2)
    jplan = JF.SchemaFeatures.plan(jschema, values_per_record=2)
    trecs = _records(500)
    jrecs = _records(500, record_cls=JRecord)

    got = PX.extract_batch_parallel(tplan, trecs,
                                    encoder=E.RecordEncoder(tschema, 64))
    want = JF._extract_serial(jplan, jrecs)
    want[JE.ANN_PROP] = JE.RecordEncoder(jschema, 64).corpus_tensors(jrecs)
    _assert_same(got, want, jax_bf16=True)
