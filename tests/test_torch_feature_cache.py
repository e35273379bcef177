"""The port's digest-keyed feature cache
(``sesam_duke_microservice_tpu_torch.ops.feature_cache``).

Counterparts of the tests in ``tests/test_feature_cache.py`` whose paths
the port has: the cache is invisible in every output (event tapes and link
rows equal with ``DUKE_FEATURE_CACHE_MB`` 0 and on, on the ``device`` and
``ann`` backends, a resync pass served from the cache included); a resync
hits every row; query-side extraction uses it; the plan fingerprint
invalidates on widening and ignores a threshold-only change; the byte
budget evicts LRU; a same-digest replacement leaks no bytes; a batch of
hits and misses assembles bit-identical tensors; records without ids
bypass it.  Across packages: the port with its cache on against the JAX
package with its cache on, feeds and tapes bit for bit.
"""

import random

import numpy as np
import pytest

from sesam_duke_microservice_tpu.store.records import (
    record_digest as jax_record_digest,
)
from sesam_duke_microservice_tpu_torch.core.records import (
    ID_PROPERTY_NAME,
    Record,
    record_digest,
)
from sesam_duke_microservice_tpu_torch.engine.ann_matcher import (
    AnnIndex,
    AnnProcessor,
)
from sesam_duke_microservice_tpu_torch.ops import feature_cache as FC
from sesam_duke_microservice_tpu_torch.ops import features as F
from test_torch_growth import DEDUP, JAX, PORT, Run, assert_same
from torch_jax_cache import jax_cache_off  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

NAMES = [
    "acme corp", "acme corporation", "globex", "globex inc", "initech",
    "initech llc", "umbrella", "umbrela", "stark industries", "stark ind",
]
CITIES = ["oslo", "bergen", "trondheim"]


def random_records(n, seed, prefix="r", pkg=PORT):
    """Deterministic content: the same arguments give FRESH records with
    identical ids and values -- the resync shape."""
    rng = random.Random(seed)
    records = []
    for i in range(n):
        base = rng.choice(NAMES)
        if rng.random() < 0.4:
            pos = rng.randrange(len(base))
            base = base[:pos] + rng.choice("abcdefgh") + base[pos + 1:]
        records.append(pkg.record(
            f"{prefix}{i}", name=base, city=rng.choice(CITIES),
            amount=str(rng.choice([100, 200, 200, 300, 1000]))))
    return records


def dedup_schema(pkg=PORT):
    return pkg.schema(DEDUP, threshold=0.8, maybe=0.6)


@pytest.fixture
def cache_env(monkeypatch):
    """Re-points the process cache at a budget; resets it afterwards."""

    def set_mb(mb):
        monkeypatch.setenv("DUKE_FEATURE_CACHE_MB", str(mb))
        FC.reset()
        return FC.active()

    yield set_mb
    FC.reset()


def _pipeline(kind, schema, batches, monkeypatch):
    """Run ``batches`` through a fresh backend: (tape, link rows, index)."""
    if kind == "ann":
        monkeypatch.setenv("DEVICE_ANN_DIM", "32")
        index = AnnIndex(schema, device="cpu")
        run = Run(PORT, schema, index=index,
                  proc=AnnProcessor(schema, index))
    else:
        run = Run(PORT, schema)
    for batch in batches:
        run.feed(batch)
    return run.tape.events, run.rows(), run.index


@pytest.mark.parametrize("kind", ["device", "ann"])
def test_cache_on_off_event_and_link_parity(kind, cache_env, monkeypatch):
    """Equal tapes and link rows with the cache off and on, including a
    resync pass that is served from the cache."""
    schema = dedup_schema()

    def batches():
        return [random_records(40, seed=7),
                random_records(12, seed=8, prefix="s"),
                random_records(40, seed=7)]  # resync: same ids and content

    cache_env(0)
    assert FC.active() is None
    events_off, links_off, _ = _pipeline(kind, schema, batches(),
                                         monkeypatch)
    cache = cache_env(64)
    events_on, links_on, _ = _pipeline(kind, schema, batches(), monkeypatch)
    assert events_on == events_off
    assert links_on == links_off
    assert cache.hits >= 40


def test_resync_hits_all_rows(cache_env):
    cache = cache_env(64)
    schema = dedup_schema()
    run = Run(PORT, schema)
    run.feed(random_records(30, seed=3))
    hits0, misses0 = cache.hits, cache.misses
    run.feed(random_records(30, seed=3))
    assert cache.hits - hits0 == 30
    assert cache.misses == misses0
    # re-upserts tombstone + append: the corpus holds both generations
    assert run.index.corpus.size == 60
    assert run.index.corpus.live_rows == 30


def test_query_probe_extraction_uses_cache(cache_env):
    """Query-side extraction (the http-transform shape) hits when the
    query plan matches the plan rows were cached under."""
    cache = cache_env(64)
    run = Run(PORT, dedup_schema())
    run.feed(random_records(20, seed=5))
    hits0 = cache.hits
    probes = random_records(20, seed=5)
    qplan = run.index._query_plan(probes)
    out = run.index._extract(probes, plan=qplan)
    assert cache.hits - hits0 == 20
    direct = F._extract_direct(qplan, probes)
    for prop, tensors in direct.items():
        for name, arr in tensors.items():
            np.testing.assert_array_equal(out[prop][name], arr)


def test_plan_fingerprint_invalidates_on_widening(cache_env):
    """Value-slot widening changes the fingerprint, so pre-widening rows
    never scatter into post-widening tensors, and the widened extraction
    is right."""
    cache = cache_env(64)
    run = Run(PORT, dedup_schema())
    run.feed(random_records(16, seed=11))
    fp_before = FC.plan_fingerprint(run.index.plan)

    hits0, misses0 = cache.hits, cache.misses
    run.feed([PORT.record("wide0", name=["acme corp", "acme corporation"],
                          city="oslo", amount="100")])
    fp_after = FC.plan_fingerprint(run.index.plan)
    assert fp_before != fp_after
    assert run.index.plan.device_props[0].values_per_record > 1
    assert cache.hits == hits0
    assert cache.misses - misses0 >= 17  # 16 rebuilt + the widening record

    hits1 = cache.hits
    fresh = random_records(16, seed=11)
    out = F.extract_batch(run.index.plan, fresh)
    assert cache.hits - hits1 == 16
    direct = F._extract_direct(run.index.plan, fresh)
    for prop, tensors in direct.items():
        for name, arr in tensors.items():
            np.testing.assert_array_equal(out[prop][name], arr)


def test_threshold_only_change_keeps_fingerprint():
    """low / high retunes shape scoring, not extraction: every field of
    the port's plan that shapes a tensor is in the fingerprint, and these
    two are not."""
    plan_a = F.SchemaFeatures.plan(dedup_schema())
    retuned = dedup_schema()
    for p in retuned.properties:
        if p.name == "name":
            p.low, p.high = 0.25, 0.95
    plan_b = F.SchemaFeatures.plan(retuned)
    assert FC.plan_fingerprint(plan_a) == FC.plan_fingerprint(plan_b)

    base = FC.plan_fingerprint(plan_a)
    spec = plan_a.device_props[0]
    for field, value in (("values_per_record", 2), ("max_chars", 64),
                         ("kind", F.CHARS_WEIGHTED),
                         ("comparator", PORT.C.JaroWinkler())):
        old = getattr(spec, field)
        setattr(spec, field, value)
        assert FC.plan_fingerprint(plan_a) != base, field
        setattr(spec, field, old)
    assert FC.plan_fingerprint(plan_a) == base


def _put(cache, fp, digests, nbytes):
    """Insert packed rows of ``nbytes`` each, one call for all of them."""
    feats = {"p": {"t": np.zeros((len(digests), max(1, nbytes // 8)),
                                 dtype=np.int64)}}
    rows = FC._pack(feats, np.arange(len(digests)))
    cache.put_packed(fp, FC._layout(feats), zip(digests, rows))


def test_fingerprint_separates_the_encoder_routes(cache_env, monkeypatch):
    """Rows embedded by the C++ encoder never serve the numpy route (they
    differ in the last f32 bit), nor the other way round."""
    from sesam_duke_microservice_tpu_torch.ops import embedding as E

    cache = cache_env(64)
    schema = dedup_schema()
    plan = F.SchemaFeatures.plan(schema)
    enc = E.RecordEncoder(schema, 32)
    assert E._native_embed() is not None
    native_fp = FC.plan_fingerprint(plan, enc)
    F.extract_batch(plan, random_records(8, seed=71), encoder=enc)
    monkeypatch.setattr(E, "_native_embed", lambda: None)
    assert FC.plan_fingerprint(plan, enc) != native_fp
    out = F.extract_batch(plan, random_records(8, seed=71), encoder=enc)
    assert (cache.hits, cache.misses) == (0, 16)
    direct = F._extract_direct(plan, random_records(8, seed=71), encoder=enc)
    np.testing.assert_array_equal(out[E.ANN_PROP]["emb"],
                                  direct[E.ANN_PROP]["emb"])


def test_byte_budget_eviction():
    budget = 10 * 1024
    cache = FC.FeatureCache(budget)
    row_bytes = 1024
    fp = ("fp",)
    for i in range(20):
        _put(cache, fp, [b"d%02d" % i], row_bytes)
    assert cache.bytes <= budget
    assert cache.evicted > 0
    assert len(cache) < 20
    # LRU: the oldest digests go first, the newest survive
    assert cache.get_many(fp, [b"d00"]) == {}
    assert 0 in cache.get_many(fp, [b"d19"])
    # a get refreshes recency
    survivors = [d for d in (b"d%02d" % i for i in range(20))
                 if cache.get_many(fp, [d])]
    victim = survivors[0]
    cache.get_many(fp, [victim])
    _put(cache, fp, [b"x%02d" % i for i in range(len(survivors) - 1)],
         row_bytes)
    assert 0 in cache.get_many(fp, [victim])
    # an over-budget single row is refused, not thrashed
    _put(cache, fp, [b"huge"], budget * 2)
    assert cache.get_many(fp, [b"huge"]) == {}


def test_replacing_same_digest_does_not_leak_bytes():
    cache = FC.FeatureCache(1 << 20)
    for _ in range(5):
        _put(cache, ("fp",), [b"dig"], 2048)
    assert len(cache) == 1
    assert cache.bytes < 2 * (2048 + 1024)


def test_cached_extract_mixed_hit_miss_bit_identical(cache_env):
    cache_env(64)
    plan = F.SchemaFeatures.plan(dedup_schema())
    F.extract_batch(plan, random_records(10, seed=41))  # populate
    mixed = (random_records(10, seed=41)
             + random_records(7, seed=42, prefix="m"))
    random.Random(4).shuffle(mixed)
    out = F.extract_batch(plan, mixed)
    direct = F._extract_direct(plan, mixed)
    assert set(out) == set(direct)
    for prop, tensors in direct.items():
        assert set(out[prop]) == set(tensors)
        for name, arr in tensors.items():
            np.testing.assert_array_equal(out[prop][name], arr)


def test_prewarm_seeds_rows_that_later_batches_hit():
    """``prewarm`` packs restored corpus rows under the plan's fingerprint:
    a later batch of the same records hits every row and assembles the
    tensors it was seeded from."""
    cache = FC.FeatureCache(1 << 20)
    plan = F.SchemaFeatures.plan(dedup_schema())
    records = random_records(10, seed=61)
    feats = F._extract_direct(plan, records)
    id_to_row = {r.record_id: i for i, r in enumerate(records)}
    digests = [(r.record_id, FC.record_key(r)) for r in records[::-1]]
    assert FC.prewarm(plan, None, feats, id_to_row,
                      digests + [("absent", b"x")], cache) == 10
    out = FC.cached_extract(cache, plan, random_records(10, seed=61))
    assert (cache.hits, cache.misses) == (10, 0)
    for prop, tensors in feats.items():
        for name, arr in tensors.items():
            np.testing.assert_array_equal(out[prop][name], arr)


def test_records_without_ids_bypass_cache(cache_env):
    cache = cache_env(64)
    plan = F.SchemaFeatures.plan(dedup_schema())
    r = Record()
    r.add_value("name", "acme corp")
    out = F.extract_batch(plan, [r])
    assert len(cache) == 0
    direct = F._extract_direct(plan, [r])
    for prop, tensors in direct.items():
        for name, arr in tensors.items():
            np.testing.assert_array_equal(out[prop][name], arr)


# -- across packages -----------------------------------------------------------


def test_cache_on_bit_identical_to_jax_cache_on(cache_env):
    """Both packages with their caches on, a resync pass included: the
    same tapes, link rows, plans and corpus mirrors."""
    from sesam_duke_microservice_tpu.ops import feature_cache as JFC

    cache = cache_env(64)
    JFC.reset()
    runs = []
    for pkg in (JAX, PORT):
        run = Run(pkg, dedup_schema(pkg))
        for batch in (random_records(40, 7, pkg=pkg),
                      random_records(12, 8, prefix="s", pkg=pkg),
                      random_records(40, 7, pkg=pkg)):
            run.feed(batch)
        runs.append(run)
    assert_same(*runs)
    assert cache.hits >= 40 and JFC.active().hits == cache.hits
    JFC.reset()


def test_record_digest_equals_jax_store_digest():
    """The cache's key: the port's record_digest is the JAX package's
    store digest byte for byte, on multi-value records and wide units."""
    from sesam_duke_microservice_tpu.core.records import Record as JRecord
    from wide_units import ALPHABETS

    wide = "".join(chr(u) for units in ALPHABETS.values() for u in units)
    rows = [
        {ID_PROPERTY_NAME: ["a"], "name": ["acme corp"]},
        {ID_PROPERTY_NAME: ["b"], "name": ["x", "y", "x"], "city": ["oslo"]},
        {ID_PROPERTY_NAME: ["w"], "name": [wide, "😀 \ud800", "\x00"],
         "note": ["\"quoted\" \\ slash", "tab\tnew\nline"]},
        {ID_PROPERTY_NAME: ["u\udc00"], "ñ": ["Ł䅁"]},
    ]
    for values in rows:
        mine, theirs = Record(values), JRecord(values)
        assert record_digest(mine) == jax_record_digest(theirs), values
        assert FC.record_key(mine) == record_digest(mine)


@pytest.mark.parametrize("int8", ["0", "1"])
def test_embedding_rows_round_trip_through_the_cache(int8, cache_env,
                                                     monkeypatch):
    """The ``ann`` tensors (bf16 bits, or int8 codes and their 1-D scale)
    come back from all-hit and part-hit batches exactly as extracted."""
    from sesam_duke_microservice_tpu_torch.ops import embedding as E

    monkeypatch.setenv("DUKE_EMB_INT8", int8)
    cache_env(64)
    schema = dedup_schema()
    plan = F.SchemaFeatures.plan(schema)
    enc = E.RecordEncoder(schema, 32)
    first = random_records(12, seed=51)
    F.extract_batch(plan, first, encoder=enc)
    for batch in (random_records(12, seed=51),
                  random_records(12, seed=51) + random_records(5, 52, "e")):
        out = F.extract_batch(plan, batch, encoder=enc)
        direct = F._extract_direct(plan, batch, encoder=enc)
        assert set(out[E.ANN_PROP]) == set(direct[E.ANN_PROP])
        for prop, tensors in direct.items():
            for name, arr in tensors.items():
                assert out[prop][name].shape == arr.shape, (prop, name)
                assert out[prop][name].dtype == arr.dtype, (prop, name)
                np.testing.assert_array_equal(out[prop][name], arr)
