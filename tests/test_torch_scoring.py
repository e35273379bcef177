"""The port's brute-force corpus scorer against the JAX package's.

One corpus -- the bench stresstest generator's records, indexed by the JAX
``DeviceIndex`` and handed to the port through ``DeviceCorpus.from_numpy``
-- is scored by both ``build_corpus_scorer``s at DEVICE_CHUNK=64, top_k 16.
Stresstest names come from small pools, so exactly equal logits are
common: ``top_index`` and ``count_above`` must be exactly equal (tie order
included), ``top_logit`` within the reference's ``certified_f32_margin``.
The plan-level bounds in ``ops/bounds.py`` must equal the JAX values on a
plan covering every feature kind.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sesam_duke_microservice_tpu.core import comparators as JC
from sesam_duke_microservice_tpu.core.config import DukeSchema as JSchema
from sesam_duke_microservice_tpu.core.records import (
    GROUP_NO_PROPERTY_NAME,
    ID_PROPERTY_NAME,
    Property as JProperty,
)
from sesam_duke_microservice_tpu.engine.device_matcher import (
    DeviceIndex as JDeviceIndex,
)
from sesam_duke_microservice_tpu.ops import features as JF
from sesam_duke_microservice_tpu.ops import scoring as JS
from sesam_duke_microservice_tpu_torch.core import comparators as TC
from sesam_duke_microservice_tpu_torch.core.config import DukeSchema as TSchema
from sesam_duke_microservice_tpu_torch.core.records import (
    Property as TProperty,
)
from sesam_duke_microservice_tpu_torch.engine.device_matcher import (
    DeviceCorpus,
)
from sesam_duke_microservice_tpu_torch.ops import bounds as TB
from sesam_duke_microservice_tpu_torch.ops import features as TF
from sesam_duke_microservice_tpu_torch.ops import scoring as TS

CHUNK = 64
TOP_K = 16


def _stresstest_records(n, seed):
    # bench.py sets DEVICE_* defaults at import; keep them out of this
    # process's environment
    with mock.patch.dict(os.environ):
        import bench
    return bench.stresstest_records(n, seed=seed)


def _bench_props(C, Property):
    numeric = C.Numeric()
    numeric.min_ratio = 0.7
    return [
        Property(ID_PROPERTY_NAME, id_property=True),
        Property("name", C.Levenshtein(), 0.3, 0.88),
        Property("area", numeric, 0.45, 0.65),
        Property("ssn", C.Exact(), 0.3, 0.95),
    ]


def _schemas(group_filtering: bool):
    extra = ([GROUP_NO_PROPERTY_NAME] if group_filtering else [])
    out = []
    for C, Property, Schema in ((JC, JProperty, JSchema),
                                (TC, TProperty, TSchema)):
        props = _bench_props(C, Property)
        props += [Property(name, ignore=True) for name in extra]
        out.append(Schema(threshold=0.9, maybe_threshold=0.7,
                          properties=props, data_sources=[]))
    return out


def _jax_corpus(schema, group_filtering: bool):
    records = _stresstest_records(320, seed=77)
    rng = np.random.default_rng(3)
    for r in records:
        if group_filtering:
            r.add_value(GROUP_NO_PROPERTY_NAME, str(int(rng.integers(1, 3))))
        if rng.random() < 0.3:  # exact duplicates of an earlier name: ties
            r._values["name"] = list(records[int(rng.integers(8))]
                                     ._values["name"])
    index = JDeviceIndex(schema)
    for r in records:
        index.index(r)
    index.commit()
    for row in (5, 17, 200):  # tombstones
        index.corpus.tombstone(row)
    return index


def _port_plan(tschema, jplan):
    plan = TF.SchemaFeatures.plan(tschema)
    for spec, jspec in zip(plan.device_props, jplan.device_props):
        assert spec.name == jspec.name
        spec.values_per_record = jspec.values_per_record
        spec.max_chars = jspec.chars
    return plan


@pytest.mark.parametrize("group_filtering,from_rows", [
    (False, True), (True, True), (False, False)])
def test_corpus_scorer_equals_jax(group_filtering, from_rows):
    jschema, tschema = _schemas(group_filtering)
    jindex = _jax_corpus(jschema, group_filtering)
    jplan = jindex.plan
    corpus = jindex.corpus
    tplan = _port_plan(tschema, jplan)
    tcorpus = DeviceCorpus.from_numpy(
        tplan, corpus.feats, corpus.row_valid, corpus.row_deleted,
        corpus.row_group, "cpu")
    assert tcorpus.capacity == corpus.capacity

    nq = 48
    rows = np.arange(nq, dtype=np.int32) * 6
    query_row = rows if from_rows else np.full((nq,), -1, np.int32)
    query_group = (corpus.row_group[rows].astype(np.int32)
                   if group_filtering else np.full((nq,), -2, np.int32))
    qfeats_np = {
        prop: {name: arr[rows] for name, arr in t.items()}
        for prop, t in corpus.feats.items()
    }
    min_logit = JS.emit_bound_logit(jschema, jplan, 1e-3)
    assert min_logit == TB.emit_bound_logit(tschema, tplan, 1e-3)

    jscore = JS.build_corpus_scorer(
        jplan, chunk=CHUNK, top_k=TOP_K, group_filtering=group_filtering,
        queries_from_rows=from_rows)
    jf, jv, jd, jg = corpus.device_arrays()
    jq = ({} if from_rows else
          {p: {n: jnp.asarray(a) for n, a in t.items()}
           for p, t in qfeats_np.items()})
    want = [np.asarray(x) for x in jscore(
        jq, jf, jv, jd, jg, jnp.asarray(query_group), jnp.asarray(query_row),
        jnp.float32(min_logit))]

    tscore = TS.build_corpus_scorer(
        tplan, chunk=CHUNK, top_k=TOP_K, group_filtering=group_filtering,
        queries_from_rows=from_rows)
    tf_, tv, td, tg = tcorpus.device_arrays()
    tq = ({} if from_rows else
          {p: {n: torch.from_numpy(a.astype(np.int32) if a.dtype == np.uint16
                                   else a) for n, a in t.items()}
           for p, t in qfeats_np.items()})
    got = [x.numpy() for x in tscore(
        tq, tf_, tv, td, tg, torch.from_numpy(query_group),
        torch.from_numpy(query_row), torch.tensor(np.float32(min_logit)))]

    top_logit, top_index, count = got
    np.testing.assert_array_equal(top_index, want[1])
    np.testing.assert_array_equal(count, want[2])
    margin = JS.certified_f32_margin(jplan)
    np.testing.assert_allclose(top_logit, want[0], rtol=0, atol=margin)
    # the corpus really carries exact ties inside the kept top-K
    kept = top_logit[top_logit > JS.NEG_INF]
    assert len(np.unique(kept)) < len(kept)


def _every_kind_props(C, Property, *, geo: bool):
    props = [
        Property(ID_PROPERTY_NAME, id_property=True),
        Property("lev", C.Levenshtein(), 0.2, 0.9),
        Property("wlev", C.WeightedLevenshtein(), 0.3, 0.8),
        Property("qgram", C.QGram(), 0.25, 0.85),
        Property("tokens", C.JaccardIndex(), 0.1, 0.7),
        Property("exact", C.Exact(), 0.05, 0.99),
        Property("sound", C.Soundex(), 0.4, 0.6),
        Property("num", C.Numeric(), 0.45, 0.65),
        Property("person", C.PersonName(), 0.3, 0.97),   # host-only
    ]
    if geo:
        props.append(Property("geo", C.Geoposition(), 0.2, 0.75))
    return props


@pytest.mark.parametrize("geo", [False, True])
@pytest.mark.parametrize("maybe", [None, 0.6])
def test_bounds_equal_jax_on_every_kind(geo, maybe):
    jschema = JSchema(threshold=0.85, maybe_threshold=maybe,
                      properties=_every_kind_props(JC, JProperty, geo=geo),
                      data_sources=[])
    tschema = TSchema(threshold=0.85, maybe_threshold=maybe,
                      properties=_every_kind_props(TC, TProperty, geo=geo),
                      data_sources=[])
    jplan = JF.SchemaFeatures.plan(jschema)
    tplan = TF.SchemaFeatures.plan(tschema)
    assert ({s.kind for s in tplan.device_props}
            == set(JF.ALL_KINDS) - (set() if geo else {JF.GEO}))
    assert len(tplan.host_props) == len(jplan.host_props) == 1
    for p in (0.0, 1e-12, 0.3, 0.5, 0.97, 1.0):
        assert TB.probability_to_logit(p) == JS.probability_to_logit(p)
    assert (TB.host_bound_logit(tplan.host_props)
            == JS.host_bound_logit(jplan.host_props))
    assert TB.certified_f32_margin(tplan) == JS.certified_f32_margin(jplan)
    assert (TB.emit_bound_logit(tschema, tplan, 1e-3)
            == JS.emit_bound_logit(jschema, jplan, 1e-3))
    assert (TB.decisive_prune_logit(tschema, tplan)
            == JS.decisive_prune_logit(jschema, jplan))
    assert TB.NEG_INF == JS.NEG_INF and TB._EPS == JS._EPS


def test_unsupported_kind_raises_naming_the_comparator():
    from sesam_duke_microservice_tpu_torch.core.records import SchemaError

    tschema = TSchema(threshold=0.85, maybe_threshold=None,
                      properties=_every_kind_props(TC, TProperty, geo=True),
                      data_sources=[])
    with pytest.raises(SchemaError, match="WeightedLevenshtein"):
        TS.check_plan(TF.SchemaFeatures.plan(tschema))
    jw = TSchema(threshold=0.85, maybe_threshold=None, data_sources=[],
                 properties=[TProperty(ID_PROPERTY_NAME, id_property=True),
                             TProperty("n", TC.JaroWinkler(), 0.2, 0.9)])
    with pytest.raises(SchemaError, match="JaroWinkler"):
        TS.build_pair_logits(TF.SchemaFeatures.plan(jw))
