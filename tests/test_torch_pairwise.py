"""The port's pairwise functions and host features against the JAX package.

Same seeded numpy inputs through both sides: integer distances must be
exactly equal, float32 similarities within the reference's own per-kind
similarity-error budget (``ops.scoring._SIM_ERROR_BOUND``), and the host
feature hashes bit-identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sesam_duke_microservice_tpu.core.records import Record as JRecord
from sesam_duke_microservice_tpu.ops import features as JF
from sesam_duke_microservice_tpu.ops import pairwise as jpw
from sesam_duke_microservice_tpu.ops import scoring as jax_scoring
from sesam_duke_microservice_tpu.core import comparators as JC
from sesam_duke_microservice_tpu.core.records import Property as JProperty
from sesam_duke_microservice_tpu_torch.core import comparators as TC
from sesam_duke_microservice_tpu_torch.core.records import (
    Property as TProperty,
    Record as TRecord,
)
from sesam_duke_microservice_tpu_torch.ops import features as TF
from sesam_duke_microservice_tpu_torch.ops import pairwise as tpw

CHARS_TOL = jax_scoring._SIM_ERROR_BOUND[JF.CHARS]
HASH_TOL = jax_scoring._SIM_ERROR_BOUND[JF.HASH]
NUMERIC_TOL = jax_scoring._SIM_ERROR_BOUND[JF.NUMERIC]


def _pairs(seed: int, p: int, l: int):
    rng = np.random.default_rng(seed)
    c1 = rng.integers(97, 101, size=(p, l)).astype(np.int32)
    c2 = rng.integers(97, 101, size=(p, l)).astype(np.int32)
    l1 = rng.integers(0, l + 1, size=p).astype(np.int32)
    l2 = rng.integers(0, l + 1, size=p).astype(np.int32)
    l1[:2] = [0, l]
    l2[:2] = [l, l]
    for chars, lens in ((c1, l1), (c2, l2)):
        for i, n in enumerate(lens):
            chars[i, n:] = 0
    equal = rng.random(p) < 0.1
    return c1, l1, c2, l2, equal


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("l", [1, 16, 32])
def test_myers_distance_equals_jax(l):
    c1, l1, c2, l2, _ = _pairs(l, 300, l)
    want = np.asarray(jpw.levenshtein_distance_myers(*_j(c1, l1, c2, l2)))
    got = tpw.levenshtein_distance_myers(*_t(c1, l1, c2, l2)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("l", [8, 40])
def test_scan_dp_distance_equals_jax(l):
    c1, l1, c2, l2, _ = _pairs(50 + l, 200, l)
    want = np.asarray(jpw.levenshtein_distance(*_j(c1, l1, c2, l2)))
    got = tpw.levenshtein_distance(*_t(c1, l1, c2, l2)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("l", [24, 48])
def test_levenshtein_sim_equals_jax(l):
    c1, l1, c2, l2, equal = _pairs(90 + l, 250, l)
    want = np.asarray(jpw.levenshtein_sim(*_j(c1, l1, c2, l2, equal)))
    got = tpw.levenshtein_sim(*_t(c1, l1, c2, l2, equal)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CHARS_TOL)


def test_hash_sims_equal_jax():
    equal = np.random.default_rng(3).random(64) < 0.5
    for jfn, tfn in ((jpw.exact_sim, tpw.exact_sim),
                     (jpw.different_sim, tpw.different_sim)):
        want = np.asarray(jfn(jnp.asarray(equal)))
        got = tfn(torch.from_numpy(equal)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=HASH_TOL)


@pytest.mark.parametrize("min_ratio", [0.0, 0.7])
def test_numeric_sim_equals_jax(min_ratio):
    rng = np.random.default_rng(int(min_ratio * 10))
    p = 400
    d1 = rng.integers(-5, 12, size=p).astype(np.float32)
    d2 = rng.integers(-5, 12, size=p).astype(np.float32)
    d1[::7] = rng.normal(size=d1[::7].shape).astype(np.float32) * 1e6
    v1 = rng.random(p) < 0.9
    v2 = rng.random(p) < 0.9
    want = np.asarray(jpw.numeric_sim(*_j(d1, v1, d2, v2),
                                      min_ratio=min_ratio))
    got = tpw.numeric_sim(*_t(d1, v1, d2, v2), min_ratio=min_ratio).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NUMERIC_TOL)


def _random_unicode(rng, n):
    pools = ["abcæøå", "ĀāĂă日本語", "\U0001F600\U0001F680", "𐏿"]
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 12))
        out.append("".join(
            rng.choice(list(pools[int(rng.integers(len(pools)))]))
            for _ in range(k)))
    return out


def test_fnv1a64_batch_equals_jax_on_unicode():
    values = _random_unicode(np.random.default_rng(5), 300)
    values += ["\ud83d", "x\udc00y", "", "a" * 5000]  # lone surrogates
    np.testing.assert_array_equal(TF.fnv1a64_batch(values),
                                  JF.fnv1a64_batch(values))


def test_extract_batch_equals_jax():
    """The copied host extraction gives the JAX package's tensors, value
    slots and UTF-16 char units included."""
    values = _random_unicode(np.random.default_rng(9), 40)

    def plan_and_records(mod_c, prop_cls, rec_cls, features):
        props = [prop_cls("name", mod_c.Levenshtein(), 0.3, 0.9),
                 prop_cls("code", mod_c.Exact(), 0.2, 0.8),
                 prop_cls("size", mod_c.Numeric(), 0.4, 0.7)]
        records = []
        for i, v in enumerate(values):
            r = rec_cls()
            r.add_value("name", v)
            r.add_value("name", v[::-1])
            r.add_value("code", str(i % 7))
            r.add_value("size", str(i * 1.5))
            records.append(r)
        plan = features.SchemaFeatures()
        for p in props:
            plan.device_props.append(features.PropertyFeatureSpec(
                name=p.name, kind=features.feature_kind(p.comparator),
                low=p.low, high=p.high, comparator=p.comparator,
                values_per_record=2, max_chars=16))
        return plan, records

    jplan, jrecs = plan_and_records(JC, JProperty, JRecord, JF)
    tplan, trecs = plan_and_records(TC, TProperty, TRecord, TF)
    want = JF._extract_serial(jplan, jrecs)
    got = TF.extract_batch(tplan, trecs)
    assert want.keys() == got.keys()
    for prop in want:
        assert want[prop].keys() == got[prop].keys()
        for name in want[prop]:
            np.testing.assert_array_equal(got[prop][name], want[prop][name])
            assert got[prop][name].dtype == want[prop][name].dtype


@pytest.mark.parametrize("l", [1, 16, 32, 48])
def test_jaro_counts_and_prefix_equal_jax(l):
    c1, l1, c2, l2, _ = _pairs(400 + l, 300, l)
    c2[5:40] = c1[5:40]                 # equal strings: full matches
    l2[5:40] = l1[5:40]
    want = [np.asarray(x) for x in jpw.jaro_counts(*_j(c1, l1, c2, l2))]
    got = [x.numpy() for x in tpw.jaro_counts(*_t(c1, l1, c2, l2))]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert l == 1 or want[1].max() > 0  # transpositions really occur
    for mp in (0, 4):
        np.testing.assert_array_equal(
            tpw.common_prefix_count(*_t(c1, c2, l1, l2), max_prefix=mp)
            .numpy(),
            np.asarray(jpw.common_prefix_count(*_j(c1, c2, l1, l2),
                                               max_prefix=mp)))


@pytest.mark.parametrize("l", [8, 32, 48])
def test_jaro_winkler_sim_equals_jax(l):
    c1, l1, c2, l2, equal = _pairs(500 + l, 300, l)
    c2[::3, :2] = c1[::3, :2]           # shared prefixes: the boost
    kw = dict(prefix_scale=0.1, boost_threshold=0.7, max_prefix=4)
    want = np.asarray(jpw.jaro_winkler_sim(*_j(c1, l1, c2, l2, equal), **kw))
    got = tpw.jaro_winkler_sim(*_t(c1, l1, c2, l2, equal), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CHARS_TOL)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0), (2.0, 1.0, 0.5)])
def test_weighted_levenshtein_sim_equals_jax(weights):
    c1, l1, c2, l2, equal = _pairs(600, 200, 20)
    rng = np.random.default_rng(6)
    k1 = rng.integers(0, 3, size=c1.shape).astype(np.int32)
    k2 = rng.integers(0, 3, size=c2.shape).astype(np.int32)
    kw = dict(digit_weight=weights[0], letter_weight=weights[1],
              other_weight=weights[2])
    want = np.asarray(jpw.weighted_levenshtein_sim(
        *_j(c1, k1, l1, c2, k2, l2, equal), **kw))
    got = tpw.weighted_levenshtein_sim(
        *_t(c1, k1, l1, c2, k2, l2, equal), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=jax_scoring._SIM_ERROR_BOUND[
                                   JF.CHARS_WEIGHTED])


@pytest.mark.parametrize("formula", ["overlap", "jaccard", "dice"])
def test_set_sims_equal_jax(formula):
    rng = np.random.default_rng(len(formula))
    p, g = 200, 12
    ids = np.full((2, p, g), JF.SET_PAD, dtype=np.int32)
    counts = rng.integers(0, g + 1, size=(2, p)).astype(np.int32)
    for side in range(2):
        for i in range(p):
            ids[side, i, :counts[side, i]] = np.sort(rng.choice(
                40, size=counts[side, i], replace=False))
    equal = rng.random(p) < 0.1
    args = (ids[0], counts[0], ids[1], counts[1])
    np.testing.assert_array_equal(
        tpw.set_intersection_count(*_t(*args)).numpy(),
        np.asarray(jpw.set_intersection_count(*_j(*args))))
    want = np.asarray(jpw.qgram_sim(*_j(*args, equal), formula=formula))
    got = tpw.qgram_sim(*_t(*args, equal), formula=formula).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CHARS_TOL)
    want = np.asarray(jpw.token_set_sim(*_j(*args, equal),
                                        dice=formula == "dice"))
    got = tpw.token_set_sim(*_t(*args, equal),
                            dice=formula == "dice").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CHARS_TOL)


def test_phonetic_sim_equals_jax():
    rng = np.random.default_rng(4)
    equal, code_eq, valid = (rng.random(300) < f for f in (0.1, 0.5, 0.8))
    want = np.asarray(jpw.phonetic_sim(*_j(equal, code_eq, valid)))
    got = tpw.phonetic_sim(*_t(equal, code_eq, valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=HASH_TOL)


@pytest.mark.parametrize("max_distance", [0.0, 5000.0])
def test_geoposition_sim_equals_jax(max_distance):
    """Geoposition is not certifiable (f32 lat/lon quantization, and the
    math libraries' sin/cos/asin differ), so the bar is the distance
    computed to about a meter on the 6,371 km radius."""
    rng = np.random.default_rng(8)
    p = 300
    lat1 = np.radians(rng.uniform(58, 60, p)).astype(np.float32)
    lon1 = np.radians(rng.uniform(9, 11, p)).astype(np.float32)
    lat2 = (lat1 + rng.normal(0, 2e-4, p)).astype(np.float32)
    lon2 = (lon1 + rng.normal(0, 2e-4, p)).astype(np.float32)
    lat2[:20], lon2[:20] = lat1[:20], lon1[:20]
    v1, v2 = rng.random(p) < 0.9, rng.random(p) < 0.9
    args = (lat1, lon1, v1, lat2, lon2, v2)
    want = np.asarray(jpw.geoposition_sim(*_j(*args),
                                          max_distance=max_distance))
    got = tpw.geoposition_sim(*_t(*args), max_distance=max_distance).numpy()
    atol = 2.0 / max_distance if max_distance else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
