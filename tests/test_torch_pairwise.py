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
