"""The port held to the hand-derived goldens, independent of either
package's engine.

``tests/goldens/comparator_goldens.json`` holds 36 cases derived longhand
from Duke 1.2's published semantics (textbook Levenshtein DP, the classic
Winkler examples, q-gram set overlap, NumericComparator's ratio cut,
PropertyImpl's quadratic map, the naive-Bayes odds product; see
tests/test_goldens.py).  Here they run on the port:

  * every case on the port's host comparators (``core/comparators.py``)
    and the Bayes map and fold (``core/records.py``, ``core/bayes.py``),
    with the C++ host library on and off, at ``abs=1e-12`` (the fold at
    ``1e-9``, as the JAX package's test holds it);
  * the Levenshtein, Jaro-Winkler, q-gram, Dice and Jaccard cases also
    through the port's device scoring path on the CPU: features from
    ``ops/features.py``, the kernel wrappers of ``ops/cuda_kernels.py``
    (their plain versions on CPU tensors) and the similarity maps of
    ``ops/scoring.py``'s ``_property_sim``.  Edit distances equal the
    textbook DP and intersection counts the Python set intersection;
    both equal the JAX package's Pallas kernels (interpret mode) on the
    JAX package's features, exactly.  Similarities match the goldens,
    and the JAX package's device path on the same pairs, within
    ``ops.bounds.certified_f32_margin`` of a one-property plan at the
    demo config's NAME weights (0.09 / 0.93).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sesam_duke_microservice_tpu.core import comparators as JC
from sesam_duke_microservice_tpu.ops import features as JF
from sesam_duke_microservice_tpu.ops import pallas_kernels as pk
from sesam_duke_microservice_tpu.ops import scoring as JS
from sesam_duke_microservice_tpu_torch import native
from sesam_duke_microservice_tpu_torch.core import comparators as C
from sesam_duke_microservice_tpu_torch.core.bayes import combine_probabilities
from sesam_duke_microservice_tpu_torch.core.records import Property
from sesam_duke_microservice_tpu_torch.ops import bounds as B
from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
from sesam_duke_microservice_tpu_torch.ops import features as TF
from sesam_duke_microservice_tpu_torch.ops import scoring as TS

import torch_longhand as LH
from torch_threads import torch_threads_per_worker  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "comparator_goldens.json")
with open(GOLDENS) as _f:
    CASES = json.load(_f)

HOST_TOL = 1e-12
BAYES_TOL = 1e-9
LOW, HIGH = 0.09, 0.93  # the demo config's NAME weights


def _numeric():
    cmp = C.Numeric()
    cmp.min_ratio = 0.7
    return cmp


HOST_GROUPS = {
    "levenshtein": C.Levenshtein,
    "jaro_winkler": C.JaroWinkler,
    "qgram_overlap": C.QGram,
    "numeric_min_ratio_0_7": _numeric,
    "dice_tokens": C.DiceCoefficient,
    "jaccard_tokens": C.JaccardIndex,
    "weighted_levenshtein": C.WeightedLevenshtein,
    "jaro_winkler_tokenized": C.JaroWinklerTokenized,
    "soundex": C.Soundex,
    "person_name": C.PersonName,
}


def _resolve_again():
    native.reset()
    C._NATIVE = C._UNRESOLVED


@pytest.fixture(params=["native", "python"])
def host_paths(request, monkeypatch):
    """The C++ host library on (the default), or the pure-Python bodies
    (``DUKE_TPU_NATIVE=0``)."""
    if request.param == "python":
        monkeypatch.setenv("DUKE_TPU_NATIVE", "0")
    else:
        monkeypatch.delenv("DUKE_TPU_NATIVE", raising=False)
    _resolve_again()
    assert (C._native_module() is None) == (request.param == "python")
    yield request.param
    monkeypatch.delenv("DUKE_TPU_NATIVE", raising=False)
    _resolve_again()


def test_every_golden_group_is_covered():
    groups = set(CASES) - {"_comment"}
    assert groups == set(HOST_GROUPS) | {"bayes_demo_weights"}
    assert sum(len(CASES[g]) for g in groups) == 36


@pytest.mark.parametrize("group", sorted(HOST_GROUPS))
def test_host_comparator_goldens(group, host_paths):
    cmp = HOST_GROUPS[group]()
    for case in CASES[group]:
        got = cmp.compare(case["v1"], case["v2"])
        assert got == pytest.approx(case["expected"], abs=HOST_TOL), case


class _FixedSim:
    is_tokenized = False

    def __init__(self, sim):
        self.sim = sim

    def compare(self, v1, v2):
        return self.sim


def test_bayes_combination_goldens(host_paths):
    """Probability map + naive-Bayes fold under the demo-config weights
    (NAME .09/.93, AREA .04/.73, CAPITAL .12/.61)."""
    weights = {"NAME": (0.09, 0.93), "AREA": (0.04, 0.73),
               "CAPITAL": (0.12, 0.61)}
    for case in CASES["bayes_demo_weights"]:
        probs = []
        for name, sim in case["sims"].items():
            low, high = weights[name]
            prop = Property(name, C.Exact(), low, high)
            prop.comparator = _FixedSim(sim)
            probs.append(prop.compare_probability("a", "b"))
        assert probs == pytest.approx(case["probs"], abs=HOST_TOL), case
        got = combine_probabilities(probs)
        assert got == pytest.approx(case["expected"], abs=BAYES_TOL), case
        # the longhand fold of the example-flow oracle agrees
        assert LH.bayes(probs) == pytest.approx(case["expected"],
                                                abs=BAYES_TOL)


# -- the device scoring path on the CPU ----------------------------------------

DEVICE_GROUPS = {
    "levenshtein": "Levenshtein",
    "jaro_winkler": "JaroWinkler",
    "qgram_overlap": "QGram",
    "dice_tokens": "DiceCoefficient",
    "jaccard_tokens": "JaccardIndex",
}


def _spec(F, comparators, name):
    cmp = getattr(comparators, name)()
    # 16 units hold every golden string and keep the Pallas interpret
    # runs of the JAX side short
    return F.PropertyFeatureSpec(name="p", kind=F.feature_kind(cmp), low=LOW,
                                 high=HIGH, comparator=cmp, max_chars=16)


def _port_feats(spec, values):
    out = TF.extract_property(spec, [[v] for v in values])
    return {k: torch.from_numpy(a.astype(np.int32) if a.dtype == np.uint16
                                else a) for k, a in out.items()}


def _jax_feats(spec, values):
    return JF.extract_property(spec, [[v] for v in values])


def _i32(*arrays):
    return [jnp.asarray(np.asarray(a).astype(np.int32)) for a in arrays]


def _bigrams(v):
    return {v[i:i + 2] for i in range(len(v) - 1)}


@pytest.mark.parametrize("group", sorted(DEVICE_GROUPS))
def test_device_path_goldens(group):
    name = DEVICE_GROUPS[group]
    cases = CASES[group]
    v1 = [c["v1"] for c in cases]
    v2 = [c["v2"] for c in cases]
    want = np.array([c["expected"] for c in cases])
    n = len(cases)
    spec = _spec(TF, C, name)
    jspec = _spec(JF, JC, name)
    margin = B.certified_f32_margin(TF.SchemaFeatures(device_props=[spec]))
    qf, cf = _port_feats(spec, v1), _port_feats(spec, v2)
    jqf, jcf = _jax_feats(jspec, v1), _jax_feats(jspec, v2)
    for k in jqf:
        np.testing.assert_array_equal(qf[k].numpy(), jqf[k], err_msg=k)
        np.testing.assert_array_equal(cf[k].numpy(), jcf[k], err_msg=k)

    # the kernels' integer outputs, as (Q, C) tiles: every query against
    # every golden text, equal to the JAX kernel's and to the longhand
    if spec.kind == TF.CHARS:
        args = (qf["chars"][:, 0].contiguous(), qf["length"][:, 0],
                cf["chars"][:, 0].contiguous(), cf["length"][:, 0])
        jargs = _i32(jqf["chars"][:, 0], jqf["length"][:, 0],
                     jcf["chars"][:, 0], jcf["length"][:, 0])
        if name == "Levenshtein":
            dist = ck.myers_distance_tiles(*args).numpy()
            np.testing.assert_array_equal(
                dist, np.asarray(pk.myers_distance_tiles(*jargs,
                                                         interpret=True)))
            assert [int(dist[i, i]) for i in range(n)] == [
                LH.lev_distance(a, b) for a, b in zip(v1, v2)]
        else:
            equal = torch.zeros((n, n), dtype=torch.bool)
            sim = ck.jaro_winkler_sim_tiles(*args, equal).numpy()
            jsim = np.asarray(pk.jaro_winkler_sim_tiles(
                *jargs, jnp.zeros((n, n), bool), interpret=True))
            np.testing.assert_allclose(sim, jsim, rtol=0, atol=margin)
            np.testing.assert_allclose(np.diag(sim), want, rtol=0,
                                       atol=margin)
    else:
        ids = "grams" if spec.kind == TF.GRAM_SET else "tokens"
        count = "gram_count" if spec.kind == TF.GRAM_SET else "token_count"
        common = ck.set_intersection_tiles(
            qf[ids][:, 0].contiguous(), qf[count][:, 0],
            cf[ids][:, 0].contiguous(), cf[count][:, 0]).numpy()
        np.testing.assert_array_equal(common, np.asarray(
            pk.set_intersection_tiles(*_i32(jqf[ids][:, 0], jqf[count][:, 0],
                                            jcf[ids][:, 0], jcf[count][:, 0]),
                                      interpret=True)))
        split = _bigrams if spec.kind == TF.GRAM_SET else str.split
        assert [int(common[i, i]) for i in range(n)] == [
            len(set(split(a)) & set(split(b))) for a, b in zip(v1, v2)]

    # the similarity the scorer folds: the goldens within the margin, and
    # the JAX package's device path on the same pairs
    sim, _ = TS._property_sim(spec, qf, cf)
    sim = sim.numpy().reshape(n, n)
    jqt = {k: jnp.asarray(a) for k, a in jqf.items()}
    jct = {k: jnp.asarray(a) for k, a in jcf.items()}
    jsim, _ = JS._property_sim(jspec, jqt, jct)
    np.testing.assert_allclose(sim, np.asarray(jsim).reshape(n, n), rtol=0,
                               atol=margin)
    np.testing.assert_allclose(np.diag(sim), want, rtol=0, atol=margin)
    assert 0 < margin < 1e-3
