"""The port's double-double core and dd rescorer against the JAX package's.

  * the error-free transforms and dd ops against the Python-f64 oracle
    (the JAX package's tests/test_dd.py core tests, on the port);
  * the port's ops against the JAX ``ops/dd.py`` on the same inputs: bit
    for bit against JAX run op by op, within ``DD_EPS`` against JAX
    compiled by XLA, whose CPU backend rounds ``mul`` (and ``log``, which
    multiplies) into another low word in some lanes;
  * the dd rescorer: per certified comparator kind against the host f64
    oracle within ``certified_dd_margin``, the whole program against the
    JAX rescorer on one corpus carried across with
    ``DeviceCorpus.from_numpy`` (logits within the margin, ``unsafe``
    equal), the Jaro-Winkler boundary guard and the truncation flags.
"""

import math
import random
import string
import zlib
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sesam_duke_microservice_tpu.core import comparators as JC
from sesam_duke_microservice_tpu.core.config import DukeSchema as JSchema
from sesam_duke_microservice_tpu.core.records import (
    ID_PROPERTY_NAME,
    Property as JProperty,
    Record as JRecord,
)
from sesam_duke_microservice_tpu.ops import dd as JD
from sesam_duke_microservice_tpu.ops import features as JF
from sesam_duke_microservice_tpu.ops import scoring as JS
from sesam_duke_microservice_tpu_torch.core import comparators as TC
from sesam_duke_microservice_tpu_torch.core.bayes import probability_logit
from sesam_duke_microservice_tpu_torch.core.config import DukeSchema as TSchema
from sesam_duke_microservice_tpu_torch.core.records import (
    Property as TProperty,
    Record as TRecord,
)
from sesam_duke_microservice_tpu_torch.engine.device_matcher import (
    DeviceCorpus,
)
from sesam_duke_microservice_tpu_torch.ops import bounds as TB
from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
from sesam_duke_microservice_tpu_torch.ops import dd as TD
from sesam_duke_microservice_tpu_torch.ops import features as TF
from sesam_duke_microservice_tpu_torch.ops import scoring as TS


def _split(values):
    a = np.asarray(values, dtype=np.float64)
    hi = np.float32(a)
    lo = np.float32(a - hi.astype(np.float64))
    return hi, lo


def _t(pair):
    return tuple(torch.from_numpy(np.asarray(x)) for x in pair)


def _j(pair):
    return tuple(jnp.asarray(x) for x in pair)


def _operands(seed=11, n=2048):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1e4, 1e4, n)
    b = rng.uniform(0.1, 1e4, n) * rng.choice([-1.0, 1.0], n)
    return _split(a), _split(b)


def _logs(seed=7, n=2048):
    rng = np.random.default_rng(seed)
    return _split(10.0 ** rng.uniform(-10, 10, n))


# -- the arithmetic core against the f64 oracle --------------------------------


class TestDdCore:
    def test_add_mul_div_match_f64(self):
        ad, bd = _operands()
        ra, rb = TD.to_f64(_t(ad)), TD.to_f64(_t(bd))
        for op, want in ((TD.add, ra + rb), (TD.sub, ra - rb),
                         (TD.mul, ra * rb), (TD.div, ra / rb)):
            got = TD.to_f64(op(_t(ad), _t(bd)))
            rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
            assert rel.max() < TD.DD_EPS / 4, op

    def test_sub_keeps_the_low_word(self):
        got = TD.to_f64(TD.sub(_t(_split([1.0])), _t(_split([0.1]))))
        assert abs(got[0] - 0.9) < 1e-13  # a bare f32 would be ~2e-8 off

    def test_log_error_bound(self):
        xd = _t(_logs())
        got = TD.to_f64(TD.log(xd))
        want = np.log(TD.to_f64(xd))
        bound = TD.LOG_ERR_ABS + TD.DD_EPS * np.abs(want)
        assert (np.abs(got - want) < bound / 4).all()

    def test_from_int_exact(self):
        hi, lo = TD.from_int(torch.arange(0, 4096, dtype=torch.int32))
        assert (hi.numpy() == np.arange(4096, dtype=np.float32)).all()
        assert (lo.numpy() == 0.0).all()

    def test_const_pair_reproduces_f64(self):
        for x in (0.9, 0.7, 1e-10, math.log(2.0), 0.3333333333333333):
            hi, lo = TD.const_pair(x)
            assert abs((hi + lo) - x) <= abs(x) * 2.0 ** -47
            assert (hi, lo) == tuple(float(v) for v in JD.const_pair(x))

    def test_budgets_are_the_jax_packages(self):
        assert TD.DD_EPS == JD.DD_EPS and TD.LOG_ERR_ABS == JD.LOG_ERR_ABS


# -- bit for bit against the JAX package's dd ops ------------------------------

_BINARY = ("two_sum", "two_prod", "add", "sub", "mul", "div", "maximum",
           "minimum")
_UNARY = ("split", "log", "neg")


@pytest.mark.parametrize("op", _BINARY + _UNARY)
def test_op_bit_identical_to_jax_op_by_op(op):
    """JAX run op by op rounds every float32 operation on its own, as the
    port's eager operators do: equal (hi, lo) in every lane."""
    ad, bd = _operands(seed=len(op))
    if op in _BINARY:
        if op in ("two_sum", "two_prod"):
            args_j, args_t = (jnp.asarray(ad[0]), jnp.asarray(bd[0])), \
                (torch.from_numpy(ad[0]), torch.from_numpy(bd[0]))
        else:
            args_j, args_t = (_j(ad), _j(bd)), (_t(ad), _t(bd))
    elif op == "split":
        args_j, args_t = (jnp.asarray(ad[0]),), (torch.from_numpy(ad[0]),)
    elif op == "log":
        xd = _logs(seed=3)
        args_j, args_t = (_j(xd),), (_t(xd),)
    else:
        args_j, args_t = (_j(ad),), (_t(ad),)
    want = getattr(JD, op)(*args_j)
    got = getattr(TD, op)(*args_t)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_comparisons_and_clamp_equal_jax():
    ad, bd = _operands(seed=5)
    for op in ("lt", "le", "ge"):
        np.testing.assert_array_equal(
            getattr(TD, op)(_t(ad), _t(bd)).numpy(),
            np.asarray(getattr(JD, op)(_j(ad), _j(bd))))
    lo, hi = _split(np.full(ad[0].shape, -10.0)), _split(np.full(ad[0].shape,
                                                                  10.0))
    for w, g in zip(JD.clamp(_j(ad), _j(lo), _j(hi)),
                    TD.clamp(_t(ad), _t(lo), _t(hi))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_xla_compiled_mul_and_log_differ_only_within_budget():
    """The JAX package's rescorer is compiled: XLA's CPU backend gives
    add / sub / div the port's bits, but ``mul`` and ``log`` another low
    word in some lanes.  Both sides stay within ``DD_EPS`` of the exact
    product, so the port's rescorer agrees with the JAX one within the
    certified margin, not bit for bit (ROADMAP.md, Queue 3)."""
    ad, bd = _operands(seed=11, n=512)
    for op in ("add", "sub", "div"):
        want = jax.jit(getattr(JD, op))(_j(ad), _j(bd))
        got = getattr(TD, op)(_t(ad), _t(bd))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jax.jit(JD.mul)(_j(ad), _j(bd))
    got = TD.mul(_t(ad), _t(bd))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for i in range(len(ad[0])):
        exact = ((Fraction(float(ad[0][i])) + Fraction(float(ad[1][i])))
                 * (Fraction(float(bd[0][i])) + Fraction(float(bd[1][i]))))
        for pair in (got, want):
            value = Fraction(float(pair[0][i])) + Fraction(float(pair[1][i]))
            assert abs(float((value - exact) / exact)) < TD.DD_EPS


# -- the dd rescorer ------------------------------------------------------------

NOISE = "abcdefgh "
WORDS = ["acme corp", "acme corporation", "globex", "globex inc",
         "initech", "umbrella", "umbrela", "stark industries",
         "stark ind", "wayne enterprises"]
PHON = ["smith", "smyth", "johnson", "jonson", "garshol", "garshoel"]


def _noisy(rng, base):
    if base and rng.random() < 0.7:
        pos = rng.randrange(len(base))
        base = base[:pos] + rng.choice(NOISE) + base[pos + 1:]
    return base


def _qgram(C, formula):
    qg = C.QGram()
    qg.formula = formula
    return qg


def _kind_cases(C):
    return [
        ("levenshtein", C.Levenshtein(), WORDS),
        ("jaro_winkler", C.JaroWinkler(), WORDS),
        ("qgram_overlap", _qgram(C, "overlap"), WORDS),
        ("qgram_jaccard", _qgram(C, "jaccard"), WORDS),
        ("qgram_dice", _qgram(C, "dice"), WORDS),
        ("jaccard_tokens", C.JaccardIndex(), WORDS),
        ("dice_tokens", C.DiceCoefficient(), WORDS),
        ("exact", C.Exact(), WORDS),
        ("different", C.Different(), WORDS),
        ("soundex", C.Soundex(), PHON),
        ("metaphone", C.Metaphone(), PHON),
    ]


KIND_NAMES = [name for name, _, _ in _kind_cases(TC)]


def _rescore(fn, feats, top, qrows=None):
    """Run a port rescorer over numpy features on the CPU."""
    cfeats = {p: {k: torch.from_numpy(v.astype(np.int32)
                                      if v.dtype == np.uint16 else v)
                  for k, v in t.items()} for p, t in feats.items()}
    n = top.shape[0]
    qrows = np.arange(n, dtype=np.int32) if qrows is None else qrows
    hi, lo, unsafe = fn({}, cfeats, torch.from_numpy(qrows),
                        torch.from_numpy(top))
    return (hi.numpy().astype(np.float64) + lo.numpy().astype(np.float64),
            unsafe.numpy())


@pytest.mark.parametrize("name", KIND_NAMES)
def test_dd_logit_within_margin_of_oracle(name):
    """Near-threshold pairs of one certified kind, two value slots: the
    port's dd logit within ``certified_dd_margin`` of the host f64
    oracle's logit for every pair not flagged unsafe."""
    (cmp, pool), = [(c, p) for n, c, p in _kind_cases(TC) if n == name]
    schema = TSchema(threshold=0.8, maybe_threshold=0.6, data_sources=[],
                     properties=[TProperty(ID_PROPERTY_NAME, id_property=True),
                                 TProperty("p", cmp, 0.32, 0.91)])
    plan = TF.SchemaFeatures.plan(schema, values_per_record=2)
    (spec,) = plan.device_props
    assert TB.dd_certifiable_spec(spec)
    rng = random.Random(zlib.crc32(name.encode()))
    recs = []
    for i in range(24):
        r = TRecord()
        r.add_value(ID_PROPERTY_NAME, f"r{i}")
        r.add_value("p", _noisy(rng, rng.choice(pool)))
        if rng.random() < 0.5:
            r.add_value("p", _noisy(rng, rng.choice(pool)))
        recs.append(r)
    top = np.array([[rng.randrange(24) for _ in range(6)] for _ in range(24)],
                   np.int32)
    fn = TS.build_dd_rescorer(plan, queries_from_rows=True, value_slots_cap=8)
    ddlog, unsafe = _rescore(fn, TF.extract_batch(plan, recs), top)
    prop = schema.comparison_properties()[0]
    margin = TB.certified_dd_margin(plan)
    checked = 0
    for qi in range(24):
        for kk in range(6):
            if unsafe[qi, kk]:
                continue
            best = max(prop.compare_probability(v1, v2)
                       for v1 in recs[qi].get_values("p")
                       for v2 in recs[top[qi, kk]].get_values("p"))
            assert abs(ddlog[qi, kk] - probability_logit(best)) <= margin
            checked += 1
    assert checked > 24  # unsafe flags must not eat the fixture


def _mixed_props(C, Property):
    return [
        Property(ID_PROPERTY_NAME, id_property=True),
        Property("lev", C.Levenshtein(), 0.3, 0.9),
        Property("jw", C.JaroWinkler(), 0.32, 0.91),
        Property("qg", _qgram(C, "jaccard"), 0.3, 0.85),
        Property("tok", C.DiceCoefficient(), 0.4, 0.7),
        Property("ex", C.Exact(), 0.3, 0.95),
        Property("ph", C.Metaphone(), 0.4, 0.8),
        Property("num", C.Numeric(), 0.45, 0.65),   # host fallback
    ]


def test_rescorer_equals_jax_on_every_dd_kind():
    """One corpus of every certified kind, extracted by the JAX package and
    carried across with ``DeviceCorpus.from_numpy``: the two rescorers'
    logits agree within the certified margin (XLA's compiled ``mul``
    rounds some low words differently; see above) and ``unsafe`` is
    equal."""
    jschema = JSchema(threshold=0.8, maybe_threshold=0.6, data_sources=[],
                      properties=_mixed_props(JC, JProperty))
    tschema = TSchema(threshold=0.8, maybe_threshold=0.6, data_sources=[],
                      properties=_mixed_props(TC, TProperty))
    jplan = JF.SchemaFeatures.plan(jschema, values_per_record=2)
    tplan = TF.SchemaFeatures.plan(tschema, values_per_record=2)
    rng = random.Random(8)
    pools = {"lev": WORDS, "jw": WORDS, "qg": WORDS, "tok": WORDS,
             "ex": WORDS, "ph": PHON, "num": ["1", "2", "3"]}
    recs = []
    for i in range(20):
        r = JRecord()
        r.add_value(ID_PROPERTY_NAME, f"r{i}")
        for prop, pool in pools.items():
            r.add_value(prop, _noisy(rng, rng.choice(pool)))
            if rng.random() < 0.3:
                r.add_value(prop, _noisy(rng, rng.choice(pool)))
        recs.append(r)
    recs[1]._values["jw"] = ["abme corp"]      # the JW boundary pair
    recs[2]._values["jw"] = ["gl bex"]
    feats = JF.extract_batch(jplan, recs)
    n = len(recs)
    corpus = DeviceCorpus.from_numpy(
        tplan, feats, np.ones(n, bool), np.zeros(n, bool),
        np.full(n, -1, np.int32), "cpu")
    tfeats, _, _, _ = corpus.device_arrays()
    top = np.array([[rng.randrange(n) for _ in range(5)] for _ in range(n)],
                   np.int32)
    top[1, 0] = 2
    top[-1, -1] = -1                           # padding lane
    qrows = np.arange(n, dtype=np.int32)
    specs = JS.dd_plan_specs(jplan)
    assert [s.name for s in specs] == [s.name for s in TB.dd_plan_specs(tplan)]
    jfn = JS.dd_rescorer(jplan, queries_from_rows=True, value_slots_cap=8)
    jhi, jlo, junsafe = jfn(
        {}, {s.name: {k: jnp.asarray(v) for k, v in feats[s.name].items()}
             for s in specs},
        jnp.asarray(qrows), jnp.asarray(top))
    tfn = TS.dd_rescorer(tplan, queries_from_rows=True, value_slots_cap=8)
    thi, tlo, tunsafe = tfn({}, {s.name: tfeats[s.name] for s in specs},
                            torch.from_numpy(qrows), torch.from_numpy(top))
    want = np.asarray(jhi).astype(np.float64) + np.asarray(jlo)
    got = thi.numpy().astype(np.float64) + tlo.numpy()
    np.testing.assert_array_equal(tunsafe.numpy(), np.asarray(junsafe))
    assert tunsafe.numpy()[1, 0]
    margin = JS.certified_dd_margin(jplan)
    assert margin == TB.certified_dd_margin(tplan)
    np.testing.assert_allclose(got, want, rtol=0, atol=margin)
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))


def test_dd_bounds_equal_jax():
    for maybe in (None, 0.6):
        jschema = JSchema(threshold=0.85, maybe_threshold=maybe,
                          data_sources=[],
                          properties=_mixed_props(JC, JProperty))
        tschema = TSchema(threshold=0.85, maybe_threshold=maybe,
                          data_sources=[],
                          properties=_mixed_props(TC, TProperty)
                          + [TProperty("who", TC.PersonName(), 0.2, 0.8)])
        jschema.properties.append(JProperty("who", JC.PersonName(), 0.2, 0.8))
        jplan = JF.SchemaFeatures.plan(jschema)
        tplan = TF.SchemaFeatures.plan(tschema)
        for fn in ("dd_reject_bound", "dd_gate_bound", "dd_event_bound"):
            assert getattr(TB, fn)(tschema, tplan) == \
                getattr(JS, fn)(jschema, jplan), fn
        assert TB.certified_dd_margin(tplan) == JS.certified_dd_margin(jplan)
        assert ([p.name for p in TB.dd_fallback_props(tschema, tplan)]
                == [p.name for p in JS.dd_fallback_props(jschema, jplan)]
                == ["num", "who"])
    assert set(TB.DD_KINDS) | set(TB.DD_FALLBACK_KINDS) == set(TF.ALL_KINDS)
    assert TB._DD_SIM_OPS == JS._DD_SIM_OPS
    assert TB._DD_JW_SIM_OPS == JS._DD_JW_SIM_OPS
    assert TS._DD_JW_BRANCH_GUARD == float(np.float32(JS._DD_JW_BRANCH_GUARD))


def _one_pair(plan, r1, r2, value_slots_cap=8):
    fn = TS.build_dd_rescorer(plan, queries_from_rows=True,
                              value_slots_cap=value_slots_cap)
    _, unsafe = _rescore(fn, TF.extract_batch(plan, [r1, r2]),
                         np.array([[1]], np.int32),
                         np.array([0], np.int32))
    return bool(unsafe[0, 0])


def _record(rid, **props):
    r = TRecord()
    r.add_value(ID_PROPERTY_NAME, rid)
    for k, v in props.items():
        r.add_value(k, v)
    return r


def _one_prop_plan(cmp, v=1):
    schema = TSchema(threshold=0.8, maybe_threshold=None, data_sources=[],
                     properties=[TProperty(ID_PROPERTY_NAME, id_property=True),
                                 TProperty("p", cmp, 0.3, 0.9)])
    return TF.SchemaFeatures.plan(schema, values_per_record=v)


class TestRescorerFlags:
    def test_jw_exact_boundary_pair_is_flagged_unsafe(self):
        """JW("abme corp", "gl bex") has j == 0.5 exactly; host f64 and dd
        may round it to opposite sides of the map split, so the pair must
        carry the branch-guard flag into the host residue."""
        cmp = TC.JaroWinkler()
        assert cmp.compare("abme corp", "gl bex") == 0.5
        plan = _one_prop_plan(cmp, v=2)
        r2 = _record("b", p="starkfind")
        r2.add_value("p", "gl bex")
        assert _one_pair(plan, _record("a", p="abme corp"), r2)
        assert not _one_pair(plan, _record("a", p="abme corp"),
                             _record("b", p="acme corp"))

    def test_value_slot_saturation_flags_pair(self):
        plan = _one_prop_plan(TC.Exact(), v=2)
        a = _record("a", p="x")
        assert not _one_pair(plan, a, _record("b", p="y"), value_slots_cap=2)
        full = _record("c")
        full.add_value("p", "x")
        full.add_value("p", "y")  # every slot valid at the cap
        assert _one_pair(plan, a, full, value_slots_cap=2)
        assert not _one_pair(plan, a, full, value_slots_cap=8)

    def test_char_width_saturation_flags_pair(self):
        plan = _one_prop_plan(TC.Levenshtein())
        width = plan.device_props[0].chars
        a = _record("a", p="x" * (width - 1))
        assert not _one_pair(plan, a, _record("b", p="y" * 4))
        assert _one_pair(plan, a, _record("c", p="z" * (width + 10)))

    def test_gram_capacity_saturation_flags_pair(self):
        plan = _one_prop_plan(_qgram(TC, "jaccard"))
        a = _record("a", p="abcd")
        assert not _one_pair(plan, a, _record("b", p="abce"))
        long = _record("c", p="".join(ch + "x" for ch in string.ascii_letters))
        assert _one_pair(plan, a, long)


def test_gathered_kernel_branch_equals_flat_dd():
    """Single-slot Levenshtein of at most 32 chars takes its distance from
    the gathered Myers kernel's wrapper (its plain version on the CPU);
    the dd logits equal the flat path's, which two value slots force."""
    rng = random.Random(4)
    recs = [_record(f"r{i}", p=_noisy(rng, rng.choice(WORDS)))
            for i in range(12)]
    top = np.array([[rng.randrange(12) for _ in range(4)] for _ in range(12)],
                   np.int32)
    one = _one_prop_plan(TC.Levenshtein(), v=1)
    two = _one_prop_plan(TC.Levenshtein(), v=2)
    assert one.device_props[0].chars <= ck.GATHERED_MAX_CHARS
    ck.reset_launch_counts()
    tiled, _ = _rescore(TS.build_dd_rescorer(one), TF.extract_batch(one, recs),
                        top)
    flat, _ = _rescore(TS.build_dd_rescorer(two), TF.extract_batch(two, recs),
                       top)
    np.testing.assert_array_equal(tiled, flat)
    assert ck.LAUNCHES["myers_gathered"] == 0   # CPU tensors: plain version
