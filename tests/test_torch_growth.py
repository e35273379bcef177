"""The port's plan-growth paths held against the JAX package, bit for bit.

Differential counterparts of the growth tests in
``tests/test_device_matcher.py``: value-slot growth (explicit, automatic,
in a later batch, on the query side only), a host-only comparator beside
device ones, re-indexing an id, capacity doubling, per-property char-width
growth, long-text demotion and the sole device property that keeps its
place.  Each runs the JAX ``device`` backend and the port's on the same
records and compares the ordered event tapes, the link rows, the plans and
the corpus host mirrors.  Each runs with both feature caches off
(``DUKE_FEATURE_CACHE_MB=0``, the port's default) and on at the JAX
package's default budget, since the cache's plan fingerprint must follow
every one of these paths.
"""

import random

import numpy as np
import pytest

from sesam_duke_microservice_tpu.core import comparators as JC
from sesam_duke_microservice_tpu.core import config as JCFG
from sesam_duke_microservice_tpu.core import records as JR
from sesam_duke_microservice_tpu.engine import device_matcher as JDM
from sesam_duke_microservice_tpu.engine import listeners as JL
from sesam_duke_microservice_tpu.links import InMemoryLinkDatabase as JLinks
from sesam_duke_microservice_tpu.ops import feature_cache as JFC
from sesam_duke_microservice_tpu.ops import features as JF
from sesam_duke_microservice_tpu_torch.core import comparators as TC
from sesam_duke_microservice_tpu_torch.core import config as TCFG
from sesam_duke_microservice_tpu_torch.core import records as TR
from sesam_duke_microservice_tpu_torch.engine import device_matcher as TDM
from sesam_duke_microservice_tpu_torch.engine import listeners as TL
from sesam_duke_microservice_tpu_torch.links import (
    InMemoryLinkDatabase as TLinks,
)
from sesam_duke_microservice_tpu_torch.ops import feature_cache as TFC
from sesam_duke_microservice_tpu_torch.ops import features as TF
from torch_jax_cache import jax_cache_off  # noqa: F401


class Pkg:
    """One package's classes, so a test builds the same objects in both."""

    def __init__(self, name, C, CFG, R, DM, L, Links, FC, F):
        self.name, self.C, self.CFG, self.R = name, C, CFG, R
        self.DM, self.L, self.Links, self.FC, self.F = DM, L, Links, FC, F

    def index(self, schema, **kwargs):
        if self.name == "jax":
            return self.DM.DeviceIndex(
                schema, tunables=self.CFG.MatchTunables(), **kwargs)
        return self.DM.DeviceIndex(schema, device="cpu")

    def record(self, rid, group=None, **props):
        r = self.R.Record()
        r.add_value(self.R.ID_PROPERTY_NAME, rid)
        if group is not None:
            r.add_value(self.R.GROUP_NO_PROPERTY_NAME, str(group))
        for k, v in props.items():
            for one in (v if isinstance(v, list) else [v]):
                r.add_value(k, one)
        return r

    def schema(self, props, threshold=0.8, maybe=None):
        """``props``: (name, comparator class name or object, low, high)."""
        out = [self.R.Property(self.R.ID_PROPERTY_NAME, id_property=True)]
        for name, comp, low, high in props:
            if isinstance(comp, str):
                comp = getattr(self.C, comp)()
                if isinstance(comp, self.C.Numeric):
                    comp.min_ratio = 0.5
            out.append(self.R.Property(name, comp, low, high))
        return self.CFG.DukeSchema(threshold=threshold,
                                   maybe_threshold=maybe, properties=out,
                                   data_sources=[])


JAX = Pkg("jax", JC, JCFG, JR, JDM, JL, JLinks, JFC, JF)
PORT = Pkg("port", TC, TCFG, TR, TDM, TL, TLinks, TFC, TF)
BOTH = (JAX, PORT)

DEDUP = [("name", "Levenshtein", 0.3, 0.9), ("city", "Exact", 0.4, 0.8),
         ("amount", "Numeric", 0.4, 0.7)]
LONG = [("name", "Levenshtein", 0.3, 0.9), ("desc", "Levenshtein", 0.35, 0.8),
        ("ssn", "Exact", 0.4, 0.85)]


class Tape:
    """Ordered listener events, confidences as exact floats."""

    def __init__(self):
        self.events = []

    def batch_ready(self, size):
        self.events.append(("batch_ready", size))

    def matches(self, r1, r2, confidence):
        self.events.append(("match", r1.record_id, r2.record_id,
                            confidence.hex()))

    def matches_perhaps(self, r1, r2, confidence):
        self.events.append(("maybe", r1.record_id, r2.record_id,
                            confidence.hex()))

    def no_match_for(self, record):
        self.events.append(("none", record.record_id))

    def batch_done(self):
        self.events.append(("batch_done",))


class Run:
    """One package's backend with a tape and a link database."""

    def __init__(self, pkg, schema, *, index=None, proc=None, **index_kw):
        self.pkg = pkg
        self.index = index or pkg.index(schema, **index_kw)
        self.proc = proc or pkg.DM.DeviceProcessor(schema, self.index)
        self.tape = Tape()
        self.links = pkg.Links()
        self.proc.add_match_listener(self.tape)
        self.proc.add_match_listener(pkg.L.LinkMatchListener(self.links))

    def feed(self, batch):
        self.proc.deduplicate(batch)
        return self

    def probe(self, batch):
        """The http-transform shape: score without indexing."""
        self.index.set_indexing_disabled(True)
        try:
            self.proc.deduplicate(batch)
        finally:
            self.index.set_indexing_disabled(False)
        return self

    def rows(self):
        return sorted((l.id1, l.id2, l.status.value, l.kind.value,
                       l.confidence.hex())
                      for l in self.links.get_all_links())

    def plan(self):
        p = self.index.plan
        return ([(s.name, s.kind, s.v, s.chars) for s in p.device_props],
                [h.name for h in p.host_props])


def assert_same(jrun, trun, *, plans=True):
    assert trun.tape.events == jrun.tape.events
    assert trun.rows() == jrun.rows()
    if not plans:
        return
    assert trun.plan() == jrun.plan()
    jc, tc = jrun.index.corpus, trun.index.corpus
    assert (tc.size, tc.live_rows) == (jc.size, jc.live_rows)
    assert set(tc.feats) == set(jc.feats)
    for prop, tensors in jc.feats.items():
        assert set(tc.feats[prop]) == set(tensors), prop
        for name, arr in tensors.items():
            np.testing.assert_array_equal(tc.feats[prop][name][:jc.size],
                                          arr[:jc.size],
                                          err_msg=f"{prop}.{name}")


def run_both(schema_fn, batches_fn, **kwargs):
    """Build and feed both backends; returns (jax run, port run)."""
    runs = []
    for pkg in BOTH:
        run = Run(pkg, schema_fn(pkg), **kwargs)
        for batch in batches_fn(pkg):
            run.feed(batch)
        runs.append(run)
    return runs


@pytest.fixture(params=["0", "default"])
def cache_mb(request, monkeypatch):
    """Both packages' feature caches off, or both on at the JAX package's
    default budget (the port's default is off)."""
    if request.param == "0":
        monkeypatch.setenv("DUKE_FEATURE_CACHE_MB", "0")
    else:
        monkeypatch.setenv("DUKE_FEATURE_CACHE_MB", str(JFC.DEFAULT_MB))
    JFC.reset()
    TFC.reset()
    yield request.param
    JFC.reset()
    TFC.reset()


@pytest.fixture
def auto_chars(monkeypatch):
    """Char widths grow with the data (tests/conftest.py pins them); both
    feature modules were imported with this module, so they share the
    base width."""
    assert JF.MAX_CHARS == TF.MAX_CHARS
    monkeypatch.delenv("DEVICE_MAX_CHARS", raising=False)


# -- value slots ---------------------------------------------------------------


def test_multi_value_records(cache_mb):
    """JAX pinned at two value slots; the port sizes them from the data."""
    def batches(p):
        return [[p.record("a", name=["acme corp", "acme inc"], city="oslo",
                          amount="100"),
                 p.record("b", name="acme inc", city="oslo", amount="100"),
                 p.record("c", name="nothing alike", city="bergen",
                          amount="777")]]

    jrun = Run(JAX, JAX.schema(DEDUP), values_per_record=2)
    trun = Run(PORT, PORT.schema(DEDUP))
    for run in (jrun, trun):
        for batch in batches(run.pkg):
            run.feed(batch)
    # the plans differ by construction (JAX pins every property at two)
    assert_same(jrun, trun, plans=False)
    assert trun.plan()[0][0][2] == 2
    assert any(e[0] == "match" for e in trun.tape.events)


def test_multi_value_auto_grow(cache_mb):
    jrun, trun = run_both(lambda p: p.schema(DEDUP), lambda p: [[
        p.record("a", name=["zzz unrelated", "acme inc"], city="oslo",
                 amount="100"),
        p.record("b", name="acme inc", city="oslo", amount="100"),
        p.record("c", name="nothing alike", city="bergen", amount="777")]])
    assert_same(jrun, trun)
    assert trun.plan()[0][0][2] == 2


def test_multi_value_growth_rebuilds_existing_corpus(cache_mb):
    def batches(p):
        return [
            [p.record("a", name="acme inc", city="oslo", amount="100"),
             p.record("x", name="completely other", city="tromso",
                      amount="5")],
            [p.record("b", name=["zzz unrelated", "acme inc"], city="oslo",
                      amount="100")],
            [p.record("d", name=["q1", "q2", "acme inc"], city="oslo",
                      amount="100")],
        ]

    jrun, trun = run_both(lambda p: p.schema(DEDUP), batches)
    assert_same(jrun, trun)
    assert trun.index.corpus.size == 4
    assert trun.plan()[0][0][2] == 4


def test_multi_value_transform_query_widens_query_side_only(cache_mb):
    jrun, trun = run_both(lambda p: p.schema(DEDUP), lambda p: [[
        p.record("a", name="acme inc", city="oslo", amount="100"),
        p.record("x", name="other thing", city="tromso", amount="5")]])
    for run in (jrun, trun):
        run.probe([run.pkg.record("probe", name=["zzz unrelated", "acme inc"],
                                  city="oslo", amount="100")])
    assert_same(jrun, trun)
    assert ("match", "probe", "a") in {e[:3] for e in trun.tape.events}
    assert all(s[2] == 1 for s in trun.plan()[0])


# -- mixed plans, re-indexing, capacity ----------------------------------------


class Weird:
    """A comparator with no device kernel: host-scored."""

    def compare(self, v1, v2):
        return 1.0 if v1[::-1] == v2 else 0.0


def test_host_only_comparator_hybrid(cache_mb):
    def schema(p):
        return p.schema([("name", "Levenshtein", 0.3, 0.9),
                         ("code", Weird(), 0.2, 0.8)], threshold=0.75)

    jrun, trun = run_both(schema, lambda p: [[
        p.record("a", name="acme corp", code="abc"),
        p.record("b", name="acme corp", code="cba"),
        p.record("c", name="acme corp", code="xyz"),
        p.record("d", name="other thing", code="zyx")]])
    assert_same(jrun, trun)
    assert trun.plan()[1] == ["code"]


def test_reindex_same_id_replaces(cache_mb):
    jrun, trun = run_both(lambda p: p.schema(DEDUP), lambda p: [
        [p.record("a", name="acme corp", city="oslo", amount="100"),
         p.record("b", name="acme corp", city="oslo", amount="100")],
        [p.record("a", name="zzzz totally different", city="tromso",
                  amount="9999")]])
    assert_same(jrun, trun)
    assert trun.index.corpus.row_valid.sum() == 2
    assert trun.tape.events[-2] == ("none", "a")


def test_capacity_doubles_and_preserves(cache_mb):
    # distinct cities and amounts keep the survivors few (the JAX test's
    # identical ones make every pair a survivor: ~30 s a side here)
    def batches(p):
        return [[p.record(f"n{i}", name=f"name {i}", city=f"c{i % 37}",
                          amount=str(1 + 7919 * i))
                 for i in range(start, start + 100)]
                for start in range(0, 300, 100)]

    jrun, trun = run_both(lambda p: p.schema(DEDUP), batches)
    assert_same(jrun, trun)
    assert trun.index.corpus.capacity == jrun.index.corpus.capacity >= 300
    assert trun.index.corpus.row_valid[:300].all()
    assert any(e[0] == "match" for e in trun.tape.events)


# -- char widths and long text -------------------------------------------------


def _long_records(p, long_a, long_b, prefix="d__"):
    return [p.record(f"{prefix}1", name="kari nordmann", desc=long_a,
                     ssn="111"),
            p.record(f"{prefix}2", name="kari nordmann", desc=long_a,
                     ssn="111"),
            p.record(f"{prefix}3", name="ola hansen", desc=long_b, ssn="222"),
            p.record(f"{prefix}4", name="ola hansen", desc=long_b, ssn="222"),
            p.record(f"{prefix}5", name="per olsen",
                     desc="a genuinely mid length description", ssn="333")]


def test_per_property_char_width_growth(cache_mb, auto_chars):
    base = ("the quick brown fox jumps over the lazy dog again and "
            "again while the band plays on " * 2)
    variant = base[:-40] + "completely different ending here lately"
    jrun, trun = run_both(lambda p: p.schema(LONG, threshold=0.75),
                          lambda p: [_long_records(p, base, variant)])
    assert_same(jrun, trun)
    widths = {s[0]: s[3] for s in trun.plan()[0]}
    assert widths["desc"] >= len(variant) and widths["name"] < 100


def test_long_text_property_demotes_to_host_path(cache_mb, auto_chars):
    long_a = "an extremely long descriptive paragraph " * 30
    long_b = long_a[:-60] + "with a genuinely different conclusion drawn"
    jrun, trun = run_both(lambda p: p.schema(LONG, threshold=0.75),
                          lambda p: [
                              _long_records(p, "short", "short too", "s__"),
                              _long_records(p, long_a, long_b)])
    assert_same(jrun, trun)
    assert trun.plan()[1] == ["desc"]
    assert all(s[3] <= 64 for s in trun.plan()[0])


def test_sole_device_property_keeps_device_and_rebuilds(cache_mb,
                                                        auto_chars):
    long_text = "a very long body of text " * 40

    def batches(p):
        return [[p.record("k__1", text="short one"),
                 p.record("k__2", text="short two")],
                [p.record("k__3", text=long_text),
                 p.record("k__4", text=long_text)],
                [p.record("k__5", text="another short")]]

    jrun, trun = run_both(
        lambda p: p.schema([("text", "Levenshtein", 0.3, 0.9)],
                           threshold=0.75), batches)
    assert_same(jrun, trun)
    assert trun.plan()[1] == [] and trun.plan()[0][0][3] >= 512
    assert trun.index.corpus.size == 5


def test_fingerprint_follows_every_growth_path(auto_chars, monkeypatch):
    """With the cache on, each plan change above gives a new fingerprint,
    and a resync after it hits under the new one."""
    monkeypatch.setenv("DUKE_FEATURE_CACHE_MB", str(JFC.DEFAULT_MB))
    TFC.reset()
    cache = TFC.active()
    run = Run(PORT, PORT.schema(LONG, threshold=0.75))
    seen = [TFC.plan_fingerprint(run.index.plan)]
    steps = [
        [PORT.record("m1", name=["a b", "c d"], desc="x", ssn="1")],  # slots
        [PORT.record("w1", name="n", desc="y" * 100, ssn="2")],       # chars
        [PORT.record("l1", name="n", desc="z" * 400, ssn="3")],       # demote
    ]
    for batch in steps:
        run.feed(batch)
        seen.append(TFC.plan_fingerprint(run.index.plan))
    assert len(set(seen)) == len(seen)
    hits = cache.hits
    run.feed([PORT.record("m1", name=["a b", "c d"], desc="x", ssn="1")])
    assert cache.hits == hits + 1
    TFC.reset()
