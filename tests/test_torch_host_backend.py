"""The port's ``host`` backend (``index.inverted.InvertedIndex`` + the full
host ``Processor``) against the JAX package's, on the same configs and
inputs.

* the cases of tests/test_engine.py through both packages: dedup end to
  end, delete retraction, transform side-effect free, record-linkage group
  exclusion, index visibility and lookup, the ``max_search_hits`` cap,
  fuzzy expansion and fuzzy not diluting exact scores, and the one-to-one
  listener cases -- each case's results, ordered event tapes and link
  rows must be equal;
* ``analyze`` and ``_osa_distance`` on seeded random strings;
* ``find_candidate_matches`` lists, order included, on a seeded
  2,000-record corpus full of ties (exact-name repeats), fuzzy off and on;
* the HTTP differential: the JAX ``DukeApp(backend="host")`` and the
  port's serve the same POSTs (scheduler on in both), with equal feeds and
  tapes;
* a persistent restart by replay of the record store, whose feed equals
  the uninterrupted run's.
"""

import json
import random
import threading
import types

import numpy as np
import pytest

import sesam_duke_microservice_tpu.core.comparators as JC
import sesam_duke_microservice_tpu.core.config as JCFG
import sesam_duke_microservice_tpu.core.records as JR
import sesam_duke_microservice_tpu.engine.listeners as JL
import sesam_duke_microservice_tpu.engine.workload as JW
import sesam_duke_microservice_tpu.index.inverted as JI
import sesam_duke_microservice_tpu.links.memory as JM
import sesam_duke_microservice_tpu.service.app as JA
import sesam_duke_microservice_tpu.service.datasource as JD
import sesam_duke_microservice_tpu_torch.core.comparators as TC
import sesam_duke_microservice_tpu_torch.core.config as TCFG
import sesam_duke_microservice_tpu_torch.core.records as TR
import sesam_duke_microservice_tpu_torch.engine.listeners as TL
import sesam_duke_microservice_tpu_torch.engine.workload as TW
import sesam_duke_microservice_tpu_torch.index.inverted as TI
import sesam_duke_microservice_tpu_torch.links.memory as TM
import sesam_duke_microservice_tpu_torch.service.app as TA
import sesam_duke_microservice_tpu_torch.service.datasource as TD

from test_engine import DEDUP_XML, LINKAGE_XML
from test_torch_slice import _TS, _Tape, _feed, _post, _stresstest_entities
from torch_jax_cache import jax_cache_off  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

JAX = types.SimpleNamespace(C=JC, CFG=JCFG, R=JR, L=JL, W=JW, I=JI, M=JM,
                            A=JA, D=JD, name="jax")
PORT = types.SimpleNamespace(C=TC, CFG=TCFG, R=TR, L=TL, W=TW, I=TI, M=TM,
                             A=TA, D=TD, name="port")


def host_workload(pkg, xml, env, kind="deduplications", name="people"):
    sc = pkg.CFG.parse_config(xml, env=env)
    wl = pkg.W.build_workload(getattr(sc, kind)[name], sc, backend="host",
                              persistent=False)
    tape = _Tape()
    wl.processor.add_match_listener(tape)
    return wl, tape


def link_rows(wl):
    return [(l.id1, l.id2, l.status.value, l.kind.value, repr(l.confidence))
            for l in wl.link_database.get_changes_since(0)]


def feed_rows(rows):
    return [{k: v for k, v in r.items() if k != "_updated"} for r in rows]


# -- tests/test_engine.py, case for case ----------------------------------------


def case_dedup_end_to_end(wl):
    with wl.lock:
        wl.process_batch("crm", [
            {"_id": "1", "name": "John Smith", "email": "john@x.com"},
            {"_id": "2", "name": "Mary Jones", "email": "mary@x.com"},
        ])
        wl.process_batch("web", [
            {"_id": "9", "name": "Jon Smith", "email": "john@x.com"}])
        rows = wl.links_since(0)
        ts = rows[0]["_updated"]
        wl.process_batch("web", [
            {"_id": "9", "name": "Jon Smith", "email": "john@x.com"}])
        churn = wl.links_since(ts)
    assert len(rows) == 1 and rows[0]["_id"] == "crm__1_web__9"
    assert rows[0]["confidence"] > 0.8 and churn == []
    return feed_rows(rows)


def case_delete_retracts_links(wl):
    with wl.lock:
        wl.process_batch("crm", [
            {"_id": "1", "name": "John Smith", "email": "j@x.com"}])
        wl.process_batch("web", [
            {"_id": "9", "name": "John Smith", "email": "j@x.com"}])
        ts = wl.links_since(0)[0]["_updated"]
        wl.process_batch("web", [
            {"_id": "9", "_deleted": True, "name": "John Smith"}])
        retracted = wl.links_since(ts)
        wl.process_batch("crm", [
            {"_id": "2", "name": "John Smith", "email": "j@x.com"}])
        rows = wl.links_since(0)
    assert len(retracted) == 1 and retracted[0]["_deleted"] is True
    assert all("web__9" not in r["_id"] for r in rows
               if "crm__2" in r["_id"])
    return feed_rows(retracted), feed_rows(rows)


def case_transform_side_effect_free(wl):
    with wl.lock:
        wl.process_batch("crm", [
            {"_id": "1", "name": "John Smith", "email": "j@x.com"}])
        rows = wl.process_batch(
            "web", [{"_id": "9", "name": "John Smith", "email": "j@x.com"},
                    {"_id": "10", "name": "Zzz Yyy", "email": "z@y.com"}],
            http_transform=True)
        assert wl.links_since(0) == []
        assert wl.index.find_record_by_id("web__9") is None
    assert rows[0]["duke_links"][0]["confidence"] > 0.8
    assert rows[1]["duke_links"] == []
    return rows


def case_recordlinkage_group_exclusion(wl):
    with wl.lock:
        wl.process_batch("left", [{"_id": "a", "name": "Turing"},
                                  {"_id": "b", "name": "Turing"}])
        assert wl.links_since(0) == []
        wl.process_batch("right", [{"_id": "c", "name": "Turing"}])
        rows = wl.links_since(0)
    assert {r["_id"] for r in rows} == {"1__left__a_2__right__c",
                                        "1__left__b_2__right__c"}
    return feed_rows(rows)


def case_max_search_hits_caps_search(wl):
    with wl.lock:
        wl.process_batch("crm", [
            {"_id": str(i), "name": "John Smith", "email": f"{i}@x.com"}
            for i in range(8)])
        rows = wl.links_since(0)
    assert wl.processor.stats.candidates_retrieved <= 3 * 8
    return wl.processor.stats.candidates_retrieved, feed_rows(rows)


ENGINE_CASES = {
    "dedup_end_to_end": (case_dedup_end_to_end, DEDUP_XML,
                         {"MIN_RELEVANCE": "0.05"}, "deduplications"),
    "delete_retracts_links": (case_delete_retracts_links, DEDUP_XML,
                              {"MIN_RELEVANCE": "0.05"}, "deduplications"),
    "transform_side_effect_free": (case_transform_side_effect_free,
                                   DEDUP_XML, {"MIN_RELEVANCE": "0.05"},
                                   "deduplications"),
    "recordlinkage_group_exclusion": (case_recordlinkage_group_exclusion,
                                      LINKAGE_XML, {"MIN_RELEVANCE": "0.05"},
                                      "record_linkages"),
    "max_search_hits_caps_search": (case_max_search_hits_caps_search,
                                    DEDUP_XML, {"MAX_SEARCH_HITS": "3",
                                                "MIN_RELEVANCE": "0.0"},
                                    "deduplications"),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_case_bit_identical_to_jax(case):
    fn, xml, env, kind = ENGINE_CASES[case]
    out = []
    for pkg in (JAX, PORT):
        wl, tape = host_workload(pkg, xml, env, kind)
        try:
            out.append((fn(wl), tape.events, link_rows(wl),
                        wl.processor.stats.pairs_compared))
        finally:
            wl.close()
    assert out[1] == out[0]
    assert out[1][1], "the case must have emitted events"


def _schema(pkg):
    return pkg.CFG.DukeSchema(
        threshold=0.8, maybe_threshold=None,
        properties=[pkg.R.Property(pkg.R.ID_PROPERTY_NAME, id_property=True),
                    pkg.R.Property("NAME", pkg.C.Levenshtein(), 0.1, 0.9)],
        data_sources=[])


def _rec(pkg, rid, name):
    r = pkg.R.Record()
    r.add_value(pkg.R.ID_PROPERTY_NAME, rid)
    r.add_value("NAME", name)
    return r


def _index(pkg, fuzzy, min_relevance, docs):
    t = pkg.CFG.MatchTunables()
    t.min_relevance = min_relevance
    t.fuzzy_search = fuzzy
    idx = pkg.I.InvertedIndex(_schema(pkg), t)
    for rid, name in docs:
        idx.index(_rec(pkg, rid, name))
    idx.commit()
    return idx


def case_fuzzy_expands_tokens(pkg):
    def hits(fuzzy, name):
        idx = _index(pkg, fuzzy, 0.0, [("a", "kristiansen")])
        return [r.record_id for r in idx.find_candidate_matches(
            _rec(pkg, "q", name))]

    out = (hits(False, "kristianson"), hits(True, "kristianson"),
           hits(True, "kristol"))
    assert out == ([], ["a"], [])
    return out


def case_fuzzy_does_not_dilute_exact_scores(pkg):
    def hits(fuzzy):
        idx = _index(pkg, fuzzy, 0.1, [("exact", "kristiansen"),
                                       ("near", "kristianses")])
        return [r.record_id for r in idx.find_candidate_matches(
            _rec(pkg, "q", "kristiansen"))]

    base, with_fuzzy = hits(False), hits(True)
    assert "exact" in base and set(base) <= set(with_fuzzy)
    assert "near" in with_fuzzy
    return base, with_fuzzy


def case_visibility_and_lookup(pkg):
    sc = pkg.CFG.parse_config(DEDUP_XML, env={})
    idx = pkg.I.InvertedIndex(sc.deduplications["people"].duke)
    ds = pkg.D.IncrementalDataSource(
        sc.deduplications["people"].duke.data_sources[0])
    idx.index(ds.record_for_entity(
        {"_id": "1", "name": "Grace Hopper", "email": "g@h.com"}))
    before = idx.find_record_by_id("crm__1")
    idx.commit()
    first = idx.find_record_by_id("crm__1").get_value("NAME")
    idx.index(ds.record_for_entity(
        {"_id": "1", "name": "Grace B Hopper", "email": "g@h.com"}))
    idx.commit()
    out = (before, first, len(idx),
           idx.find_record_by_id("crm__1").get_value("NAME"))
    assert out == (None, "grace hopper", 1, "grace b hopper")
    return out


def _linked(pkg, linkdb):
    return sorted((l.id1, l.id2, l.status.value, repr(l.confidence))
                  for l in linkdb.get_changes_since(0))


def _one_to_one(pkg, resolver=False):
    recs = {rid: pkg.R.Record() for rid in ("a1", "a2", "b1", "b2", "q")}
    for rid, r in recs.items():
        r.add_value(pkg.R.ID_PROPERTY_NAME, rid)
        r.add_value(pkg.R.ORIGINAL_ENTITY_ID_PROPERTY_NAME, rid)
    linkdb = pkg.M.InMemoryLinkDatabase()
    lis = pkg.L.ServiceMatchListener(
        "t", linkdb, kind="recordlinkage", one_to_one=True,
        record_resolver=recs.get if resolver else None)
    return recs, linkdb, lis


def case_one_to_one_best_assignment(pkg):
    r, linkdb, lis = _one_to_one(pkg)
    lis.batch_ready(2)
    lis.matches(r["a1"], r["b1"], 0.9)
    lis.matches(r["a1"], r["b2"], 0.95)
    lis.matches(r["a2"], r["b2"], 0.8)
    lis.batch_done()
    return _linked(pkg, linkdb)


def case_one_to_one_cross_batch(pkg):
    r, linkdb, lis = _one_to_one(pkg)
    for pair, conf in (("a1", 0.9), ("a2", 0.95), ("a1", 0.9)):
        lis.batch_ready(1)
        lis.matches(r[pair], r["b1"], conf)
        lis.batch_done()
    return _linked(pkg, linkdb)


def case_one_to_one_displacement(pkg):
    r, linkdb, lis = _one_to_one(pkg, resolver=True)
    lis.batch_ready(1)
    lis.matches(r["a1"], r["b1"], 0.9)
    lis.matches(r["a1"], r["b2"], 0.85)
    lis.batch_done()
    lis.batch_ready(1)
    lis.matches(r["a2"], r["b1"], 0.95)
    lis.batch_done()
    return _linked(pkg, linkdb)


def case_one_to_one_transform_pairs(pkg):
    r, linkdb, lis = _one_to_one(pkg)
    lis.batch_ready(1)
    lis.matches(r["a1"], r["b1"], 0.9)
    lis.batch_done()
    lis.set_link_database_updates_disabled(True)
    lis.batch_ready(1)
    lis.matches(r["q"], r["b1"], 0.85)
    lis.batch_done()
    lis.set_link_database_updates_disabled(False)
    lis.batch_ready(1)
    lis.matches(r["a2"], r["b1"], 0.95)
    lis.batch_done()
    return _linked(pkg, linkdb)


def case_one_to_one_suppressed_no_match(pkg):
    r, linkdb, lis = _one_to_one(pkg)
    seen = []
    lis._wrapped.no_match_for = lambda rec: seen.append(rec.record_id)
    lis.batch_ready(2)
    lis.matches(r["a1"], r["b1"], 0.9)
    lis.matches(r["a2"], r["b1"], 0.8)
    lis.batch_done()
    assert seen == ["a2"]
    return seen, _linked(pkg, linkdb)


UNIT_CASES = {f.__name__[5:]: f for f in (
    case_fuzzy_expands_tokens, case_fuzzy_does_not_dilute_exact_scores,
    case_visibility_and_lookup, case_one_to_one_best_assignment,
    case_one_to_one_cross_batch, case_one_to_one_displacement,
    case_one_to_one_transform_pairs, case_one_to_one_suppressed_no_match)}


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_index_and_listener_case_equal_to_jax(case):
    fn = UNIT_CASES[case]
    assert fn(PORT) == fn(JAX)


# -- analysis, distances and candidate lists -------------------------------------

ALPHABET = "abcdeåø -_.,'!1é"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analyze_and_osa_distance_equal_to_jax(seed):
    rng = random.Random(seed)
    words = ["the", "and", "of", "Ole", "ÅSE", "kari", "42", "o'neil"]
    for _ in range(400):
        text = " ".join(rng.choice(words + ["".join(
            rng.choice(ALPHABET) for _ in range(rng.randint(0, 8)))])
            for _ in range(rng.randint(0, 5)))
        assert TI.analyze(text) == JI.analyze(text)
        a = "".join(rng.choice("abcab") for _ in range(rng.randint(0, 9)))
        b = "".join(rng.choice("abcab") for _ in range(rng.randint(0, 9)))
        for limit in (0, 1, 2, 3):
            assert TI._osa_distance(a, b, limit) == \
                JI._osa_distance(a, b, limit)


CORPUS_XML = """
<DukeMicroService>
  <Deduplication name="people" link-database-type="in-memory">
    <duke>
      <schema>
        <threshold>0.9</threshold>
        <property><name>NAME</name>
          <comparator>levenshtein</comparator><low>0.3</low><high>0.88</high>
        </property>
        <property lookup="required"><name>CITY</name>
          <comparator>exact</comparator><low>0.4</low><high>0.6</high>
        </property>
        <property lookup="false"><name>SSN</name>
          <comparator>exact</comparator><low>0.3</low><high>0.95</high>
        </property>
      </schema>
      <data-source class="io.sesam.dukemicroservice.IncrementalDeduplicationDataSource">
        <param name="dataset-id" value="crm"/>
        <column name="name" property="NAME"/>
        <column name="city" property="CITY"/>
        <column name="ssn" property="SSN"/>
      </data-source>
    </duke>
  </Deduplication>
</DukeMicroService>
"""


def _corpus_entities(n, seed):
    rng = np.random.default_rng(seed)
    first = ["ole", "kari", "per", "anne", "nils", "ingrid", "lars", "berit"]
    last = ["hansen", "johansen", "olsen", "larsen", "nilsen", "karlsen"]
    cities = ["oslo", "bergen", "tromso"]
    out = []
    for i in range(n):
        name = (f"{first[rng.integers(len(first))]} "
                f"{last[rng.integers(len(last))]}")
        if rng.random() < 0.2:  # a typo: fuzzy expansion has work
            pos = int(rng.integers(len(name)))
            name = name[:pos] + "abcdefghij"[rng.integers(10)] + \
                name[pos + 1:]
        out.append({"_id": f"e{i}", "name": name,
                    "city": cities[rng.integers(len(cities))],
                    "ssn": str(int(rng.integers(1, 50)))})
    return out


@pytest.mark.parametrize("fuzzy", ["false", "true"])
def test_find_candidate_matches_equal_in_order(fuzzy):
    """2,000 records of 48 names in 3 cities: every query's candidates tie
    with hundreds of others, so the order is the slot order the cap and
    the adaptive limit cut at; the lists must be equal, order included."""
    entities = _corpus_entities(2000, 7)
    env = {"MIN_RELEVANCE": "0.0", "MAX_SEARCH_HITS": "40",
           "FUZZY_SEARCH": fuzzy}
    lists = []
    for pkg in (JAX, PORT):
        sc = pkg.CFG.parse_config(CORPUS_XML, env=env)
        wc = sc.deduplications["people"]
        idx = pkg.I.InvertedIndex(wc.duke, sc.tunables)
        records = pkg.D.IncrementalDataSource(
            wc.duke.data_sources[0]).records_for_batch(entities)
        for r in records:
            idx.index(r)
        idx.commit()
        lists.append([[c.record_id for c in idx.find_candidate_matches(r)]
                      for r in records[::10]])
    assert lists[1] == lists[0]
    assert sum(map(len, lists[1])) > 150 * 30


# -- the service over HTTP ---------------------------------------------------------

HTTP_XML = """
<DukeMicroService>
  <Deduplication name="people" link-database-type="in-memory">
    <duke>
      <object class="no.priv.garshol.duke.comparators.NumericComparator"
              name="AreaComparator">
        <param name="min-ratio" value="0.7"/>
      </object>
      <schema>
        <threshold>0.9</threshold>
        <maybe-threshold>0.7</maybe-threshold>
        <property><name>NAME</name>
          <comparator>levenshtein</comparator><low>0.3</low><high>0.88</high>
        </property>
        <property><name>AREA</name>
          <comparator>AreaComparator</comparator><low>0.45</low><high>0.65</high>
        </property>
        <property><name>SSN</name>
          <comparator>exact</comparator><low>0.3</low><high>0.95</high>
        </property>
      </schema>
      <data-source class="io.sesam.dukemicroservice.IncrementalDeduplicationDataSource">
        <param name="dataset-id" value="crm"/>
        <column name="name" property="NAME"/>
        <column name="area" property="AREA"/>
        <column name="ssn" property="SSN"/>
      </data-source>
    </duke>
  </Deduplication>
</DukeMicroService>
"""


class _Served:
    def __init__(self, pkg, app):
        self.app = app
        self.server = pkg.A.serve(app, port=0, host="127.0.0.1")
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.port = self.server.server_address[1]

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        self.app.close()


def test_http_host_backend_bit_identical_to_jax(monkeypatch):
    monkeypatch.setenv("MIN_RELEVANCE", "0.3")
    batches = [_stresstest_entities(150, 77 + k, f"h{k}_") for k in range(3)]
    served = [_Served(JAX, JA.DukeApp(JCFG.parse_config(HTTP_XML),
                                      backend="host", persistent=False)),
              _Served(PORT, TA.DukeApp(TCFG.parse_config(HTTP_XML),
                                       backend="host", persistent=False))]
    assert served[1].app.device is None
    tapes, bodies = [], []
    try:
        for s in served:
            tape = _Tape()
            s.app.deduplications["people"].processor.add_match_listener(tape)
            tapes.append(tape)
            for batch in batches:
                _post(s.port, "/deduplication/people/crm", batch)
            _post(s.port, "/deduplication/people/crm",
                  [{"_id": "h0_1", "_deleted": True}])
            transform = _post(s.port,
                              "/deduplication/people/crm/httptransform",
                              [dict(batches[0][3], _id="t1")])
            bodies.append((_TS.sub(b'"_updated": 0',
                                   _feed(s.port, "/deduplication/people")),
                           transform))
    finally:
        for s in served:
            s.close()
    assert bodies[1] == bodies[0]
    assert tapes[1].events == tapes[0].events
    rows = json.loads(bodies[1][0])
    assert len(rows) > 10 and any(r["_deleted"] for r in rows)
    assert any(e[0] == "maybe" for e in tapes[1].events)


def test_persistent_restart_by_replay_equals_uninterrupted(tmp_path,
                                                           monkeypatch):
    """A persistent host workload closed after two POSTs restarts by
    replaying its record store (the inverted index has no snapshot); after
    the third POST its feed equals the uninterrupted run's."""
    monkeypatch.setenv("MIN_RELEVANCE", "0.3")
    batches = [_stresstest_entities(120, 300 + k, f"r{k}_") for k in range(3)]
    batches[2] += [dict(e, _id=f"copy{i}")
                   for i, e in enumerate(batches[0][:20])]

    def config(folder):
        return TCFG.parse_config(HTTP_XML.replace(
            '<DukeMicroService>',
            f'<DukeMicroService dataFolder="{folder}">').replace(
            ' link-database-type="in-memory"', ""))

    def post_all(app, batch_list):
        wl = app.deduplications["people"]
        for batch in batch_list:
            assert wl.submit_batch("crm", batch) == []

    def feed(app):
        wl = app.deduplications["people"]
        with wl.lock:
            return sorted(json.dumps(r, sort_keys=True)
                          for r in feed_rows(wl.links_since(0)))

    whole = TA.DukeApp(config(tmp_path / "whole"), backend="host")
    post_all(whole, batches)
    want = feed(whole)
    whole.close()

    first = TA.DukeApp(config(tmp_path / "restart"), backend="host")
    assert first.deduplications["people"].restore_route is None
    post_all(first, batches[:2])
    first.close()
    folder = tmp_path / "restart" / "deduplication" / "people"
    assert not (folder / "corpus_snapshot.npz").exists()
    again = TA.DukeApp(config(tmp_path / "restart"), backend="host")
    try:
        wl = again.deduplications["people"]
        assert wl.restore_route == "replay"
        assert len(wl.index) == 240
        post_all(again, batches[2:])
        assert feed(again) == want
        assert len(want) > 20
    finally:
        again.close()


def test_host_app_never_resolves_a_device(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the host backend resolved a device")

    monkeypatch.setattr(TA, "resolve_device", refuse)
    monkeypatch.setattr(TW, "resolve_device", refuse)
    app = TA.DukeApp(TCFG.parse_config(HTTP_XML), backend="host",
                     device="cuda", persistent=False)
    try:
        assert app.device is None
        assert isinstance(app.deduplications["people"].index,
                          TI.InvertedIndex)
    finally:
        app.close()
