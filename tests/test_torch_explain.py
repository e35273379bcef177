"""The port's decision recorder, audit log and ``/explain`` held against
the JAX package's (``tests/test_explain.py``'s cases, differential).

Both packages take the same records in one process (JAX on the CPU, the
port with ``device="cpu"``, so every port kernel runs its plain version):

  * host breakdowns (per-property values, similarities, probabilities,
    logits, the pair logit and its probability) are bit-equal to JAX's,
    and ``sigmoid`` of the summed contributions is ``Processor.compare``
    exactly;
  * the device breakdown's per-property f32 logits are within
    ``certified_f32_margin`` of JAX's (the round's f32 bar), its band
    verdict and ``decided_path`` are equal, and its dd logit is within
    ``certified_dd_margin`` of JAX's, on the brute-force and ``ann``
    backends and on the mixed schema whose properties run every device
    comparator kind (Levenshtein, Jaro-Winkler, q-gram, Jaccard, Exact,
    Numeric, host-only PersonName);
  * ``explain_request`` answers with the same keys, the same host
    numbers, classification, link and explanation digest; retrieval
    provenance is equal (the ``ann`` cosine within 1e-6: both encode with
    numpy);
  * the decision recorder's latching, sampling and ring eviction, and
    ``LatchedRing`` itself, behave the same in both packages (one case
    run per package); the engine path's outcome counts, disagreements and
    latched counts are equal;
  * audit rows carry equal record and explanation digests;
  * ``POST /explain`` and ``/debug/decisions`` answer the same statuses.
"""

import itertools
import json
import math

import pytest

from sesam_duke_microservice_tpu.core.config import parse_config as jparse
from sesam_duke_microservice_tpu.engine import explain as JX
from sesam_duke_microservice_tpu.links import base as jlinkbase
from sesam_duke_microservice_tpu.engine.workload import (
    build_workload as jbuild,
)
from sesam_duke_microservice_tpu.ops import scoring as JS
from sesam_duke_microservice_tpu.telemetry import decisions as JD
from sesam_duke_microservice_tpu.telemetry import rings as JRings
from sesam_duke_microservice_tpu_torch.core.config import (
    parse_config as tparse,
)
from sesam_duke_microservice_tpu_torch.engine import explain as TX
from sesam_duke_microservice_tpu_torch.links import base as tlinkbase
from sesam_duke_microservice_tpu_torch.engine.workload import (
    build_workload as tbuild,
)
from sesam_duke_microservice_tpu_torch.ops import bounds as TB
from sesam_duke_microservice_tpu_torch.telemetry import decisions as TD
from sesam_duke_microservice_tpu_torch.telemetry import rings as TRings
from test_torch_finalize import _config, _entities
from test_torch_service_surface import (
    config_xml,
    entities,
    jax_app,
    port_app,
    post_json,
    request,
    served,
)
from torch_jax_cache import jax_cache_off  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

PKGS = pytest.mark.parametrize("pkg", ["jax", "port"])


def workloads(schema, backend, monkeypatch):
    """(JAX workload, port workload) of one schema, in memory, each with
    a link clock that counts (both make the same links in the same
    order, so their timestamps agree)."""
    monkeypatch.setenv("DUKE_FEATURE_CACHE_MB", "0")
    for base in (jlinkbase, tlinkbase):
        ticks = itertools.count(1_700_000_000_000)
        monkeypatch.setattr(base, "now_millis", lambda t=ticks: next(t))
    if backend == "ann":
        from sesam_duke_microservice_tpu.ops import encoder as JE

        # the JAX C++ encoder rounds differently in the last f32 bit; the
        # port carries the numpy path both sides then share
        monkeypatch.setattr(JE, "_native_embed", lambda: None)
        from sesam_duke_microservice_tpu_torch.ops import embedding as TE

        monkeypatch.setattr(TE, "_native_embed", lambda: None)
    xml = _config(schema)
    jsc, tsc = jparse(xml), tparse(xml)
    jwl = jbuild(jsc.deduplications[schema], jsc, backend=backend,
                 persistent=False)
    if backend == "ann":
        # the JAX package reads the width once, at its first import; the
        # port per index: give the port the width the JAX index took
        monkeypatch.setenv("DEVICE_ANN_DIM", str(jwl.index.dim))
    twl = tbuild(tsc.deduplications[schema], tsc, backend=backend,
                 device="cpu", persistent=False)
    return jwl, twl


def feed(wls, batches):
    for wl in wls:
        for batch in batches:
            with wl.lock:
                wl.process_batch("crm", batch)


def pairs_of(ents, n=6):
    ids = [f"crm__{e['_id']}" for e in ents]
    return [(ids[i], ids[i + 1]) for i in range(0, 2 * n, 2)]


# -- host and device breakdowns -----------------------------------------------

@pytest.mark.parametrize("backend", ["device", "ann"])
@pytest.mark.parametrize("schema", ["hostprop", "mixed"])
def test_breakdowns_equal_jax(schema, backend, monkeypatch):
    ents = _entities(schema, 24, seed=3, prefix="e")
    jwl, twl = workloads(schema, backend, monkeypatch)
    try:
        feed((jwl, twl), [ents])
        margin = TB.certified_f32_margin(twl.index.plan)
        dd_margin = TB.certified_dd_margin(twl.index.plan)
        assert margin == JS.certified_f32_margin(jwl.index.plan)
        for id1, id2 in pairs_of(ents):
            jr1, jr2 = (jwl.index.find_record_by_id(i) for i in (id1, id2))
            tr1, tr2 = (twl.index.find_record_by_id(i) for i in (id1, id2))
            jh = JX.host_breakdown(jwl.processor.schema, jr1, jr2)
            th = TX.host_breakdown(twl.processor.schema, tr1, tr2)
            assert th == jh  # bit for bit, floats included
            assert th["probability"] == twl.processor.compare(tr1, tr2)
            jdev = JX.device_breakdown(jwl.index, jr1, jr2)
            tdev = TX.device_breakdown(twl.index, tr1, tr2)
            assert sorted(tdev) == sorted(jdev)
            assert [p["name"] for p in tdev["per_property"]] == [
                p["name"] for p in jdev["per_property"]]
            for tp, jp in zip(tdev["per_property"], jdev["per_property"]):
                assert abs(tp["logit"] - jp["logit"]) <= margin, tp["name"]
            assert abs(tdev["logit"] - jdev["logit"]) <= margin
            for key in ("certified_margin", "host_bound_logit",
                        "survivor_bound", "decisive_prune_logit",
                        "band_verdict", "decided_path", "host_properties",
                        "dd_certifiable", "dd_fallback_properties",
                        "dd_unsafe", "dd_residue_reason"):
                assert tdev.get(key) == jdev.get(key), key
            if "dd_logit" in jdev:
                assert abs(tdev["dd_logit"] - jdev["dd_logit"]) <= dd_margin
                assert abs(tdev["dd_total_logit"]
                           - jdev["dd_total_logit"]) <= dd_margin
    finally:
        jwl.close()
        twl.close()


def test_missing_property_contributes_nothing():
    sc = tparse(_config("mixed"))
    ds = tbuild(sc.deduplications["mixed"], sc, backend="host",
                persistent=False)
    schema = ds.processor.schema
    try:
        conv = ds.datasources["crm"]
        r1 = conv.record_for_entity({"_id": "a", "name": "acme corp"})
        r2 = conv.record_for_entity({"_id": "b", "name": "acme corp",
                                     "given": "ola"})
    finally:
        ds.close()
    out = TX.host_breakdown(schema, r1, r2)
    by_name = {p["name"]: p for p in out["properties"]}
    assert by_name["GIVEN"]["status"] == "missing"
    assert by_name["GIVEN"]["logit"] == 0.0
    assert by_name["NAME"]["status"] == "compared"
    assert by_name["NAME"]["best_similarity"] == 1.0


# -- explain_request ------------------------------------------------------------

@pytest.mark.parametrize("backend", ["host", "device", "ann"])
def test_explain_request_equal_jax(backend, monkeypatch):
    monkeypatch.setenv("MIN_RELEVANCE", "0.05")
    ents = _entities("mixed", 20, seed=9, prefix="x")
    jwl, twl = workloads("mixed", backend, monkeypatch)
    try:
        feed((jwl, twl), [ents])
        raw = {"record1": {"dataset": "crm", "entity": ents[2]},
               "id2": f"crm__{ents[3]['_id']}"}
        for payload in [{"id1": a, "id2": b} for a, b in pairs_of(ents, 4)
                        ] + [raw]:
            jout = JX.explain_request(jwl, payload)
            tout = TX.explain_request(twl, payload)
            assert sorted(tout) == sorted(jout)
            for key in ("workload", "kind", "id1", "id2", "thresholds",
                        "properties", "pair_logit", "probability",
                        "classification", "link", "explanation_digest"):
                assert tout[key] == jout[key], key
            total = 0.0  # the fold's order (sum() compensates since 3.12)
            for p in tout["properties"]:
                total += p["logit"]
            assert 1.0 / (1.0 + math.exp(-total)) == tout["probability"]
            jret, tret = jout["retrieval"], tout["retrieval"]
            assert sorted(tret) == sorted(jret)
            for key in tret:
                if key == "cosine":
                    assert abs(tret[key] - jret[key]) <= 1e-6
                elif key == "survivor_bound":
                    assert tret[key] == pytest.approx(jret[key], abs=0)
                else:
                    assert tret[key] == jret[key], key
        for module, wl in ((JX, jwl), (TX, twl)):
            with pytest.raises(module.ExplainError) as err:
                module.explain_request(wl, {"id1": "nope", "id2": "crm__x0"})
            assert err.value.status == 404
            with pytest.raises(module.ExplainError) as err:
                module.explain_request(wl, {})
            assert err.value.status == 400
    finally:
        jwl.close()
        twl.close()


@pytest.mark.parametrize("backend", ["host", "device"])
def test_replay_leaves_pipeline_bit_identical(backend, monkeypatch):
    """Explain between and after batches changes nothing: the port's
    link rows with explains equal its rows without, and JAX's."""
    ents = _entities("hostprop", 40, seed=5, prefix="p")

    def run(build, parse, x, with_explain):
        sc = parse(_config("hostprop"))
        kw = {} if build is jbuild else {"device": "cpu"}
        wl = build(sc.deduplications["hostprop"], sc, backend=backend,
                   persistent=False, **kw)
        try:
            with wl.lock:
                wl.process_batch("crm", ents[:20])
            if with_explain:
                x.explain_request(wl, {"id1": "crm__p0", "id2": "crm__p1"})
                x.explain_request(wl, {
                    "record1": {"dataset": "crm", "entity": ents[2]},
                    "id2": "crm__p3"})
            with wl.lock:
                wl.process_batch("crm", ents[20:])
            if with_explain:
                x.explain_request(wl, {"id1": "crm__p4", "id2": "crm__p5"})
            return sorted((l.id1, l.id2, l.kind.value, l.status.value,
                           l.confidence.hex())
                          for l in wl.link_database.get_all_links())
        finally:
            wl.close()

    base = run(tbuild, tparse, TX, False)
    assert base
    assert run(tbuild, tparse, TX, True) == base
    assert run(jbuild, jparse, JX, True) == base


# -- decision recorder and the latched ring -------------------------------------

def _mods(pkg):
    return (JD, JRings, JX) if pkg == "jax" else (TD, TRings, TX)


def _rec(pkg, name="acme"):
    """A record with id ``q`` and one NAME value, of either package."""
    from sesam_duke_microservice_tpu.core.records import Record as JRecord
    from sesam_duke_microservice_tpu_torch.core.records import (
        Record as TRecord,
    )

    r = (JRecord if pkg == "jax" else TRecord)()
    r.add_value("ID", "q")
    r.add_value("NAME", name)
    return r


@PKGS
def test_disagreement_latched_at_sample_zero(pkg):
    D = _mods(pkg)[0]
    rec = D.DecisionRecorder(0.8, 0.6, sample_rate=0.0, enabled=True)
    q = _rec(pkg)
    rec.observe(q, [D.PairDecision("c1", 3.0, False, 0.5)])
    rec.observe(q, [D.PairDecision("c2", 3.0, False, 0.97)])
    assert rec.disagreements == 1
    (record,) = rec.records()
    assert (record["latched"], record["candidate"]) == ("disagreement", "c1")
    assert (rec.outcomes["reject"], rec.outcomes["match"]) == (1, 1)


@PKGS
def test_near_band_skip_latched(pkg):
    D = _mods(pkg)[0]
    rec = D.DecisionRecorder(0.8, 0.6, sample_rate=0.0, enabled=True)
    prune, margin = 1.0, 0.01
    rec.observe(_rec(pkg), [
        D.PairDecision("near", prune - 0.005, True, None),
        D.PairDecision("far", prune - 0.5, True, None),
        D.PairDecision("cert", prune + 1.0, True, None,
                       path="device_certified"),
    ], prune=prune, margin=margin)
    assert (rec.outcomes["pruned"], rec.outcomes["device_certified"]) == (
        2, 1)
    assert [r["candidate"] for r in rec.records()] == ["near"]
    assert rec.margin_slack_hist.count == 2


@PKGS
def test_sampling_records_breakdown(pkg):
    D, _, X = _mods(pkg)
    parse = jparse if pkg == "jax" else tparse
    schema = parse(config_xml()).deduplications["people"].duke
    cand = _rec(pkg, "acme corp")
    rec = D.DecisionRecorder(
        0.8, 0.6, sample_rate=1.0, enabled=True,
        breakdown=lambda q, c: X.host_breakdown(schema, q, c),
        resolver={"c": cand}.get)
    rec.observe(_rec(pkg, "acme corp"), [D.PairDecision("c", 4.0, False,
                                                        0.97)])
    (record,) = rec.records()
    assert record["sampled"] is True
    assert rec.similarity_hists["NAME"].count == 1


@PKGS
def test_disabled_recorder_is_inert(pkg):
    D = _mods(pkg)[0]
    rec = D.DecisionRecorder(0.8, 0.6, enabled=False)
    rec.observe(_rec(pkg), [D.PairDecision("c", 3.0, False, 0.5)])
    assert rec.outcomes["reject"] == 0 and len(rec.ring) == 0


@PKGS
def test_decision_ring_evicts_under_its_byte_budget(pkg):
    """A ring of 4 records at most, 1 KiB at most: latched records
    survive a sampled flood; eviction and bytes equal across packages."""
    D = _mods(pkg)[0]
    rec = D.DecisionRecorder(0.8, 0.6, sample_rate=1.0, enabled=True,
                             capacity=4, byte_budget=1024)
    q = _rec(pkg)
    rec.observe(q, [D.PairDecision("latched", 3.0, False, 0.5)])
    for i in range(20):
        rec.observe(q, [D.PairDecision(f"s{i}", 3.0, False, 0.97)])
    cands = [r["candidate"] for r in rec.records()]
    assert "latched" in cands and cands[0] == "s19"
    assert len(cands) <= 4 and rec.ring.bytes <= 1024


@PKGS
def test_latched_ring_semantics(pkg):
    R = _mods(pkg)[1]
    ring = R.LatchedRing(3)
    ring.put("a", "A", remarkable=True)
    for k in "bcd":
        ring.put(k, k.upper())
    assert ring.records() == ["D", "C", "A"]
    ring = R.LatchedRing(2)
    for k in "abc":
        ring.put(k, k.upper(), remarkable=True)
    assert ring.get("a") is None and len(ring) == 2
    ring = R.LatchedRing(100, byte_budget=100)
    ring.put("a", "A", nbytes=60)
    ring.put("b", "B", remarkable=True, nbytes=60)
    assert ring.get("a") is None and ring.bytes == 60
    ring.put("c", "C", nbytes=200)
    assert ring.get("c") == "C" and len(ring) == 1
    ring = R.LatchedRing(10, byte_budget=1000)
    ring.put("a", "A1", nbytes=100)
    ring.put("b", "B", nbytes=50)
    ring.put("a", "A2", nbytes=10)
    assert ring.bytes == 60 and ring.records() == ["B", "A2"]


@pytest.mark.parametrize("schema", ["hostprop", "mixed"])
@pytest.mark.parametrize("backend", ["host", "device"])
def test_engine_path_decisions_equal_jax(schema, backend, monkeypatch):
    """The engine's decision monitors on the same traffic: equal outcome
    counts, disagreements, latched counts and pair-logit histograms; on
    the device backend every finalized survivor is one decision."""
    monkeypatch.setenv("DUKE_DECISION_SAMPLE", "0")
    monkeypatch.setenv("MIN_RELEVANCE", "0.05")
    ents = _entities(schema, 32, seed=13, prefix="d")
    jwl, twl = workloads(schema, backend, monkeypatch)
    try:
        feed((jwl, twl), [ents[:16], ents[16:]])
        jr, tr = jwl.processor.decisions, twl.processor.decisions
        assert tr.outcomes == jr.outcomes
        assert sum(tr.outcomes.values()) > 0
        assert (tr.disagreements, tr.latched) == (jr.disagreements,
                                                  jr.latched)
        assert tr.pair_logit_hist.counts == jr.pair_logit_hist.counts
        assert tr.margin_slack_hist.count == jr.margin_slack_hist.count
        if backend == "device":
            st = twl.processor.stats
            assert sum(tr.outcomes.values()) == (
                st.pairs_rescored + st.pairs_skipped
                + st.pairs_device_certified)
    finally:
        jwl.close()
        twl.close()


# -- audit log ----------------------------------------------------------------

@pytest.mark.parametrize("backend", ["host", "device"])
def test_audit_rows_equal_jax(backend, tmp_path, monkeypatch):
    monkeypatch.setenv("MIN_RELEVANCE", "0.05")
    ents = _entities("hostprop", 24, seed=17, prefix="a")
    rows = []
    for build, parse, D, X, kw in (
            (jbuild, jparse, JD, JX, {}),
            (tbuild, tparse, TD, TX, {"device": "cpu"})):
        path = tmp_path / f"audit-{len(rows)}.jsonl"
        monkeypatch.setenv("DUKE_AUDIT_LOG", str(path))
        sc = parse(_config("hostprop"))
        wl = build(sc.deduplications["hostprop"], sc, backend=backend,
                   persistent=False, **kw)
        try:
            with wl.lock:
                wl.process_batch("crm", ents)
            D.audit_log().drain()
            got = [json.loads(line)
                   for line in path.read_text().splitlines()]
            assert got
            first = got[0]
            out = X.explain_request(wl, {"id1": first["id1"],
                                         "id2": first["id2"]})
            assert out["explanation_digest"] == first["explanation_digest"]
            rows.append([{k: v for k, v in r.items() if k != "time_unix"}
                         for r in got])
        finally:
            wl.close()
            monkeypatch.delenv("DUKE_AUDIT_LOG")
            D.audit_log()  # closes the instance of the removed path
    assert rows[1] == rows[0]


def test_audit_log_drops_oldest_past_its_pending_cap(tmp_path):
    """The audit log never blocks: past ``max_pending`` sealed batches
    the oldest drops and counts, as the JAX package's does."""
    counts = []
    for D in (JD, TD):
        log = D.AuditLog(str(tmp_path / f"{D.__name__}.jsonl"),
                         max_pending=1)
        log._wb._ensure_thread = lambda: None  # keep the batches queued
        for i in range(4):
            log.append({"i": i})
            log.flush()
        counts.append((log.entries, log.dropped))
    assert counts[0] == counts[1] == (4, 3)


# -- HTTP -----------------------------------------------------------------------

def test_explain_and_decisions_endpoints_equal_jax(monkeypatch):
    monkeypatch.setenv("DUKE_FEATURE_CACHE_MB", "0")
    monkeypatch.setenv("DUKE_DECISION_SAMPLE", "1.0")
    xml = config_xml()
    apps = (jax_app(xml), port_app(xml))
    crm = entities(12, 3, "c") + [{"_id": "dup", "name": "anne hansen",
                                   "email": "1@x.no"},
                                  {"_id": "dup2", "name": "anne hansen",
                                   "email": "1@x.no"}]
    seen = []
    with served(*apps) as urls:
        for url in urls:
            status, _, body = post_json(url + "/deduplication/people/crm",
                                        crm)
            assert status == 200, body
            answers = []
            for payload in (
                    {"name": "people", "id1": "crm__dup", "id2": "crm__dup2"},
                    {"name": "people", "id1": "nope", "id2": "crm__dup"},
                    {"name": "zzz", "id1": "a", "id2": "b"},
                    {"id1": "crm__dup", "id2": "crm__dup2"},
                    {}):
                status, _, body = post_json(url + "/explain", payload)
                answers.append((status, sorted(json.loads(body))
                                if body.startswith(b"{") else None))
            out = json.loads(post_json(url + "/explain", {
                "name": "people", "id1": "crm__dup", "id2": "crm__dup2"})[2])
            assert out["classification"] == "match"
            status, _, body = request(url + "/debug/decisions")
            listing = json.loads(body)["decisions"]
            assert status == 200 and listing
            full = json.loads(request(
                url + f"/debug/decisions/{listing[0]['id']}")[2])
            assert full["outcome"] == listing[0]["outcome"]
            answers.append((status, sorted(listing[0]), sorted(full)))
            answers.append(request(url + "/debug/decisions/d99999999")[0])
            stats = json.loads(request(url + "/stats")[2])
            people = next(w for w in stats["workloads"]
                          if w["name"] == "people")
            answers.append(people["decisions"]["outcomes"])
            seen.append((answers, out["probability"],
                         out["explanation_digest"]))
    assert seen[1] == seen[0]
    statuses = [a[0] for a in seen[1][0][:5]]
    # {} names no workload, and the config has two: ambiguous
    assert statuses == [200, 404, 404, 400, 400]
    assert seen[1][0][-2] == 404


def test_decisions_listing_sorts_newest_first():
    """The listing's numeric id sort (past the zero padding) is the JAX
    package's."""
    from sesam_duke_microservice_tpu_torch.service import debug

    class _Rec:
        def __init__(self, ids):
            self._ids = ids

        def records(self):
            return [{"id": i} for i in self._ids]

    class _Proc:
        decisions = _Rec(["d00000009", "d100000000", "d00000010"])

    class _Wl:
        processor = _Proc()

    class _App:
        deduplications = {"w": _Wl()}
        record_linkages = {}

    rows = json.loads(debug.handle_decisions(_App())[1])["decisions"]
    assert [r["id"] for r in rows] == ["d100000000", "d00000010",
                                       "d00000009"]
