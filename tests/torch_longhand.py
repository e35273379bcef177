"""The example-config flow and its longhand oracle, with no engine code.

The reference's only functional system test is the Sesam pipe config
``sesam_node_example_config.conf.json``: the Duke example country CSVs go
through both workloads' sink endpoints, the links come back through the
``?since=`` feed, and the four http-transform endpoints echo entities with
their ``duke_links``.  ``example_flow`` drives that flow over HTTP against
a served app of the bundled default config (testdukeconfig.xml) and
asserts against links computed longhand here: textbook Levenshtein DP,
NumericComparator's ratio cut, Duke's published probability map and the
naive-Bayes fold -- so the assertion chain never passes through either
package's comparators.  The confidences it compares are the host's f64
values, within 1e-9.

Imports nothing but the standard library: ``tests/test_torch_example_e2e.py``
runs it on the CPU and ``chip_smoke.py`` on the card.  The reference
config's ``capical`` column-name typo for the dbpedia dataset is part of
the schema and kept.
"""

import csv
import json
import os
import urllib.request

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
PAIR = "countries-dbpedia-mondial"
CONFIDENCE_TOL = 1e-9


def read_csv(name):
    with open(os.path.join(FIXTURES, name), newline="") as f:
        return list(csv.DictReader(f))


def entities(rows):
    out = []
    for row in rows:
        entity = dict(row)
        entity["_id"] = entity.pop("id")
        out.append(entity)
    return out


# -- longhand Duke math -------------------------------------------------------


def lev_distance(a, b):
    m, n = len(a), len(b)
    d = [[0] * (n + 1) for _ in range(m + 1)]
    for i in range(m + 1):
        d[i][0] = i
    for j in range(n + 1):
        d[0][j] = j
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            d[i][j] = min(d[i - 1][j] + 1, d[i][j - 1] + 1,
                          d[i - 1][j - 1] + (a[i - 1] != b[j - 1]))
    return d[m][n]


def lev_sim(a, b):
    if a == b:
        return 1.0
    s, l = min(len(a), len(b)), max(len(a), len(b))
    if s == 0 or (l - s) * 2 > s:
        return 0.0
    return 1.0 - min(lev_distance(a, b), s) / s


def numeric_sim(a, b, min_ratio=0.7):
    d1, d2 = float(a), float(b)
    if d1 == d2:
        return 1.0
    ratio = min(abs(d1), abs(d2)) / max(abs(d1), abs(d2))
    return ratio if ratio >= min_ratio else 0.0


def pmap(sim, low, high):
    return (high - 0.5) * sim * sim + 0.5 if sim >= 0.5 else low


def bayes(ps):
    num = den = 1.0
    for p in ps:
        num *= p
        den *= 1.0 - p
    return num / (num + den)


def expected_confidence(db_row, mo_row):
    """Longhand pair probability under the demo schema: NAME .09/.93
    Levenshtein, AREA .04/.73 Numeric(0.7), CAPITAL .12/.61 Levenshtein;
    values lower-cased by the cleaners."""
    name = pmap(lev_sim(db_row["country"].lower(),
                        mo_row["country"].lower()), 0.09, 0.93)
    area = pmap(numeric_sim(db_row["area"], mo_row["area"]), 0.04, 0.73)
    cap = pmap(lev_sim(db_row["capical"].lower(),
                       mo_row["capital"].lower()), 0.12, 0.61)
    return bayes([name, area, cap])


def expected_links(threshold):
    """Cross-dataset country pairs whose longhand probability clears the
    threshold: {(dbpedia id, mondial id): confidence}."""
    out = {}
    for db_row in read_csv("countries_dbpedia.csv"):
        for mo_row in read_csv("countries_mondial.csv"):
            conf = expected_confidence(db_row, mo_row)
            if conf > threshold:
                out[(db_row["id"], mo_row["id"])] = conf
    return out


# -- the flow over HTTP -------------------------------------------------------


def post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def get(url):
    with urllib.request.urlopen(url, timeout=300) as resp:
        return json.loads(resp.read())


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _check_links(got, want, subset, what):
    """``got`` {pair: confidence} against the longhand ``want``: equal
    sets (or a subset, for a backend whose recall may lose pairs), every
    confidence within CONFIDENCE_TOL."""
    extra = set(got) - set(want)
    missing = set(want) - set(got)
    _check(not extra, f"{what}: links the longhand oracle lacks: "
                      f"{sorted(extra)}")
    _check(subset or not missing,
           f"{what}: longhand links missing: {sorted(missing)}")
    for pair, conf in got.items():
        _check(abs(conf - want[pair]) <= CONFIDENCE_TOL,
               f"{what}: {pair} confidence {conf!r} vs longhand "
               f"{want[pair]!r}")
    return sorted(missing)


def example_flow(base, *, subset=False):
    """Steps 1-5 of the example-config flow against the app served at
    ``base``; raises AssertionError on the first difference.  ``subset``:
    the feeds' links may be a subset of the longhand sets (``ann``).
    Returns the linkage and dedup feeds' rows and the longhand pairs each
    lacks."""
    dbpedia = entities(read_csv("countries_dbpedia.csv"))
    mondial = entities(read_csv("countries_mondial.csv"))

    # 1. sink pushes: each dataset into BOTH workloads
    for kind in ("recordlinkage", "deduplication"):
        for dataset, rows in (("countries-dbpedia", dbpedia),
                              ("countries-mondial", mondial)):
            got = post(f"{base}/{kind}/{PAIR}/{dataset}", rows)
            _check(got == (200, {"success": True}),
                   f"POST {kind}/{dataset}: {got}")

    # 2. the since-feed: linkage at threshold 0.7 holds exactly the
    #    longhand pairs with their confidences
    link_rows = get(f"{base}/recordlinkage/{PAIR}?since=0")
    live = [r for r in link_rows if not r["_deleted"]]
    got = {(r["entity1"], r["entity2"]): r["confidence"] for r in live}
    missing_linkage = _check_links(got, expected_links(0.7), subset,
                                   "linkage")
    for r in live:
        _check((r["dataset1"], r["dataset2"])
               == ("countries-dbpedia", "countries-mondial"),
               f"linkage row datasets: {r}")
    # wire format: link _id is id1_id2 with ':' mapped to '_'; the France
    # row's entity id carries a ':'
    fr = [r for r in link_rows if r["entity1"] == "fr:7"]
    _check(fr or subset, "linkage: no row for fr:7")
    for r in fr:
        _check(":" not in r["_id"] and "fr_7" in r["_id"],
               f"linkage _id {r['_id']!r}")
        _check(set(r) == {"_id", "_updated", "_deleted", "entity1",
                          "entity2", "dataset1", "dataset2", "confidence"},
               f"linkage row keys {sorted(r)}")

    # 3. dedup: the same corpora in one group-free workload at 0.9
    dedup_rows = get(f"{base}/deduplication/{PAIR}?since=0")
    want_dedup = {frozenset(p): c for p, c in expected_links(0.9).items()}
    got_dedup = {frozenset((r["entity1"], r["entity2"])): r["confidence"]
                 for r in dedup_rows if not r["_deleted"]}
    missing_dedup = _check_links(got_dedup, want_dedup, subset, "dedup")

    # 4. incremental since: polling from the max timestamp returns nothing
    if dedup_rows:
        last = max(r["_updated"] for r in dedup_rows)
        tail = get(f"{base}/deduplication/{PAIR}?since={last}")
        _check(tail == [], f"dedup since={last}: {tail}")

    # 5. the four http-transform endpoints: entities echoed with
    #    duke_links, no link-db side effects
    before = get(f"{base}/recordlinkage/{PAIR}?since=0")
    probe = [{"_id": "probe1", "country": "Norway", "area": "385000",
              "capical": "Oslo"}]
    status, body = post(f"{base}/recordlinkage/{PAIR}/countries-dbpedia"
                        "/httptransform", probe)
    _check(status == 200 and body[0]["_id"] == "probe1",
           f"linkage transform: {status} {body}")
    linked = {d["entityId"] for d in body[0]["duke_links"]}
    _check("m1" in linked, f"linkage transform: mondial Norway not in "
                           f"{sorted(linked)}")
    _check("1" not in linked, "linkage transform: same-group row linked")
    probe_mo = [{"_id": "probe2", "country": "Sweden",
                 "capital": "Stockholm", "area": "449000"}]
    status, body = post(f"{base}/recordlinkage/{PAIR}/countries-mondial"
                        "/httptransform", probe_mo)
    _check(status == 200, f"linkage transform (mondial): {status}")
    linked = {d["entityId"] for d in body[0]["duke_links"]}
    _check("2" in linked, f"linkage transform: dbpedia Sweden not in "
                          f"{sorted(linked)}")
    for dataset, payload in (("countries-dbpedia", probe),
                             ("countries-mondial", probe_mo)):
        status, body = post(f"{base}/deduplication/{PAIR}/{dataset}"
                            "/httptransform", payload)
        _check(status == 200 and body[0]["duke_links"],
               f"dedup transform ({dataset}): {status} {body}")
    after = get(f"{base}/recordlinkage/{PAIR}?since=0")
    _check(after == before, "a transform wrote links")
    ids = {r["entity1"] for r in after} | {r["entity2"] for r in after}
    _check("probe1" not in ids and "probe2" not in ids,
           "a transform probe was indexed")
    return {"linkage": link_rows, "dedup": dedup_rows,
            "missing_linkage": missing_linkage,
            "missing_dedup": missing_dedup}
