"""The vectorised reference against the frozen longhand on a few hundred
entities, the blocking cut against the schema's numbers, the distance
table against the textbook DP, and the cleaners' domain."""

import itertools
import json

import numpy as np
import pytest

from portbench.harness.spec import BENCH
from portbench.harness.traffic import entities
from portbench.reference import links as L
from portbench.reference import longhand as H
from portbench.reference.schema import clean, parse


def load(name):
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    return config, parse(config["duke_xml"])


def longhand_confidence(wl, a, b):
    ps = []
    for prop in wl.props:
        x, y = a[prop.name], b[prop.name]
        if prop.kind == "levenshtein":
            sim = H.lev_sim(x, y)
        elif prop.kind == "numeric":
            sim = H.numeric_sim(x, y, prop.min_ratio)
        else:
            sim = H.exact_sim(x, y)
        ps.append(H.pmap(sim, prop.low, prop.high))
    return H.bayes(ps)


def small_records(wl, config, n=300, pool=40, keys=200, seed=5):
    gen = dict(config["generator"], pool_words=pool, key=[1, keys])
    per = n // len(wl.sources)
    blocks = []
    for k, src in enumerate(wl.sources):
        block = entities(gen, seed, (9, k), per, "t", src.dataset)
        blocks.append((src.dataset, block.ids, block.fields))
    return L.Records(wl, blocks)


def record_values(wl, recs, i):
    return {p.name: recs.values[p.name][i] for p in wl.props}


@pytest.mark.parametrize("name,needed", [
    ("dedup-stresstest", ["NAME", "AREA", "CAPITAL"]),
    ("linkage-stresstest", ["NAME", "AREA"])])
def test_the_necessary_properties_bound_the_fold(name, needed):
    _, wl = load(name)
    got = L.necessary_properties(wl)
    assert [p.name for p in got] == needed
    for prop in wl.props:
        best = [L.best_probability(p) for p in wl.props if p is not prop]
        assert (H.bayes(best + [prop.low]) <= wl.threshold) == (prop in got)


def test_pair_confidences_equal_the_longhand():
    config, wl = load("dedup-stresstest")
    recs = small_records(wl, config)
    cols = L.columns_of(recs)
    n = len(recs.ids)
    left, right = (np.array(x) for x in
                   zip(*itertools.combinations(range(0, n, 3), 2)))
    got = L.pair_confidences(wl, cols, left, right)
    for i, j, c in zip(left, right, got):
        want = longhand_confidence(wl, record_values(wl, recs, i),
                                   record_values(wl, recs, j))
        assert abs(c - want) <= 1e-15


def test_lev_distance_equals_the_textbook_dp():
    rng = np.random.default_rng(3)
    words = ["".join(rng.choice(list("abcde"), rng.integers(0, 9)))
             for _ in range(80)]
    a, b = words[:40], words[40:]
    got = L.lev_distance_many(a, b)
    assert list(got) == [H.lev_distance(x, y) for x, y in zip(a, b)]


def test_the_distance_table_holds_every_agreeing_pair():
    rng = np.random.default_rng(4)
    words = sorted({"".join(rng.choice(list("abcd"), rng.integers(1, 11)))
                    for _ in range(150)})
    u, v, d = L.lev_distance_table(words, block=32)
    got = {(a, b): dist for a, b, dist in zip(u.tolist(), v.tolist(),
                                              d.tolist())}
    want = {(a, b): H.lev_distance(words[a], words[b])
            for a, b in itertools.combinations(range(len(words)), 2)
            if H.lev_sim(words[a], words[b]) >= 0.5}
    assert want and got == want


@pytest.mark.parametrize("name", ["dedup-stresstest", "linkage-stresstest"])
def test_links_equal_the_longhand_over_all_pairs(name):
    config, wl = load(name)
    recs = small_records(wl, config)
    batches = [recs.ids[i:i + 50] for i in range(0, len(recs.ids), 50)]
    got = L.expected_links(recs, batches)
    want = {}
    for i, j in itertools.combinations(range(len(recs.ids)), 2):
        if wl.kind == "recordlinkage" and recs.group[i] == recs.group[j]:
            continue
        c = longhand_confidence(wl, record_values(wl, recs, i),
                                record_values(wl, recs, j))
        if c > wl.threshold:
            want[tuple(sorted((recs.ids[i], recs.ids[j])))] = c
    assert want and got.keys() == want.keys()
    assert max(abs(got[k] - want[k]) for k in want) <= 1e-15


def test_unprocessed_records_make_no_links():
    config, wl = load("dedup-stresstest")
    recs = small_records(wl, config)
    half = recs.ids[: len(recs.ids) // 2]
    got = L.expected_links(recs, [half])
    assert got and all(a in half and b in half for a, b in got)


def test_float32_moves_the_confidences_past_the_limit():
    config, wl = load("dedup-stresstest")
    recs = small_records(wl, config)
    batches = [recs.ids]
    hi = L.expected_links(recs, batches, np.float64)
    lo = L.expected_links(recs, batches, np.float32)
    gap = max(abs(lo[k] - hi[k]) for k in hi.keys() & lo.keys())
    assert gap > 100 * config["limits"]["confidence_gap"]


def test_the_example_cleaners_are_taken_only_on_plain_words():
    assert clean("lowercase", "  Oslo   Town ") == "oslo town"
    assert clean("word", "Oslo") == "oslo"
    assert clean(None, "Oslo") == "Oslo"
    for value in ("Republic of Korea", "Kingston (Jamaica)", "Mexico City"):
        with pytest.raises(ValueError):
            clean("word", value)
