"""The one general generator: entities and POST bodies from a
configuration's ``generator`` block, a traffic mix's parameters and the
seed.

A stream of entities is a pure function of (seed, stream key), so every
run with one seed sends the same entities; streams differ by key: the
preload of each dataset, and each client's POSTs (its warm-up POSTs
first, then those of the measured window).

``countries``: entities of the bundled countries workloads as the
upstream stresstest's fake sources feed them.  Each entity draws a key
from the stresstest's id pool (``key``, 1-1e6); the key fixes its country
name, its capital (each a word of a pool drawn from the seed) and its
area (in ``area``, 1-10), so two entities with one key are duplicates
at the rate the pool sets.  A share of names and of capitals carries
its word's one variant (one letter replaced by one of
``perturb_letters``), which bounds the distinct values the reference
has to compare.  The JSON field of each value is the dataset's own
(``fields``: dataset -> {field: "name" | "capital" | "area"}).  Drawn
with NumPy so that set-up stays short.
"""

import json

import numpy as np

PRELOAD, CLIENT, POOLS = 1, 2, 3


def _rng(seed: int, *key: int) -> np.random.Generator:
    entropy = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence(entropy, spawn_key=key)))


class Entities:
    """A block of generated entities: ids and raw JSON fields."""

    def __init__(self, ids, fields):
        self.ids = ids
        self.fields = fields

    def __len__(self):
        return len(self.ids)

    def rows(self, lo=0, hi=None):
        hi = len(self.ids) if hi is None else hi
        keys = ["_id", *self.fields]
        cols = [self.ids[lo:hi]] + [c[lo:hi] for c in self.fields.values()]
        return [dict(zip(keys, values)) for values in zip(*cols)]

    def body(self, lo, hi) -> bytes:
        """The JSON array of entities lo..hi (values are plain ASCII)."""
        template = "{" + ",".join(f'"{k}":"%s"' for k in
                                  ["_id", *self.fields]) + "}"
        cols = [self.ids[lo:hi]] + [c[lo:hi] for c in self.fields.values()]
        return ("[" + ",".join(template % values for values in zip(*cols))
                + "]").encode()


def _words(rng: np.random.Generator, n: int, lo: int, hi: int):
    """n lowercase words of lo..hi letters."""
    lengths = rng.integers(lo, hi + 1, n)
    letters = rng.integers(0, 26, (n, hi)).astype(np.uint8) + ord("a")
    return [bytes(row[:k]).decode() for row, k in
            zip(letters, lengths.tolist())]


def _variants(rng: np.random.Generator, words, letters: str):
    """Each word with one letter replaced by one of ``letters``."""
    where = rng.random(len(words))
    pick = rng.integers(0, len(letters), len(words))
    out = []
    for w, f, k in zip(words, where.tolist(), pick.tolist()):
        pos = int(f * len(w))
        out.append(w[:pos] + letters[k] + w[pos + 1:])
    return out


class Pools:
    """The words of a seed, and what each key of the id pool holds."""

    def __init__(self, gen: dict, seed: int):
        rng = _rng(seed, POOLS)
        lo, hi = gen["word_letters"]
        self.values = {}
        for kind in ("name", "capital"):
            words = _words(rng, gen["pool_words"], lo, hi)
            self.values[kind] = (np.array(words, dtype=object),
                                 np.array(_variants(rng, words,
                                                    gen["perturb_letters"]),
                                          dtype=object))
        keys = gen["key"][1] + 1
        self.word_of = {k: rng.integers(0, gen["pool_words"], keys)
                        for k in ("name", "capital")}
        self.area_of = rng.integers(gen["area"][0], gen["area"][1] + 1, keys)


_POOLS = {}


def pools(gen: dict, seed: int) -> Pools:
    """The pools of (gen, seed), made once for all of a run's streams."""
    key = (json.dumps(gen, sort_keys=True), seed)
    if key not in _POOLS:
        _POOLS.clear()
        _POOLS[key] = Pools(gen, seed)
    return _POOLS[key]


def countries(gen: dict, rng: np.random.Generator, n: int, prefix: str,
              dataset: str, seed: int):
    p = pools(gen, seed)
    key = rng.integers(gen["key"][0], gen["key"][1] + 1, n)
    values = {"area": [str(v) for v in p.area_of[key].tolist()]}
    for kind in ("name", "capital"):
        base, variant = p.values[kind]
        word = p.word_of[kind][key]
        perturbed = rng.random(n) < gen["perturb_share"]
        values[kind] = np.where(perturbed, variant[word], base[word]).tolist()
    ids = [f"{prefix}{i}" for i in range(n)]
    return Entities(ids, {field: values[what] for field, what in
                          gen["fields"][dataset].items()})


GENERATORS = {"countries": countries}


def entities(gen: dict, seed: int, key, n: int, prefix: str,
             dataset: str) -> Entities:
    make = GENERATORS[gen["kind"]]
    return make(gen, _rng(seed, *key), n, prefix, dataset, seed)


class Plan:
    """Everything a run sends: the preload of each dataset and each
    client's POST bodies, made in set-up.

    ``datasets``: the config's dataset ids; client ``c`` feeds
    ``datasets[c % len(datasets)]``."""

    def __init__(self, config: dict, traffic: dict, datasets, seed: int):
        gen = config["generator"]
        self.datasets = list(datasets)
        self.preload = {
            d: entities(gen, seed, (PRELOAD, k), config["preload_per_dataset"],
                        "p", d)
            for k, d in enumerate(self.datasets)}
        self.post_records = traffic["post_records"]
        self.warm_posts = traffic["warm_posts_per_client"]
        posts = self.warm_posts + traffic["posts_per_client"]
        self.clients = []
        for c in range(traffic["clients"]):
            dataset = self.datasets[c % len(self.datasets)]
            block = entities(gen, seed, (CLIENT, c), posts * self.post_records,
                             f"c{c}-", dataset)
            bodies = [block.body(m * self.post_records,
                                 (m + 1) * self.post_records)
                      for m in range(posts)]
            self.clients.append(Client(c, dataset, block, bodies,
                                       self.post_records))


class Client:
    def __init__(self, number, dataset, block, bodies, post_records):
        self.number = number
        self.dataset = dataset
        self.block = block
        self.bodies = bodies
        self.post_records = post_records
