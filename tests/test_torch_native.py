"""The port's C++ host library (``sesam_duke_microservice_tpu_torch.native``).

Counterparts of ``tests/test_native.py``: the library against the port's
own Python / numpy paths (``DUKE_TPU_NATIVE=0``, the oracle), exactly for
the comparators, hashes and q-gram sets and within ``NATIVE_EMBED_ATOL``
for the embedding.  Then the port's library against the JAX package's, bit
for bit, on all six entry points, with the UTF-16 alphabets of
``tests/wide_units.py`` (units >= 256, 0xFFFF, lone surrogates, U+0000)
among the inputs.  And the policy: a failed build raises while the knob is
on, and ``DUKE_TPU_NATIVE=0`` selects the Python paths without building.
"""

import random

import numpy as np
import pytest

from sesam_duke_microservice_tpu import native as jnative
from sesam_duke_microservice_tpu.core import comparators as JC
from sesam_duke_microservice_tpu.ops import encoder as JE
from sesam_duke_microservice_tpu_torch import native
from sesam_duke_microservice_tpu_torch.core import comparators as C
from sesam_duke_microservice_tpu_torch.ops import embedding as TH
from sesam_duke_microservice_tpu_torch.ops import features as TF
from wide_units import ALPHABETS

ALPHABET = "abcdefgh 0123456789åßñ漢字"


def _rand_string(rng, max_len=100, alphabet=ALPHABET):
    n = rng.randint(0, max_len)
    return "".join(rng.choice(alphabet) for _ in range(n))


def _pairs(seed=7, n=300, max_len=100, alphabet=ALPHABET):
    rng = random.Random(seed)
    pairs = [("", ""), ("", "abc"), ("abc", ""), ("same", "same"),
             ("a" * 70, "a" * 69 + "b"), ("x" * 65, "y" * 65)]
    for _ in range(n):
        a = _rand_string(rng, max_len, alphabet)
        # half the pairs are mutations of a (near-duplicates)
        if rng.random() < 0.5:
            b = list(a)
            for _ in range(rng.randint(0, 4)):
                if not b:
                    break
                op = rng.choice("ids")
                pos = rng.randrange(len(b))
                if op == "i":
                    b.insert(pos, rng.choice(alphabet))
                elif op == "d":
                    del b[pos]
                else:
                    b[pos] = rng.choice(alphabet)
            b = "".join(b)
        else:
            b = _rand_string(rng, max_len, alphabet)
        pairs.append((a, b))
    return pairs


# every wide UTF-16 alphabet of the kernel tests, as text, plus non-BMP
# characters (a surrogate pair after _utf16_expand)
WIDE = "".join(chr(u) for units in ALPHABETS.values() for u in units)
WIDE_ALPHABET = sorted(set(WIDE)) + ["😀", "𝔘", "é", "ab"]


def _wide_pairs(seed, n=120, max_len=40):
    rng = random.Random(seed)
    out = [("\ud800abc", "xabc"), ("\x00a", "a\x00"), ("￿" * 3, "￿")]
    for _ in range(n):
        out.append((_rand_string(rng, max_len, WIDE_ALPHABET),
                    _rand_string(rng, max_len, WIDE_ALPHABET)))
        a = out[-1][0]
        out.append((a, a[:-1] + "\udc00" if a else "\x00"))
    return out


def _resolve_again():
    native.reset()
    C._NATIVE = C._UNRESOLVED


@pytest.fixture
def python_paths(monkeypatch):
    """Run a callable on the Python / numpy paths (``DUKE_TPU_NATIVE=0``)
    and come back to the library."""

    def run(fn, *args, **kwargs):
        monkeypatch.setenv("DUKE_TPU_NATIVE", "0")
        _resolve_again()
        try:
            assert not native.available() and C._native_module() is None
            return fn(*args, **kwargs)
        finally:
            monkeypatch.delenv("DUKE_TPU_NATIVE")
            _resolve_again()

    yield run
    _resolve_again()


def _compare_all(comparator, pairs):
    return [comparator.compare(a, b) for a, b in pairs]


# -- the library against the port's Python paths (tests/test_native.py) -----


def test_levenshtein_parity(python_paths):
    pairs = _pairs()
    expected = python_paths(_compare_all, C.Levenshtein(), pairs)
    assert _compare_all(C.Levenshtein(), pairs) == expected
    got = native.lev_sim_batch([a for a, _ in pairs], [b for _, b in pairs])
    assert got.tolist() == expected


def test_jaro_winkler_parity(python_paths):
    pairs = _pairs(seed=11) + _wide_pairs(12)
    expected = python_paths(_compare_all, C.JaroWinkler(), pairs)
    assert _compare_all(C.JaroWinkler(), pairs) == expected
    # the batch form takes codepoints (no surrogate-pair expansion)
    bmp = _pairs(seed=11)
    got = native.jaro_winkler_batch([a for a, _ in bmp], [b for _, b in bmp])
    assert got.tolist() == expected[:len(bmp)]


def test_jaro_winkler_custom_params_parity(python_paths):
    jw = C.JaroWinkler()
    jw.prefix_scale = 0.2
    jw.boost_threshold = 0.5
    jw.max_prefix = 2
    pairs = _pairs(seed=13, n=100, max_len=30)
    expected = python_paths(_compare_all, jw, pairs)
    for (a, b), e in zip(pairs, expected):
        g = float(native.jaro_winkler_batch(
            [a], [b], prefix_scale=0.2, boost_threshold=0.5,
            max_prefix=2)[0])
        assert jw.compare(a, b) == e
        assert g == e, (a, b, e, g)


def test_weighted_levenshtein_parity_ascii(python_paths):
    wl = C.WeightedLevenshtein()
    rng = random.Random(17)
    ascii_alphabet = "abc XY12345-#"
    pairs = [(_rand_string(rng, 40, ascii_alphabet),
              _rand_string(rng, 40, ascii_alphabet)) for _ in range(200)]
    # non-ASCII values stay on the Python path by design
    pairs += _wide_pairs(18, n=20)
    expected = python_paths(_compare_all, wl, pairs)
    assert _compare_all(wl, pairs) == expected
    got = native.weighted_lev_batch([a for a, _ in pairs[:200]],
                                    [b for _, b in pairs[:200]])
    assert got.tolist() == expected[:200]


def test_native_dispatch_used_by_comparators():
    """With the library on, the comparator classes route through it."""
    assert C._native_module() is native
    lev = C.Levenshtein()
    assert lev.compare("jonathan smithe", "jonathan smith") == pytest.approx(
        1.0 - 1.0 / 14.0, abs=1e-12)
    jw = C.JaroWinkler()
    assert jw.compare("martha", "marhta") == pytest.approx(0.9611111111,
                                                           abs=1e-9)


def test_lev_distance_exact():
    assert native.lev_distance("kitten", "sitting") == 3
    assert native.lev_distance("", "abc") == 3
    assert native.lev_distance("a" * 80, "a" * 79 + "b") == 1


def test_native_handles_lone_surrogates(python_paths):
    """json.loads accepts lone surrogates; the library scores them as the
    Python path does instead of raising (utf-32 surrogatepass)."""
    s1, s2 = "\ud800abc", "xabc"
    lev, jw = C.Levenshtein(), C.JaroWinkler()
    want_lev, want_jw = python_paths(
        lambda: (lev.compare(s1, s2), jw.compare(s1, s2)))
    assert lev.compare(s1, s2) == want_lev
    assert jw.compare(s1, s2) == want_jw
    assert native.lev_sim(s1, s2) == want_lev


def _encoder_records():
    from sesam_duke_microservice_tpu_torch.core.records import (
        ID_PROPERTY_NAME,
        Record,
    )

    rng = random.Random(9)
    records = []
    for i in range(120):
        r = Record()
        r.add_value(ID_PROPERTY_NAME, f"r{i}")
        r.add_value("name", _rand_string(rng, 30))
        r.add_value("city", rng.choice(["oslo", "bergen", "tromsø", ""]))
        records.append(r)
    records[0].set_values("name", ["åse blåbærsyltetøy 中文"])
    records[1].set_values("name", [""])
    records[2].set_values("name", [WIDE[:40], "😀 x", "\ud800"])
    return records


class _Schema:
    def __init__(self, names):
        self._names = names

    def comparison_properties(self):
        return [type("P", (), {"name": n}) for n in self._names]


def test_embed_batch_matches_numpy_oracle(python_paths):
    enc = TH.RecordEncoder(_Schema(["name", "city"]), 128)
    records = _encoder_records()
    nat = enc.encode_batch(records)
    ref = python_paths(enc.encode_batch, records)
    np.testing.assert_allclose(nat, ref, rtol=0, atol=TH.NATIVE_EMBED_ATOL)
    assert not np.array_equal(nat, np.zeros_like(nat))


# -- hashing and q-gram sets against the numpy / Python paths ----------------


def _values(seed, n=400):
    rng = random.Random(seed)
    out = ["", "a", "x" * 5000, WIDE, "\ud800", "\x00\x00", "😀😀😀"]
    out += [_rand_string(rng, 60, WIDE_ALPHABET) for _ in range(n // 2)]
    out += [_rand_string(rng, 60) for _ in range(n // 2)]
    return out


def test_fnv1a64_batch_exact(python_paths):
    values = _values(21)
    want = python_paths(TF.fnv1a64_batch, values)
    got = TF.fnv1a64_batch(values)
    np.testing.assert_array_equal(got, want)
    assert [TF.fnv1a64(v) for v in values[:50]] == got[:50].tolist()


@pytest.mark.parametrize("q", [1, 2, 3])
def test_gram_set_extraction_exact(q, python_paths):
    spec = TF.PropertyFeatureSpec(
        name="p", kind=TF.GRAM_SET, low=0.3, high=0.9,
        comparator=type("QG", (), {"q": q})(), values_per_record=2)
    values = _values(22 + q, n=200)
    per_record = [[v for v in (values[i], values[-1 - i]) if v]
                  for i in range(len(values))]
    want = python_paths(TF.extract_property, spec, per_record)
    got = TF.extract_property(spec, per_record)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# -- the port's library against the JAX package's, bit for bit ---------------


def test_all_entry_points_bit_identical_to_jax_library():
    assert native.available() and jnative.available()
    pairs = _pairs(seed=31, n=150) + _wide_pairs(32)
    a = [p[0] for p in pairs]
    b = [p[1] for p in pairs]
    for x, y in pairs:
        assert native.lev_sim(x, y) == jnative.lev_sim(x, y)
        assert native.jaro_winkler(x, y) == jnative.jaro_winkler(x, y)
        assert (native.jaro_winkler(x, y, 0.2, 0.5, 2)
                == jnative.jaro_winkler(x, y, 0.2, 0.5, 2))
        assert native.weighted_lev(x, y) == jnative.weighted_lev(x, y)
        assert (native.weighted_lev(x, y, 3.0, 0.5, 1.5)
                == jnative.weighted_lev(x, y, 3.0, 0.5, 1.5))
        assert native.lev_distance(x, y) == jnative.lev_distance(x, y)
    for fn in ("lev_sim_batch", "jaro_winkler_batch", "weighted_lev_batch"):
        got, want = getattr(native, fn)(a, b), getattr(jnative, fn)(a, b)
        np.testing.assert_array_equal(got.view(np.uint64),
                                      want.view(np.uint64), err_msg=fn)

    values = _values(33)
    bufs = [v.encode("utf-8", "surrogatepass") for v in values]
    np.testing.assert_array_equal(native.fnv1a64_bytes_batch(bufs),
                                  jnative.fnv1a64_bytes_batch(bufs))
    for q, width in ((1, 8), (2, 24), (3, 64)):
        got = native.gram_set_batch(values, q, width, int(TF.SET_PAD))
        want = jnative.gram_set_batch(values, q, width, int(TF.SET_PAD))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])

    strings = [f" {v.lower()} " for v in values]
    salts = np.array([TH._salt(f"p{i % 3}") for i in range(len(strings))],
                     dtype=np.uint64)
    rec_off = np.array([0, 0, 3, 50, 51, len(strings)], dtype=np.int64)
    for dim in (64, 256):
        got = native.embed_batch(strings, salts, rec_off, dim)
        want = jnative.embed_batch(strings, salts, rec_off, dim)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_comparators_bit_identical_to_jax_comparators():
    """The comparator classes of both packages, each on its library."""
    assert JC._native_module() is not None
    pairs = _pairs(seed=41, n=100) + _wide_pairs(42, n=40)
    for cls in ("Levenshtein", "JaroWinkler", "WeightedLevenshtein"):
        mine, theirs = getattr(C, cls)(), getattr(JC, cls)()
        assert _compare_all(mine, pairs) == _compare_all(theirs, pairs), cls


def test_record_embeddings_bit_identical_to_jax_library():
    assert JE._native_embed() is not None and TH._native_embed() is not None
    records = _encoder_records()
    got = TH.RecordEncoder(_Schema(["name", "city"]), 128).encode_batch(
        records)
    salts_j = JE._salt("name"), JE._salt("city")
    assert salts_j == (TH._salt("name"), TH._salt("city"))
    strings, salts, rec_off = [], [], [0]
    for r in records:
        for name in ("name", "city"):
            for v in r.get_values(name):
                strings.append(f" {v.lower()} ")
                salts.append(JE._salt(name))
        rec_off.append(len(strings))
    want = jnative.embed_batch(strings, np.asarray(salts, dtype=np.uint64),
                               np.asarray(rec_off, dtype=np.int64), 128)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- the policy: no quiet fallback, one explicit switch -----------------------


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and a compiler that fails."""
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'fatal: the test compiler refuses' >&2\n"
                   "exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_CXX", str(cxx))
    _resolve_again()
    yield
    _resolve_again()


def test_failed_build_raises_instead_of_falling_back(fresh_build,
                                                     monkeypatch):
    monkeypatch.setenv("DUKE_TPU_NATIVE", "1")
    for call in (native.available,
                 lambda: C.Levenshtein().compare("kitten", "sitten"),
                 lambda: C.JaroWinkler().compare("martha", "marhta"),
                 lambda: TF.fnv1a64_batch(["oslo"]),
                 lambda: TH._native_embed()):
        with pytest.raises(RuntimeError, match="the test compiler refuses"):
            call()
    assert not native.library_path().exists()


def test_knob_off_selects_python_without_building(fresh_build, monkeypatch):
    monkeypatch.setenv("DUKE_TPU_NATIVE", "0")
    assert native.available() is False
    assert C._native_module() is None
    assert TH._native_embed() is None
    assert C.Levenshtein().compare("kitten", "sitten") == 1.0 - 1.0 / 6.0
    assert TF.fnv1a64_batch(["oslo"])[0] == TF.fnv1a64("oslo")
    assert not native.library_path().exists()
