"""The Jaro-Winkler tile kernel's matching order, modelled on the CPU.

``csrc/jw_tile.cu`` matches by walking the corpus text, not the query:
for each text position j in order it takes the lowest unmatched query
position inside the window [j - w, j + w] that holds t[j], from a table of
the query's first l1 units.  The reference walks the query and takes the
lowest unmatched text position.  A plain numpy model of each walk, run
pair by pair, must give the same matched-position masks m1 (query) and m2
(text); the text walk's matches, transpositions and f32 similarity (the
kernel's float tail, one IEEE operation at a time) must equal the port's
plain ``pairwise.jaro_counts`` / ``jaro_winkler_sim`` bit for bit, and the
JAX package's Pallas kernel (interpret mode, L <= 16 as
tests/test_torch_kernels.py states) within the reference's similarity
budget.  Inputs: thousands of seeded pairs over two- and three-letter
alphabets with long runs, the length extremes 0, 1, 31 and 32 against each
other, real U+0000s inside the length, and every wide UTF-16 alphabet of
tests/wide_units.py.
"""

import itertools
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sesam_duke_microservice_tpu.ops import pallas_kernels as pk
from sesam_duke_microservice_tpu.ops import scoring as jax_scoring
from sesam_duke_microservice_tpu.ops.features import CHARS
from sesam_duke_microservice_tpu_torch.ops import pairwise as pw
from wide_units import KINDS, wide_unit_inputs

SIM_TOL = jax_scoring._SIM_ERROR_BOUND[CHARS]
KW = dict(prefix_scale=0.1, boost_threshold=0.7, max_prefix=4)
F32 = np.float32


def _window(l1, l2):
    return max(max(l1, l2) // 2 - 1, 0)


def query_walk(q, l1, t, l2):
    """The reference order: each query char in turn takes the lowest
    unmatched equal text position inside its window."""
    w = _window(l1, l2)
    m1 = m2 = 0
    for i in range(l1):
        for j in range(max(i - w, 0), min(l2, i + w + 1)):
            if not m2 >> j & 1 and t[j] == q[i]:
                m1 |= 1 << i
                m2 |= 1 << j
                break
    return m1, m2


def text_walk(q, l1, t, l2):
    """The kernel's order: a table of the query's first l1 units (position
    masks), a window mask sliding with one shift and one or, and per text
    position the lowest available bit."""
    table = {}
    for i in range(l1):
        table[int(q[i])] = table.get(int(q[i]), 0) | 1 << i
    w = _window(l1, l2)
    win = (1 << min(w + 1, 32)) - 1                # query positions [0, w]
    m1 = m2 = 0
    for j in range(l2):
        avail = table.get(int(t[j]), 0) & win & ~m1
        low = avail & -avail
        m1 |= low
        if low:
            m2 |= 1 << j
        win = ((win << 1) | (j < w)) & 0xFFFFFFFF
    return m1, m2


def _bits(mask):
    return [k for k in range(32) if mask >> k & 1]


def kernel_tail(q, l1, t, l2, m1, m2):
    """(matches, half transpositions, similarity) as the kernel computes
    them from its masks: the lowest-bit-first walk of both masks, the
    common prefix and the float tail in the JAX order, each operation
    rounded to f32."""
    trans = sum(q[i] != t[j] for i, j in zip(_bits(m1), _bits(m2)))
    kmax = min(len(q), KW["max_prefix"], l1, l2)
    prefix = 0
    while prefix < kmax and q[prefix] == t[prefix]:
        prefix += 1
    matches = bin(m1).count("1")
    jaro = F32(0.0)
    if matches and l1 and l2:
        m = F32(matches)
        total = (m / F32(max(l1, 1)) + m / F32(max(l2, 1))) \
            + (m - F32(trans // 2)) / F32(max(matches, 1))
        jaro = total / F32(3.0)
    boosted = jaro + (F32(prefix) * F32(KW["prefix_scale"])) \
        * (F32(1.0) - jaro)
    sim = jaro if jaro < F32(KW["boost_threshold"]) else boosted
    return matches, trans // 2, F32(sim)


def _runs(rng, pairs, l, alphabet):
    """Rows built from runs of 1-6 copies of one letter of ``alphabet``;
    random lengths 0..l."""
    rows = np.zeros((2 * pairs, l), dtype=np.int32)
    for r in range(2 * pairs):
        units = []
        while len(units) < l:
            units += [alphabet[rng.integers(len(alphabet))]] \
                * int(rng.integers(1, 7))
        rows[r] = units[:l]
    lens = rng.integers(0, l + 1, size=2 * pairs).astype(np.int32)
    return rows[:pairs], lens[:pairs], rows[pairs:], lens[pairs:]


def _extremes(rng, l=32):
    """Every pair of the lengths 0, 1, 31 and 32 (l1 != l2 included), 40
    random three-letter strings each."""
    ends = (0, 1, l - 1, l)
    combos = [(a, b) for a, b in itertools.product(ends, ends)
              for _ in range(40)]
    qc = rng.integers(97, 100, size=(len(combos), l)).astype(np.int32)
    cc = rng.integers(97, 100, size=(len(combos), l)).astype(np.int32)
    ql = np.array([a for a, _ in combos], dtype=np.int32)
    cl = np.array([b for _, b in combos], dtype=np.int32)
    return qc, ql, cc, cl


def _pairs(case):
    """(qchars, qlen, cchars, clen) int32 arrays of flat pairs, 0-padded."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case == "runs2":
        qc, ql, cc, cl = _runs(rng, 3000, 32, (97, 98))
    elif case == "runs3":
        qc, ql, cc, cl = _runs(rng, 3000, 32, (97, 98, 99))
    elif case == "runs3_short":
        qc, ql, cc, cl = _runs(rng, 3000, 8, (97, 98, 99))
    elif case == "extremes":
        qc, ql, cc, cl = _extremes(rng)
    elif case == "nul":
        # real U+0000 inside the length, beside the 0 padding
        qc, ql, cc, cl = _runs(rng, 2000, 32, (0, 97, 98))
    else:
        qc, ql, cc, cl = wide_unit_inputs(case, 3, 60, 60, 32)
        # every query against every corpus row, as flat pairs
        qc, ql = np.repeat(qc, 60, axis=0), np.repeat(ql, 60)
        cc, cl = np.tile(cc, (60, 1)), np.tile(cl, 60)
    for chars, lens in ((qc, ql), (cc, cl)):
        for i, n in enumerate(lens):
            chars[i, n:] = 0
    return qc, ql, cc, cl


@pytest.mark.parametrize("case", ["runs2", "runs3", "runs3_short",
                                  "extremes", "nul", *KINDS])
def test_text_walk_equals_reference_walk(case):
    qc, ql, cc, cl = _pairs(case)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (qc, ql, cc, cl)]
    want_m, want_t = (x.numpy() for x in pw.jaro_counts(*t))
    want_sim = pw.jaro_winkler_sim(
        *t, torch.zeros(len(ql), dtype=torch.bool), **KW).numpy()
    got_sim = np.empty(len(ql), dtype=np.float32)
    for p in range(len(ql)):
        args = (qc[p], int(ql[p]), cc[p], int(cl[p]))
        m1, m2 = text_walk(*args)
        assert (m1, m2) == query_walk(*args), (case, p)
        matches, half, got_sim[p] = kernel_tail(*args, m1, m2)
        assert (matches, half) == (want_m[p], want_t[p]), (case, p)
    np.testing.assert_array_equal(got_sim.view(np.int32),
                                  want_sim.view(np.int32))
    # the inputs reach both sides of the boost and real transpositions
    assert (want_t > 0).any() and (want_sim > KW["boost_threshold"]).any()


@pytest.mark.parametrize("l,alphabet", [(16, (97, 98)), (16, (0, 97, 98)),
                                        (8, (0x41, 0x141, 0x4141))])
def test_text_walk_equals_pallas_kernel(l, alphabet):
    rng = np.random.default_rng(l + len(alphabet))
    qc, ql, cc, cl = _runs(rng, 24, l, alphabet)
    cc, cl = cc[:20], cl[:20]
    ql[:2], cl[:2] = [0, l], [l, 0]
    for chars, lens in ((qc, ql), (cc, cl)):
        for i, n in enumerate(lens):
            chars[i, n:] = 0
    equal = np.zeros((len(ql), len(cl)), dtype=bool)
    want = np.asarray(pk.jaro_winkler_sim_tiles(
        jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(cc), jnp.asarray(cl),
        jnp.asarray(equal), interpret=True, **KW))
    got = np.array([[kernel_tail(qc[a], int(ql[a]), cc[b], int(cl[b]),
                                 *text_walk(qc[a], int(ql[a]), cc[b],
                                            int(cl[b])))[2]
                     for b in range(len(cl))] for a in range(len(ql))])
    np.testing.assert_allclose(got, want, rtol=0, atol=SIM_TOL)
    assert (got > 0.0).any() and (got < 1.0).any()
