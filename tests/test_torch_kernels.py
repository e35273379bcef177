"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU every wrapper in ``cuda_kernels`` runs its plain PyTorch
version; each must equal its Pallas kernel (interpret mode, as
tests/test_pallas.py runs it): Myers distances (one-word and N-word
widths), gathered Myers distances and set-intersection counts exactly,
Jaro-Winkler similarities within the reference's CHARS similarity budget
(XLA on the CPU may contract the boost into a fused multiply-add).  Inputs
carry empty strings and sets, full-width rows, SET_PAD and garbage padding,
and Q / C / K that are multiples of no tile; the Myers and gathered
Myers distances also every wide UTF-16 alphabet of tests/wide_units.py,
and the intersection counts its id-set kinds (hashed, shared low bits,
SET_PAD and INT32_MIN inside n, full, identical, colliding).  The CUDA kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sesam_duke_microservice_tpu.ops import pallas_kernels as pk
from sesam_duke_microservice_tpu.ops import scoring as jax_scoring
from sesam_duke_microservice_tpu.ops.features import CHARS, SET_PAD
from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
from wide_units import set_kind_inputs, wide_unit_inputs

SIM_TOL = jax_scoring._SIM_ERROR_BOUND[CHARS]


def _inputs(seed: int, q: int, c: int, l: int):
    """Small-alphabet chars (real matches), random lengths with the edge
    cases forced in: empty patterns/texts and full-width strings."""
    rng = np.random.default_rng(seed)
    qc = rng.integers(97, 101, size=(q, l)).astype(np.int32)
    cc = rng.integers(97, 101, size=(c, l)).astype(np.int32)
    ql = rng.integers(0, l + 1, size=q).astype(np.int32)
    cl = rng.integers(0, l + 1, size=c).astype(np.int32)
    ql[:3] = [0, l, 1]
    cl[:3] = [l, 0, l]
    # a full-width pair of identical strings
    cc[2] = qc[1]
    for chars, lens in ((qc, ql), (cc, cl)):
        for i, n in enumerate(lens):
            chars[i, n:] = 0
    return qc, ql, cc, cl


def _jax_distances(qc, ql, cc, cl):
    return np.asarray(pk.myers_distance_tiles(
        jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(cc), jnp.asarray(cl),
        interpret=True))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# the small alphabet at every kernel width, then every kind of wide
# alphabet (tests/wide_units.py) at the widths of W = 1, 2, 4 and 8: the
# card tests hold the kernel's table lookup against this plain version
@pytest.mark.parametrize(
    "l,alphabet",
    [(l, "abcd") for l in (8, 24, 32, 64, 256)]
    + [(l, "all") for l in (32, 64, 128, 256)],
    ids=["8", "24", "32", "64", "256"]
    + [f"wide-{l}" for l in (32, 64, 128, 256)])
def test_plain_myers_equals_pallas_kernel(l, alphabet):
    if alphabet == "all":
        qc, ql, cc, cl = wide_unit_inputs("all", l, 15, 23, l)
    else:
        qc, ql, cc, cl = _inputs(l, 11, 19, l)
    want = _jax_distances(qc, ql, cc, cl)
    got = ck.myers_distance_tiles(*_torch(qc, ql, cc, cl)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("l", [32, 64])
def test_levenshtein_sim_tiles_matches_pallas_path(l):
    qc, ql, cc, cl = _inputs(100 + l, 9, 14, l)
    rng = np.random.default_rng(l)
    equal = rng.random((9, 14)) < 0.1
    want = np.asarray(pk.levenshtein_sim_tiles(
        jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(cc), jnp.asarray(cl),
        jnp.asarray(equal), interpret=True))
    got = ck.levenshtein_sim_tiles(
        *_torch(qc, ql, cc, cl), torch.from_numpy(equal)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SIM_TOL)


def test_kernel_words_cover_widths():
    assert [ck.kernel_words(l) for l in (1, 24, 32, 33, 64, 96, 128, 192,
                                          256)] == [1, 1, 1, 2, 2, 4, 4, 8, 8]


def test_wrapper_rejects_bad_operands():
    qc, ql, cc, cl = _torch(*_inputs(0, 4, 4, 8))
    wide = torch.zeros((4, 257), dtype=torch.int32)
    with pytest.raises(ValueError, match="L <= 256"):
        ck.myers_distance_tiles(wide, ql, wide, cl)
    with pytest.raises(TypeError, match="int32"):
        ck.myers_distance_tiles(qc.long(), ql, cc, cl)
    with pytest.raises(ValueError, match="contiguous"):
        ck.myers_distance_tiles(qc.t().contiguous().t(), ql, cc, cl)
    with pytest.raises(ValueError, match="width"):
        ck.myers_distance_tiles(qc, ql, cc[:, :4].contiguous(), cl)


def test_cpu_path_counts_no_launch():
    ck.reset_launch_counts()
    qc, ql, cc, cl = _torch(*_inputs(1, 3, 5, 32))
    ck.myers_distance_tiles(qc, ql, cc, cl)
    ck.jaro_winkler_sim_tiles(qc, ql, cc, cl,
                              torch.zeros((3, 5), dtype=torch.bool))
    ck.myers_distance_gathered(qc, ql, cc[None].expand(3, 5, 32).contiguous(),
                               cl[None].expand(3, 5).contiguous())
    ck.set_intersection_tiles(qc, ql, cc, cl)
    emb = torch.ones((8, 128), dtype=torch.bfloat16)
    rows = torch.zeros((8,), dtype=torch.int32)
    ck.retrieval_segmax(emb[:3], emb, rows.bool(), rows.bool(), rows,
                        rows[:3], rows[:3], tc=8, seg=2,
                        group_filtering=False)
    assert ck.LAUNCHES == {"myers_tile": 0, "myersN_tile": 0, "jw_tile": 0,
                           "myers_gathered": 0, "intersect_tile": 0,
                           "retrieval_segmax": 0}


# the Pallas JW kernel unrolls O(L^2) compares statically: interpret mode
# compiles for about a minute at L=32, so the widest case here is 16 and
# tests/test_torch_pairwise.py holds the 32-char flat path to the JAX one
@pytest.mark.parametrize("l", [1, 8, 16])
def test_plain_jw_equals_pallas_kernel(l):
    qc, ql, cc, cl = _inputs(200 + l, 9, 13, l)
    equal = np.random.default_rng(l).random((9, 13)) < 0.1
    kw = dict(prefix_scale=0.1, boost_threshold=0.7, max_prefix=4)
    want = np.asarray(pk.jaro_winkler_sim_tiles(
        jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(cc), jnp.asarray(cl),
        jnp.asarray(equal), interpret=True, **kw))
    got = ck.jaro_winkler_sim_tiles(*_torch(qc, ql, cc, cl),
                                    torch.from_numpy(equal), **kw).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=SIM_TOL)
    assert (got[~equal] < 1.0).any() and (got[~equal] > 0.0).any()


# the small alphabet, then every wide UTF-16 alphabet of
# tests/wide_units.py (the card tests hold the kernel's table lookup, side
# list included, against this plain version); every query also gets an
# empty and a full-width candidate
@pytest.mark.parametrize("l,k,alphabet", [
    pytest.param(1, 5, "abcd", id="1-5"),
    pytest.param(24, 37, "abcd", id="24-37"),
    pytest.param(32, 130, "abcd", id="32-130"),
    pytest.param(24, 64, "all", id="wide-24-64"),
    pytest.param(32, 130, "all", id="wide-32-130"),
])
def test_plain_gathered_myers_equals_pallas_kernel(l, k, alphabet):
    if alphabet == "all":
        qc, ql, pool, pool_len = wide_unit_inputs("all", 300 + l, 7, 50, l)
    else:
        qc, ql, pool, pool_len = _inputs(300 + l, 7, 50, l)
    rng = np.random.default_rng(l)
    rows = rng.integers(0, 50, size=(7, k))
    if alphabet == "all":
        rows[:, :2] = [1, 0]              # an empty and a full-width text
    cc = pool[rows]                       # (Q, K, L): candidate k of q
    cl = pool_len[rows]
    want = np.asarray(pk.myers_distance_gathered(
        jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(cc), jnp.asarray(cl),
        interpret=True))
    got = ck.myers_distance_gathered(*_torch(qc, ql, cc, cl)).numpy()
    np.testing.assert_array_equal(got, want)


def _sets(seed, rows, g, *, garbage=False):
    """Sorted distinct ids from a small range (so sets intersect), counts
    from 0 to g with the empty and full sets forced in; the padding is
    SET_PAD, or random ids past each row's count."""
    rng = np.random.default_rng(seed)
    ids = np.full((rows, g), SET_PAD, dtype=np.int32)
    n = rng.integers(0, g + 1, size=rows).astype(np.int32)
    n[:2] = [0, g]
    for i in range(rows):
        ids[i, :n[i]] = np.sort(rng.choice(np.arange(-2 * g, 2 * g),
                                           size=n[i], replace=False))
        if garbage:
            ids[i, n[i]:] = rng.integers(-2 * g, 2 * g, size=g - n[i])
    return ids, n


# small-range sorted sets (SET_PAD or garbage after), then the kinds of
# tests/wide_units.py that would catch a mistake in the CUDA kernel's hash
# tables: full-range hashed ids, ids sharing their low 10 bits, SET_PAD /
# 0x80000000 / 0 / -1 inside n, full rows at G = 256, identical rows at
# every size, ids that all share one home slot
@pytest.mark.parametrize("g,garbage,kind", [
    pytest.param(16, False, None, id="16-False"),
    pytest.param(64, False, None, id="64-False"),
    pytest.param(64, True, None, id="64-True"),
    pytest.param(256, False, None, id="256-False"),
] + [pytest.param(g, False, kind, id=f"{kind}-{g}")
     for kind, g in (("hashed", 16), ("hashed", 64), ("low10", 64),
                     ("edge", 16), ("edge", 64), ("full", 256),
                     ("identical", 64), ("collide", 64))])
def test_plain_intersection_equals_pallas_kernel(g, garbage, kind):
    if kind is not None:
        qg, qn = set_kind_inputs(kind, g, 5, g)
        cg, cn = set_kind_inputs(kind, g + 1, 11, g, copies_of=(
            (qg, qn) if kind == "identical" else None))
    else:
        qg, qn = _sets(g, 5, g, garbage=garbage)
        cg, cn = _sets(g + 1, 11, g, garbage=garbage)
    cg[3], cn[3] = qg[1], qn[1]           # a full-width identical pair
    want = np.asarray(pk.set_intersection_tiles(
        jnp.asarray(qg), jnp.asarray(qn), jnp.asarray(cg), jnp.asarray(cn),
        interpret=True))
    got = ck.set_intersection_tiles(*_torch(qg, qn, cg, cn)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[1, 3] == g and (want > 0).sum() > 5


@pytest.mark.parametrize("formula", ["overlap", "jaccard", "dice"])
def test_set_sim_tiles_matches_pallas_path(formula):
    qg, qn = _sets(7, 6, 16)
    cg, cn = _sets(8, 9, 16)
    equal = np.random.default_rng(3).random((6, 9)) < 0.1
    want = np.asarray(pk.set_sim_tiles(
        jnp.asarray(qg), jnp.asarray(qn), jnp.asarray(cg), jnp.asarray(cn),
        jnp.asarray(equal), formula=formula, interpret=True))
    got = ck.set_sim_tiles(*_torch(qg, qn, cg, cn), torch.from_numpy(equal),
                           formula=formula).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SIM_TOL)


def test_new_wrappers_reject_bad_operands():
    qc, ql, cc, cl = _torch(*_inputs(0, 4, 4, 8))
    eq = torch.zeros((4, 4), dtype=torch.bool)
    wide = torch.zeros((4, 33), dtype=torch.int32)
    with pytest.raises(ValueError, match="L <= 32"):
        ck.jaro_winkler_sim_tiles(wide, ql, wide, cl, eq)
    with pytest.raises(TypeError, match="int32"):
        ck.jaro_winkler_sim_tiles(qc.long(), ql, cc, cl, eq)
    with pytest.raises(ValueError, match=r"\(Q, K, L\)"):
        ck.myers_distance_gathered(qc, ql, cc, cl)
    with pytest.raises(ValueError, match="match queries"):
        ck.myers_distance_gathered(qc, ql, cc[None].expand(3, 4, 8)
                                   .contiguous(), cl[None].expand(3, 4)
                                   .contiguous())
    with pytest.raises(ValueError, match="L <= 256"):
        big = torch.zeros((4, 257), dtype=torch.int32)
        ck.set_intersection_tiles(big, ql, big, cl)
    with pytest.raises(ValueError, match="contiguous"):
        ck.set_intersection_tiles(qc.t().contiguous().t(), ql, cc, cl)
