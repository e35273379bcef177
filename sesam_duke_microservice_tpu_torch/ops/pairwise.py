"""Batched pairwise similarity functions in PyTorch.

Counterpart of the JAX package's ``ops/pairwise.py``: Levenshtein
(bit-parallel Myers for patterns of at most 32 chars, the min-plus scan DP
beyond), weighted Levenshtein, Jaro-Winkler, q-gram / token-set overlap,
exact / different, phonetic, numeric and geoposition.  Each function maps
a flat batch of P value pairs to similarities in [0, 1] with the scalar
semantics of ``core.comparators`` and the float32 arithmetic of the JAX
functions, operation for operation.  These are the flat paths: the scan
takes the hand-written tile kernels (``ops.cuda_kernels``) where a kernel
covers the width, and the dd rescorer takes the integer counts from here.

The bit-parallel state rides ``int64`` masked to 32 bits: PyTorch's CPU
``uint32`` has no add, shifts, ``~`` or ordering comparisons.  Every
division by a constant divides by a tensor: PyTorch's CUDA kernel turns
division by a Python scalar into a multiplication by its reciprocal, which
rounds differently.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


# -- edit distance -----------------------------------------------------------


def levenshtein_distance_myers(c1, l1, c2, l2):
    """Batched Levenshtein distance via Myers' bit-parallel algorithm
    (mirrors ``pairwise.levenshtein_distance_myers``).

    Pattern = c1 (one bit per char, so L <= 32), text = c2; the score
    tracks cell (l1, i) and finishes at i = l2.  c1, c2: (P, L) integer
    codepoints (0-padded); l1, l2: (P,) lengths.  Returns (P,) int32.
    """
    p, l = c1.shape
    if l > 32:
        raise ValueError(f"Myers kernel needs L <= 32, got {l}")
    c1 = c1.long()
    c2 = c2.long()
    l1 = l1.long()
    l2 = l2.long()
    # bit j set iff j < l1 (int64 shifts: no undefined << 32)
    pv = (1 << l1.clamp(0, 32)) - 1
    hibit = 1 << (l1.clamp_min(1) - 1)
    mv = torch.zeros_like(pv)
    score = l1.clone()
    weights = 1 << torch.arange(l, dtype=torch.int64, device=c1.device)
    for i in range(l):
        # disjoint bits: the weighted sum is the OR
        eq = ((c1 == c2[:, i:i + 1]).long() * weights).sum(dim=1)
        xv = eq | mv
        xh = ((((eq & pv) + pv) & MASK32) ^ pv) | eq
        ph = mv | (~(xh | pv) & MASK32)
        mh = pv & xh
        active = i < l2
        score = score + (active & ((ph & hibit) != 0)).long()
        score = score - (active & ((mh & hibit) != 0)).long()
        ph = ((ph << 1) & MASK32) | 1
        mh = (mh << 1) & MASK32
        pv = torch.where(active, mh | (~(xv | ph) & MASK32), pv)
        mv = torch.where(active, ph & xv, mv)
    # empty pattern: distance is the text length
    return torch.where(l1 == 0, l2, score).to(torch.int32)


def levenshtein_distance(c1, l1, c2, l2):
    """Batched Levenshtein distance by the min-plus scan DP (mirrors
    ``pairwise.levenshtein_distance``): each DP row is
    ``cur[j] = j + cummin(m[k] - k)[j]`` over the column axis.

    c1, c2: (P, L) integer codepoints (0-padded); l1, l2: (P,) lengths.
    Returns (P,) int32 distances d(c1[:l1], c2[:l2]).
    """
    p, l = c1.shape
    l1 = l1.long()
    l2 = l2.long()
    jidx = torch.arange(l + 1, dtype=torch.int64, device=c1.device)
    prev = jidx.expand(p, l + 1)
    result = l2.clone()  # distance when l1 == 0
    for i in range(l):
        cost = (c2 != c1[:, i:i + 1]).long()
        m = torch.minimum(prev[:, 1:] + 1, prev[:, :-1] + cost)
        row0 = torch.full((p, 1), i + 1, dtype=torch.int64, device=c1.device)
        g = torch.cat([row0, m], dim=1) - jidx
        cur = torch.cummin(g, dim=1).values + jidx
        d = cur.gather(1, l2[:, None])[:, 0]
        result = torch.where(l1 == i + 1, d, result)
        prev = cur
    return result.to(torch.int32)


def levenshtein_sim_from_distance(dist, l1, l2, equal):
    """Duke's distance -> similarity map (core.comparators.Levenshtein),
    shared by the flat path and the tiled kernel path; operands broadcast,
    so (P,) and (Q, 1) x (1, C) shapes both work."""
    shorter = torch.minimum(l1, l2)
    longer = torch.maximum(l1, l2)
    dist = torch.minimum(dist, shorter)
    sim = 1.0 - dist.float() / shorter.clamp_min(1).float()
    sim = torch.where((longer - shorter) * 2 > shorter, 0.0, sim)
    sim = torch.where(shorter == 0, 0.0, sim)
    return torch.where(equal, 1.0, sim)


def levenshtein_sim(c1, l1, c2, l2, equal):
    """Duke Levenshtein similarity over flat pairs; ``equal`` is the (P,)
    exact string-equality mask (from value hashes)."""
    if c1.shape[1] <= 32:
        dist = levenshtein_distance_myers(c1, l1, c2, l2)
    else:
        dist = levenshtein_distance(c1, l1, c2, l2)
    return levenshtein_sim_from_distance(dist, l1, l2, equal)


def weighted_levenshtein_sim(c1, k1, l1, c2, k2, l2, equal, *, digit_weight,
                             letter_weight, other_weight):
    """core.comparators.WeightedLevenshtein.compare (mirrors
    ``pairwise.weighted_levenshtein_sim``): the min-plus scan DP with
    per-char weights by class (k1, k2: (P, L) int32, 0 other, 1 letter,
    2 digit)."""
    p, l = c1.shape
    device = c1.device
    l1 = l1.long()
    l2 = l2.long()
    wvec = torch.tensor([other_weight, letter_weight, digit_weight],
                        dtype=torch.float32, device=device)
    w1 = wvec[k1.long()]
    w2 = wvec[k2.long()]
    zeros = torch.zeros((p, 1), dtype=torch.float32, device=device)
    prefix2 = torch.cat([zeros, torch.cumsum(w2, dim=1)], dim=1)  # row 0
    prev = prefix2
    row0 = torch.zeros((p,), dtype=torch.float32, device=device)
    result = prefix2.gather(1, l2[:, None])[:, 0]
    for i in range(l):
        ch = c1[:, i:i + 1]
        wi = w1[:, i:i + 1]
        sub = torch.where(c2 == ch, 0.0, torch.maximum(wi, w2))
        m = torch.minimum(prev[:, 1:] + wi, prev[:, :-1] + sub)
        row0 = row0 + wi[:, 0]
        g = torch.cat([row0[:, None], m], dim=1) - prefix2
        cur = torch.cummin(g, dim=1).values + prefix2
        d = cur.gather(1, l2[:, None])[:, 0]
        result = torch.where(l1 == i + 1, d, result)
        prev = cur
    shorter = torch.minimum(l1, l2).float()
    dist = torch.minimum(result, shorter)
    sim = 1.0 - dist / shorter.clamp_min(1.0)
    sim = torch.where(shorter == 0, 0.0, sim)
    return torch.where(equal, 1.0, sim)


# -- Jaro-Winkler ------------------------------------------------------------


def jaro_counts(c1, l1, c2, l2):
    """The integer core of Jaro (mirrors ``pairwise.jaro_counts``):
    (matches, transpositions) as exact int32 -- greedy matching of each
    pattern char to the lowest unused equal text char inside the window
    ``max(l1, l2) // 2 - 1``, then half the mismatches between the
    matched chars of both sides in order."""
    p, l = c1.shape
    device = c1.device
    c1 = c1.long()
    c2 = c2.long()
    l1 = l1.long()
    l2 = l2.long()
    jidx = torch.arange(l, device=device)
    window = ((torch.maximum(l1, l2) // 2) - 1).clamp_min(0)
    used = torch.zeros((p, l), dtype=torch.bool, device=device)
    nmatch = torch.zeros((p,), dtype=torch.int64, device=device)
    m1 = torch.zeros((p, l), dtype=torch.int64, device=device)
    for i in range(l):
        ch = c1[:, i:i + 1]
        lo = (i - window).clamp_min(0)[:, None]
        hi = torch.minimum(l2, i + window + 1)[:, None]
        ok = ((~used) & (c2 == ch) & (jidx >= lo) & (jidx < hi)
              & (i < l1)[:, None])
        any_ok = ok.any(dim=1)
        first = torch.argmax(ok.to(torch.int32), dim=1)  # first True
        used = used | (ok & (jidx == first[:, None]))
        m1 = torch.where((jidx == nmatch[:, None]) & any_ok[:, None], ch, m1)
        nmatch = nmatch + any_ok.long()
    # the matched text chars in order: scatter c2[j] to its rank (the
    # extra column takes the unmatched positions and is dropped)
    rank = torch.cumsum(used.long(), dim=1) - 1
    pos = torch.where(used, rank, l)
    m2 = torch.zeros((p, l + 1), dtype=torch.int64, device=device)
    m2.scatter_(1, pos, c2)
    diff = (m1 != m2[:, :l]) & (jidx < nmatch[:, None])
    transpositions = diff.sum(dim=1) // 2
    return nmatch.to(torch.int32), transpositions.to(torch.int32)


def _jaro(c1, l1, c2, l2):
    nmatch, transpositions = jaro_counts(c1, l1, c2, l2)
    m = nmatch.float()
    n1 = l1.clamp_min(1).float()
    n2 = l2.clamp_min(1).float()
    jaro = ((m / n1 + m / n2 + (m - transpositions) / m.clamp_min(1.0))
            / torch.full_like(m, 3.0))
    return torch.where((nmatch == 0) | (l1 == 0) | (l2 == 0), 0.0, jaro)


def common_prefix_count(c1, c2, l1, l2, *, max_prefix):
    """Winkler common-prefix length (exact int32, capped at max_prefix)."""
    l = c1.shape[1]
    k = min(int(max_prefix), l)
    kidx = torch.arange(k, device=c1.device)
    both = torch.minimum(l1, l2)[:, None]
    eq = (c1[:, :k] == c2[:, :k]) & (kidx < both)
    return torch.cumprod(eq.to(torch.int32), dim=1).sum(dim=1).to(
        torch.int32)


def winkler_boost(jaro, prefix, *, prefix_scale, boost_threshold):
    """The Winkler boost above ``boost_threshold``, in the JAX order
    ``j + prefix * prefix_scale * (1 - j)`` (constants as float32, like
    the JAX package's weakly typed scalars)."""
    boosted = (jaro + prefix.float() * float(np.float32(prefix_scale))
               * (1.0 - jaro))
    return torch.where(jaro < float(np.float32(boost_threshold)), jaro,
                       boosted)


def jaro_winkler_sim(c1, l1, c2, l2, equal, *, prefix_scale=0.1,
                     boost_threshold=0.7, max_prefix=4):
    """core.comparators.JaroWinkler.compare over flat pairs."""
    j = _jaro(c1, l1, c2, l2)
    prefix = common_prefix_count(c1, c2, l1, l2, max_prefix=max_prefix)
    sim = winkler_boost(j, prefix, prefix_scale=prefix_scale,
                        boost_threshold=boost_threshold)
    return torch.where(equal, 1.0, sim)


# -- sorted-set intersection -------------------------------------------------

# Pair-by-element-by-element work per slice of the dense intersection
# compare: (rows, Sa, Sb) booleans stay under this many elements.
_SET_COMPARE_ELEMENTS = 1 << 26


def set_intersection_count(a, na, b, nb):
    """|set(a[:na]) ∩ set(b[:nb])| for distinct int32 ids (mirrors
    ``pairwise.set_intersection_count``): the dense all-pairs equality
    compare, over row slices that bound the (rows, Sa, Sb) intermediate.
    a: (P, Sa), b: (P, Sb), padded with INT32_MAX."""
    p, sa = a.shape
    sb = b.shape[1]
    device = a.device
    valid_a = torch.arange(sa, device=device) < na[:, None]
    valid_b = torch.arange(sb, device=device) < nb[:, None]
    step = max(1, _SET_COMPARE_ELEMENTS // max(1, sa * sb))
    out = []
    for s in range(0, p, step):
        eq = a[s:s + step, :, None] == b[s:s + step, None, :]
        hits = eq & valid_a[s:s + step, :, None] & valid_b[s:s + step, None, :]
        out.append(hits.sum(dim=(1, 2)))
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=device)
    return torch.cat(out).to(torch.int32)


def sim_from_set_intersection(common, f1, f2, equal, *, formula):
    """|A ∩ B| -> similarity for every set comparator (overlap, jaccard,
    dice), shared by the flat path and the tile kernel's wrapper; operands
    broadcast, so (P,) and (Q, 1) x (1, C) shapes both work."""
    common = common.float()
    f1 = f1.float()
    f2 = f2.float()
    if formula == "jaccard":
        sim = common / (f1 + f2 - common).clamp_min(1.0)
    elif formula == "dice":
        sim = 2.0 * common / (f1 + f2).clamp_min(1.0)
    else:
        sim = common / torch.minimum(f1, f2).clamp_min(1.0)
    sim = torch.where((f1 == 0) | (f2 == 0), 0.0, sim)
    return torch.where(equal, 1.0, sim)


def qgram_sim(g1, n1, g2, n2, equal, *, formula="overlap"):
    """core.comparators.QGram.compare over distinct-gram sets."""
    common = set_intersection_count(g1, n1, g2, n2)
    return sim_from_set_intersection(common, n1, n2, equal, formula=formula)


def token_set_sim(t1, n1, t2, n2, equal, *, dice=False):
    """JaccardIndex (dice=False) / DiceCoefficient (dice=True)."""
    inter = set_intersection_count(t1, n1, t2, n2)
    return sim_from_set_intersection(
        inter, n1, n2, equal, formula="dice" if dice else "jaccard")


# -- scalar comparators ------------------------------------------------------


def exact_sim(equal):
    return equal.float()


def different_sim(equal):
    return (~equal).float()


def numeric_sim(d1, v1, d2, v2, *, min_ratio=0.0):
    """core.comparators.Numeric.compare (no string-equality early exit:
    two equal unparseable strings are neutral 0.5, matching the oracle)."""
    both = v1 & v2
    a1 = d1.abs()
    a2 = d2.abs()
    ratio = torch.minimum(a1, a2) / torch.maximum(a1, a2).clamp_min(1e-38)
    sim = torch.where(ratio < min_ratio, 0.0, ratio)
    zero_or_sign = (d1 == 0.0) | (d2 == 0.0) | ((d1 < 0.0) != (d2 < 0.0))
    sim = torch.where(zero_or_sign, 0.0, sim)
    sim = torch.where(d1 == d2, 1.0, sim)
    return torch.where(both, sim, 0.5)


def phonetic_sim(equal, code_equal, codes_valid):
    """Soundex / Metaphone / Norphone: equal values 1.0, equal non-empty
    codes 0.9."""
    return torch.where(equal, 1.0,
                       torch.where(code_equal & codes_valid, 0.9, 0.0))


_EARTH_RADIUS_M = 6371000.0


def geoposition_sim(lat1, lon1, v1, lat2, lon2, v2, *, max_distance=0.0):
    """core.comparators.Geoposition.compare (haversine over radians)."""
    both = v1 & v2
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = (torch.sin(dlat / 2) ** 2
         + torch.cos(lat1) * torch.cos(lat2) * torch.sin(dlon / 2) ** 2)
    dist = 2.0 * _EARTH_RADIUS_M * torch.arcsin(
        torch.clamp_max(torch.sqrt(a), 1.0))
    if max_distance <= 0:
        sim = torch.where(dist == 0.0, 1.0, 0.0)
    else:
        sim = torch.clamp_min(
            1.0 - dist / torch.full_like(dist, max_distance), 0.0)
    return torch.where(both, sim, 0.5)
