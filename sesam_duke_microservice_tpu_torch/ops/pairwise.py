"""Batched pairwise similarity functions in PyTorch.

Counterpart of the JAX package's ``ops/pairwise.py`` for the comparator
kinds this port scores on the device: Levenshtein (bit-parallel Myers for
patterns of at most 32 chars, the min-plus scan DP beyond), exact /
different, and numeric.  Each function maps a flat batch of P value pairs
to similarities in [0, 1] with the scalar semantics of ``core.comparators``
and the float32 arithmetic of the JAX functions, operation for operation.

The bit-parallel state rides ``int64`` masked to 32 bits: PyTorch's CPU
``uint32`` has no add, shifts, ``~`` or ordering comparisons.
"""

from __future__ import annotations

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
