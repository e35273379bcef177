"""Seeded inputs that reach past the easy cases of the port's kernels:
char matrices over wide UTF-16 alphabets, for the match-table lookups of
the Myers and Jaro-Winkler kernels and their plain versions, and id sets
for the set-intersection kernel's hash tables (``set_kind_inputs``).

Each kind reaches a part of the lookup that a small lowercase alphabet
never does: units of 256 and up (the side list), units sharing a low byte
('A' 0x41, 'Ł' 0x141, 0x4141), 0xFFFF and surrogate halves, rows made
only of wide units, patterns with more than 32 distinct units, long runs
of repeated units and real U+0000s inside the length (padding is 0 too).
``"all"`` gives each row the kind of its index, so every pair of kinds
meets.  Every kind forces the edges: empty and full-width patterns and
texts, and an identical full-width pair.
"""

import numpy as np

ALPHABETS = {
    "wide": (0x61, 0x62, 0x20, 0xE6, 0x100, 0x3042, 0x4E2D),
    "low_byte": (0x41, 0x141, 0x4141, 0xFF41, 0x61),
    "surrogates": (0xFFFF, 0xD800, 0xDBFF, 0xDC00, 0xDFFF, 0x61),
    "wide_only": (0x100, 0x141, 0x4141, 0xFFFF, 0xD800),
    "repeats": (0x61, 0x141),
    "nul": (0x0, 0x61, 0x62, 0x141),
    # 64 units below 256 and 64 above: rows of 64 and more chars hold
    # more than 32 distinct units
    "many_distinct": tuple(range(0x21, 0x61)) + tuple(range(0x3000, 0x3040)),
}
KINDS = tuple(ALPHABETS)


def _rows(rng, kinds, l):
    out = np.zeros((len(kinds), l), dtype=np.int32)
    for i, kind in enumerate(kinds):
        alphabet = np.asarray(ALPHABETS[kind], dtype=np.int32)
        if kind == "repeats":
            # runs of one unit, a few units long
            runs = rng.integers(0, len(alphabet), size=l // 4 + 1)
            out[i] = alphabet[np.repeat(runs, 4)[:l]]
        else:
            out[i] = rng.choice(alphabet, size=l)
    return out


def wide_unit_inputs(kind: str, seed: int, q: int, c: int, l: int):
    """(qchars (Q, L), qlen (Q,), cchars (C, L), clen (C,)) int32 numpy
    arrays over ``kind``'s alphabet (``"all"``: row i of kind i mod 7),
    0-padded past each length."""
    rng = np.random.default_rng(seed)

    def kinds(rows):
        if kind == "all":
            return [KINDS[i % len(KINDS)] for i in range(rows)]
        return [kind] * rows

    qc = _rows(rng, kinds(q), l)
    cc = _rows(rng, kinds(c), l)
    ql = rng.integers(0, l + 1, size=q).astype(np.int32)
    cl = rng.integers(0, l + 1, size=c).astype(np.int32)
    ql[:3] = [0, l, 1]
    cl[:3] = [l, 0, l]
    # an identical full-width pair, and a copy with two units changed
    cc[2] = qc[1]
    cc[4], cl[4] = qc[3], ql[3]
    cc[4, : min(2, l)] = qc[1, : min(2, l)]
    for chars, lens in ((qc, ql), (cc, cl)):
        for i, n in enumerate(lens):
            chars[i, n:] = 0
    return qc, ql, cc, cl


# -- id sets for the set-intersection kernel -------------------------------

SET_PAD = 2**31 - 1
SET_KINDS = ("hashed", "low10", "edge", "full", "identical", "collide")
_MUL = 0x9E3779B1                 # csrc/intersect_tile.cu's hash multiplier
_MUL_INV = pow(_MUL, -1, 2**32)


def fold32_fnv1a(word: str) -> int:
    """FNV-1a 64 of the word's UTF-8 bytes folded to a signed 32-bit id,
    as ops.features folds its gram and token hashes: uniform over all 32
    bits."""
    h = 0xCBF29CE484222325
    for b in word.encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    v = (h ^ (h >> 32)) & 0xFFFFFFFF
    return v - 2**32 if v >= 2**31 else v


def _signed(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - 2**32 if v >= 2**31 else v


def set_kind_inputs(kind: str, seed: int, rows: int, g: int, *,
                    copies_of=None):
    """(ids (rows, g) int32, n (rows,) int32) numpy arrays: distinct ids in
    each row's first n slots, in no order, and SET_PAD or garbage after.

    * "hashed": folded FNV-1a hashes of words from a vocabulary of 3 g, so
      rows share ids; SET_PAD after;
    * "low10": ids that all share their low 10 bits; garbage after;
    * "edge": 0x7FFFFFFF (= SET_PAD), 0x80000000, 0 and -1 inside every row
      of 4 ids or more, with -2 and 1 beside them; SET_PAD after in even
      rows, garbage in odd ones;
    * "full": every row holds g ids (hashed);
    * "identical": hashed rows with n running over 0 .. g; with
      ``copies_of`` (the query side's (ids, n)), row i is a copy of its
      row i mod its rows;
    * "collide": ids k / 0x9E3779B1 mod 2^32 for k < 2 g, so id x
      0x9E3779B1 = k < 2^23 and every id has home slot 0 in the kernel's
      tables (the top bits of that product, at most 512 slots): the
      longest probe windows; garbage after.
    Empty and full rows are forced in (rows 0 and 1)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, g + 1, size=rows).astype(np.int32)
    if kind == "full":
        n[:] = g
    elif kind == "identical":
        n = (np.arange(rows) * (g + 1) // max(rows, 1)).astype(np.int32)
    n[:2] = [0, g]
    ids = np.full((rows, g), SET_PAD, dtype=np.int64)
    vocab = [fold32_fnv1a(f"w{k}") for k in range(3 * g)]
    for i in range(rows):
        m = int(n[i])
        if kind in ("hashed", "full", "identical"):
            row = [vocab[k] for k in rng.choice(3 * g, size=m, replace=False)]
        elif kind == "low10":
            row = [int(k) * 1024 + 0x2A5 - 2**31
                   for k in rng.choice(3 * g, size=m, replace=False)]
        elif kind == "edge":
            extra = [int(k) for k in
                     rng.choice(np.arange(-3 * g, 3 * g), size=g,
                                replace=False) if k not in (0, -1, -2, 1)]
            row = ([SET_PAD, -2**31, 0, -1, -2, 1] + extra)[:m]
            rng.shuffle(row)
        elif kind == "collide":
            row = [_signed(int(k) * _MUL_INV)
                   for k in rng.choice(2 * g, size=m, replace=False)]
        else:
            raise ValueError(kind)
        ids[i, :m] = row
        garbage = kind in ("low10", "collide") or (kind == "edge" and i % 2)
        if garbage:
            ids[i, m:] = rng.integers(-2**31, 2**31, size=g - m)
    if copies_of is not None:
        qids, qn = copies_of
        for i in range(rows):
            ids[i], n[i] = qids[i % len(qn)], qn[i % len(qn)]
    return ids.astype(np.int32), n
