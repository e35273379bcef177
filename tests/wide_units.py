"""Seeded char matrices over wide UTF-16 alphabets, for the Myers tile
kernel's match-table lookup and its plain version.

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
