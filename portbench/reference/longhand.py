"""Duke's pair arithmetic written out longhand, one pair at a time.

A frozen copy of the scalar functions of ``tests/torch_longhand.py``
(textbook Levenshtein DP, NumericComparator's ratio cut, Duke's published
probability map and the naive-Bayes fold), kept here so that the
benchmark's yardstick does not move when the repository's tests do.  The
vectorised reference (``reference.links``) is held to these functions by
``portbench/tests/test_portbench_reference.py``.

Imports nothing but the standard library.
"""


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


def exact_sim(a, b):
    return 1.0 if a == b else 0.0


def pmap(sim, low, high):
    return (high - 0.5) * sim * sim + 0.5 if sim >= 0.5 else low


def bayes(ps):
    num = den = 1.0
    for p in ps:
        num *= p
        den *= 1.0 - p
    return num / (num + den)
