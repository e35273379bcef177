"""The plain reference: which links a served workload must hold, and with
what confidence, given the records it processed.

NumPy, plain PyTorch and the standard library only; nothing of the
program under test.  The inputs are the entities the benchmark generated
from its seed (the same ones it sent) and the batches in which the
workload processed them.

Semantics (Duke's ``Processor.deduplicate`` as the upstream service
drives it): a batch indexes all its records, then each record is
compared with every record indexed so far (for record linkage, only
those of the other group), and a pair whose naive-Bayes probability is
above the threshold is a link.  So once every batch has run, the live
links are every processed pair above the threshold, whatever the order.
The upstream service parses ``link-mode="one-to-one"`` and never acts on
it, so neither does the reference.

Blocking: a pair can only clear the threshold if every property whose
low probability alone holds the fold to the threshold or under, with
every other property at its best, gives more than its low probability,
which takes a similarity of 0.5 or more (``necessary_properties``).  The
reference pairs records only through the values of such a property that
agree so (``Column``: every pair of distinct values, Levenshtein by the
textbook DP on the device at hand, ``lev_distance_table``), so the cut is derived from the
schema's numbers, not an approximation.

``dtype`` is the precision of the pair arithmetic: float64 is the
reference; float32 is the control, the nearest precision below the one
the deployment promises.
"""

import numpy as np

from .schema import Workload, clean


def fold_bound(ps):
    num = den = 1.0
    for p in ps:
        num *= p
        den *= 1.0 - p
    return num / (num + den)


def best_probability(prop) -> float:
    """The largest probability the property's map can give."""
    return max(prop.low, prop.high, 0.5 + 0.25 * (prop.high - 0.5))


def necessary_properties(wl: Workload):
    """The properties on which every link has a similarity of 0.5 or
    more."""
    out = []
    for i, prop in enumerate(wl.props):
        others = [best_probability(p) for j, p in enumerate(wl.props)
                  if j != i]
        if fold_bound(others + [prop.low]) <= wl.threshold:
            out.append(prop)
    return out


def _padded(strings):
    lengths = np.array([len(s) for s in strings], dtype=np.int64)
    width = max(1, int(lengths.max()) if len(strings) else 1)
    out = np.zeros((len(strings), width), dtype=np.int64)
    for i, s in enumerate(strings):
        if s:
            out[i, :len(s)] = [ord(c) for c in s]
    return out, lengths


def lev_distance_many(a, b):
    """Levenshtein distance of each pair (a[i], b[i]): the textbook DP,
    row by row, over all pairs at once."""
    pa, la = _padded(a)
    pb, lb = _padded(b)
    n = len(a)
    width_b = pb.shape[1]
    prev = np.tile(np.arange(width_b + 1, dtype=np.int64), (n, 1))
    out = lb.copy()                       # an empty a gives len(b)
    rows = np.arange(n)
    for i in range(1, pa.shape[1] + 1):
        cur = np.empty_like(prev)
        cur[:, 0] = i
        ai = pa[:, i - 1]
        for j in range(1, width_b + 1):
            cost = (ai != pb[:, j - 1]).astype(np.int64)
            cur[:, j] = np.minimum(np.minimum(prev[:, j] + 1,
                                              cur[:, j - 1] + 1),
                                   prev[:, j - 1] + cost)
        done = la == i
        out[done] = cur[rows[done], lb[done]]
        prev = cur
    return out


def lev_distance_table(strings, device="cpu", block=512):
    """(u, v, d) of every pair u < v of ``strings`` whose lengths pass
    Duke's cut and whose distance d is at most half the shorter length:
    the textbook DP over a block of rows against the later columns at
    once, in plain PyTorch."""
    import torch

    chars, lengths = _padded(strings)
    n, width = chars.shape
    dev = torch.device(device)
    c = torch.from_numpy(chars).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    us, vs, ds = [], [], []
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        a, la = c[r0:r1], ln[r0:r1, None]
        b, lb = c[r0:], ln[None, r0:]
        shape = (r1 - r0, n - r0)
        # a distance is at most the longer length: a byte holds it
        prev = [torch.full(shape, j, dtype=torch.int16 if width > 120
                           else torch.int8, device=dev)
                for j in range(width + 1)]
        out = torch.zeros_like(prev[0])
        for i in range(1, width + 1):
            cur = [torch.full_like(prev[0], i)]
            ai = a[:, i - 1:i]
            for j in range(1, width + 1):
                cur.append(torch.minimum(
                    torch.minimum(prev[j], cur[j - 1]) + 1,
                    prev[j - 1] + (ai != b[None, :, j - 1])))
            at_lb = torch.stack(cur).gather(0, lb.expand(shape)[None])[0]
            out = torch.where(la == i, at_lb, out)
            prev = cur
        s = torch.minimum(la, lb)
        lg = torch.maximum(la, lb)
        d = out.to(torch.int64)
        upper = (torch.arange(r0, r1, device=dev)[:, None]
                 < torch.arange(r0, n, device=dev)[None, :])
        ok = (upper & (s > 0) & ((lg - s) * 2 <= s)
              & (2 * torch.minimum(d, s) <= s))
        iu, iv = torch.nonzero(ok, as_tuple=True)
        us.append((iu + r0).cpu().numpy())
        vs.append((iv + r0).cpu().numpy())
        ds.append(d[iu, iv].cpu().numpy())
    if not us:
        return (np.zeros(0, np.int64),) * 3
    return (np.concatenate(us).astype(np.int64),
            np.concatenate(vs).astype(np.int64),
            np.concatenate(ds).astype(np.int64))


class Column:
    """One property's values by record: the distinct values, each record's
    value id, and for Levenshtein the pairs of distinct values that agree
    (similarity 0.5 or more) with their distances."""

    def __init__(self, prop, values, device):
        self.prop = prop
        self.distinct, self.vid = np.unique(np.array(values, dtype=object)
                                            .astype(str), return_inverse=True)
        self.vid = self.vid.reshape(-1)
        self.lengths = np.array([len(v) for v in self.distinct],
                                dtype=np.int64)
        self.agree_keys = np.zeros(0, np.int64)
        self.agree_d = np.zeros(0, np.int64)
        self.agree_u = self.agree_v = np.zeros(0, np.int64)
        if prop.kind == "levenshtein":
            u, v, d = lev_distance_table(list(self.distinct), device)
            order = np.argsort(u * len(self.distinct) + v, kind="stable")
            self.agree_u, self.agree_v = u[order], v[order]
            self.agree_d = d[order]
            self.agree_keys = (self.agree_u * len(self.distinct)
                               + self.agree_v)
        elif prop.kind == "numeric":
            self.number = np.array([float(x) for x in self.distinct])

    def probabilities(self, left, right, dtype):
        """The property's probability of each record pair."""
        prop = self.prop
        u, v = self.vid[left], self.vid[right]
        half, one = dtype(0.5), dtype(1.0)
        if prop.kind == "exact":
            sim = np.where(u == v, one, dtype(0.0))
        elif prop.kind == "numeric":
            d1 = self.number[u].astype(dtype)
            d2 = self.number[v].astype(dtype)
            lo = np.minimum(np.abs(d1), np.abs(d2))
            hi = np.maximum(np.abs(d1), np.abs(d2))
            ratio = lo / np.where(hi > 0, hi, one)
            sim = np.where(ratio >= dtype(prop.min_ratio), ratio, dtype(0.0))
            sim = np.where(d1 == d2, one, sim)
        elif prop.kind == "levenshtein":
            lo, hi = np.minimum(u, v), np.maximum(u, v)
            keys = lo * len(self.distinct) + hi
            d = np.zeros(len(keys), dtype=np.int64)
            found = np.zeros(len(keys), dtype=bool)
            if len(self.agree_keys):
                at = np.minimum(np.searchsorted(self.agree_keys, keys),
                                len(self.agree_keys) - 1)
                found = self.agree_keys[at] == keys
                d = np.where(found, self.agree_d[at], 0)
            s = np.minimum(self.lengths[u], self.lengths[v]).astype(dtype)
            sim = one - d.astype(dtype) / np.where(s > 0, s, one)
            sim = np.where(found, sim, dtype(0.0))
            sim = np.where(u == v, one, sim)
        else:
            raise ValueError(prop.kind)
        sim = sim.astype(dtype)
        return np.where(sim >= half,
                        (dtype(prop.high) - half) * sim * sim + half,
                        dtype(prop.low)).astype(dtype)


class Records:
    """The records a run sent: their ids, datasets, groups and the value
    of each property, built from the raw entity fields through the
    config's column maps and cleaners.

    ``blocks``: (dataset, entity ids, {field: values}) in sending order."""

    def __init__(self, wl: Workload, blocks):
        self.wl = wl
        sources = {s.dataset: s for s in wl.sources}
        self.datasets, self.ids, group = [], [], []
        self.values = {p.name: [] for p in wl.props}
        for dataset, entity_ids, fields in blocks:
            src = sources[dataset]
            self.datasets.extend([dataset] * len(entity_ids))
            self.ids.extend(wl.record_id(dataset, e) for e in entity_ids)
            group.extend([src.group or 0] * len(entity_ids))
            for prop in wl.props:
                named = [f for f, p in src.columns.items() if p == prop.name]
                if not named:
                    raise ValueError(f"{dataset} has no column for "
                                     f"{prop.name}: the blocking cut "
                                     "assumes every property present")
                kind = src.cleaners.get(named[0])
                col = [clean(kind, v) for v in fields[named[0]]]
                if not all(col):
                    raise ValueError(f"an empty {prop.name} in {dataset}")
                self.values[prop.name].extend(col)
        self.group = np.array(group, dtype=np.int64)
        self.index = {rid: i for i, rid in enumerate(self.ids)}
        if len(self.index) != len(self.ids):
            raise ValueError("duplicate record ids in the generated input")


def order_of(records: Records, batches):
    """Batch number of each record (-1: never processed); raises on an id
    the run never sent or one processed twice."""
    pos = np.full(len(records.ids), -1, dtype=np.int64)
    for b, batch in enumerate(batches):
        for rid in batch:
            i = records.index.get(rid)
            if i is None:
                raise KeyError(f"processed a record never sent: {rid}")
            if pos[i] >= 0:
                raise ValueError(f"record processed twice: {rid}")
            pos[i] = b
    return pos


def _groups(vid):
    """Records sorted by value id, and each value's first place and count
    in that order."""
    order = np.argsort(vid, kind="stable")
    counts = np.bincount(vid, minlength=int(vid.max()) + 1 if len(vid) else 0)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    return order, starts, counts.astype(np.int64)


def _within(order, starts, counts):
    """Every pair of records with one value."""
    n = len(order)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    vid_sorted = np.repeat(np.arange(len(counts)), counts)
    rank = np.arange(n) - starts[vid_sorted]
    reps = counts[vid_sorted] - rank - 1
    total = int(reps.sum())
    first = np.repeat(np.arange(n), reps)
    offset = np.arange(total) - np.repeat(np.cumsum(reps) - reps, reps)
    return order[first], order[first + 1 + offset]


def _across(order, starts, counts, u, v):
    """Every pair of a record of value u[k] and one of value v[k]."""
    cu, cv = counts[u], counts[v]
    reps = cu * cv
    total = int(reps.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    k = np.repeat(np.arange(len(u)), reps)
    within = np.arange(total) - np.repeat(np.cumsum(reps) - reps, reps)
    a = within // cv[k]
    b = within % cv[k]
    return order[starts[u[k]] + a], order[starts[v[k]] + b]


def candidate_pairs(records: Records, pos, columns):
    """(left, right) index arrays of the processed pairs whose values of
    the joining property agree (record linkage: of different groups)."""
    wl = records.wl
    needed = necessary_properties(wl)
    join = [p for p in needed if p.kind in ("levenshtein", "exact")]
    if not join:
        raise ValueError("no string property bounds the fold under the "
                         "threshold: this reference has no blocking cut "
                         "for the schema")
    col = columns[join[0].name]
    done = np.nonzero(pos >= 0)[0]
    # value ids of the processed records only, renumbered densely
    used, vid = np.unique(col.vid[done], return_inverse=True)
    vid = vid.reshape(-1)
    order, starts, counts = _groups(vid)
    left, right = _within(order, starts, counts)
    if col.prop.kind == "levenshtein" and len(col.agree_u):
        remap = np.full(len(col.distinct), -1, dtype=np.int64)
        remap[used] = np.arange(len(used))
        u, v = remap[col.agree_u], remap[col.agree_v]
        keep = (u >= 0) & (v >= 0)
        l2, r2 = _across(order, starts, counts, u[keep], v[keep])
        left = np.concatenate([left, l2])
        right = np.concatenate([right, r2])
    left, right = done[left], done[right]
    if wl.kind == "recordlinkage":
        cross = records.group[left] != records.group[right]
        left, right = left[cross], right[cross]
    for prop in needed:
        if prop is join[0]:
            continue
        p = columns[prop.name].probabilities(left, right, np.float64)
        agree = p != prop.low
        left, right = left[agree], right[agree]
    return left, right


def pair_confidences(wl: Workload, columns, left, right, dtype=np.float64):
    """The pair probability of records left[i] and right[i], folded in
    the schema's order."""
    num = np.ones(len(left), dtype=dtype)
    den = np.ones(len(left), dtype=dtype)
    for prop in wl.props:
        p = columns[prop.name].probabilities(left, right, dtype)
        num = num * p
        den = den * (dtype(1.0) - p)
    return num / (num + den)


def columns_of(records: Records, device="cpu"):
    return {p.name: Column(p, records.values[p.name], device)
            for p in records.wl.props}


def expected_links(records: Records, batches, dtype=np.float64,
                   device="cpu", columns=None):
    """{(id1, id2) sorted: confidence} of the live links after
    ``batches``."""
    wl = records.wl
    pos = order_of(records, batches)
    if columns is None:
        columns = columns_of(records, device)
    left, right = candidate_pairs(records, pos, columns)
    conf = pair_confidences(wl, columns, left, right, dtype)
    hit = conf > dtype(wl.threshold)
    ids = records.ids
    return {tuple(sorted((ids[i], ids[j]))): float(c)
            for i, j, c in zip(left[hit].tolist(), right[hit].tolist(),
                               conf[hit].tolist())}
