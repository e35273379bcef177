"""How ``correct`` is decided: the workload's link feed after the window,
and for a durable deployment its links as they stand on disk once the app
has closed, against the plain reference (``portbench/reference``) over
every record the run sent.

The numbers compared, each with its limit from the configuration file
(``limits``):

* ``requests_unseen``: POSTs the clients sent that the run's own app did
  not count, or the other way round (a foreign listener answers none);
* ``records_unprocessed``: records of POSTs answered 200 (and of the
  preload) that no processed batch held;
* ``records_foreign``: records processed that the run never sent, or
  processed twice;
* ``links_missing`` / ``links_extra``: live links the reference has and
  the feed lacks, and the other way round;
* ``confidence_gap``: the widest gap between a live link's confidence in
  the feed and the reference's f64 value;
* ``durable_links_missing`` / ``durable_links_extra`` /
  ``durable_confidence_gap`` (``link-database-type="h2"``): the same of
  the links the workload's data folder holds, reopened with its journal
  after the app has closed.

The control (``--control``) puts the reference computed in float32 in
the program's place: its links stand for the feed's, and for the durable
links, and are judged by the same numbers and limits.
"""

import numpy as np

from ..reference.links import Records, columns_of, expected_links
from ..reference.schema import parse


def sent_records(wl, plan, sent_posts):
    """A reference ``Records`` of the preload and every POST sent, and the
    ids of those whose POST was answered 200."""
    blocks = []
    acked = set()

    def add(dataset, block, lo, hi, ok):
        blocks.append((dataset, block.ids[lo:hi],
                       {f: col[lo:hi] for f, col in block.fields.items()}))
        if ok:
            acked.update(wl.record_id(dataset, e) for e in block.ids[lo:hi])

    for dataset, block in plan.preload.items():
        add(dataset, block, 0, len(block), True)
    for client in plan.clients:
        n = client.post_records
        for m, post in sent_posts[client.number]:
            add(client.dataset, client.block, m * n, (m + 1) * n, post.ok)
    return Records(wl, blocks), acked


def compare_links(got, expected):
    missing = len(expected.keys() - got.keys())
    extra = len(got.keys() - expected.keys())
    gap = 0.0
    for key in got.keys() & expected.keys():
        gap = max(gap, abs(got[key] - expected[key]))
    return missing, extra, gap


def feed_links(wl, rows):
    got = {}
    for r in rows:
        if r["_deleted"]:
            continue
        a = wl.record_id(r["dataset1"], r["entity1"])
        b = wl.record_id(r["dataset2"], r["entity2"])
        got[tuple(sorted((a, b)))] = r["confidence"]
    return got


def judge(xml, plan, sent_posts, window_sent, batches, feed_rows, posts_seen,
          limits, durable=None, control=False, device="cpu"):
    """{name: {"value", "limit"}} of every number compared, and the
    number of reference links.

    ``sent_posts``: every POST of the run by client; ``window_sent`` and
    ``posts_seen``: the window's POSTs as the clients and the app counted
    them; ``durable``: {(id1, id2): confidence} of the live links on disk,
    or None where the deployment keeps none; ``control``: the float32
    reference takes the program's place."""
    wl = parse(xml)
    records, acked = sent_records(wl, plan, sent_posts)
    processed = [rid for batch in batches for rid in batch]
    seen = set(processed)
    foreign = (len(processed) - len(seen)
               + sum(1 for rid in seen if rid not in records.index))
    unprocessed = sum(1 for rid in acked if rid not in seen)
    numbers = {
        "requests_unseen": abs(window_sent - posts_seen),
        "records_unprocessed": unprocessed,
        "records_foreign": foreign,
    }
    if foreign == 0:
        usable = batches
    else:   # judge the links of what can be judged; the count already fails
        known, usable = set(), []
        for batch in batches:
            keep = [r for r in batch if r in records.index and r not in known]
            known.update(keep)
            usable.append(keep)
    columns = columns_of(records, device)
    expected = expected_links(records, usable, np.float64, columns=columns)
    got = feed_links(wl, feed_rows)
    if control:
        got = expected_links(records, usable, np.float32, columns=columns)
        if durable is not None:
            durable = got
    missing, extra, gap = compare_links(got, expected)
    numbers.update(links_missing=missing, links_extra=extra,
                   confidence_gap=gap)
    if durable is not None:
        missing, extra, gap = compare_links(durable, expected)
        numbers.update(durable_links_missing=missing,
                       durable_links_extra=extra,
                       durable_confidence_gap=gap)
    out = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return out, len(expected)


def passed(numbers):
    return all(n["value"] <= n["limit"] for n in numbers.values())
