"""Fleet metrics rollup.

Merges per-group registry snapshots into one federation-plane scrape.
The merge rule, per family type:

  * **counters and histograms are key-wise SUMMED** across groups.
    Every latency histogram in the codebase shares the
    ``DEFAULT_LATENCY_BUCKETS`` ladder, so ``_bucket`` samples with
    identical ``le`` labels are cumulative counts on identical bucket
    ladders -- bucket-wise addition is lossless (the sum of cumulative
    ladders is the cumulative ladder of the union), and ``_sum`` /
    ``_count`` add trivially.  Sample keys already disjoint across
    groups (e.g. per-workload labels that differ) pass through as plain
    sums of one term.
  * **gauges are RELABELED**, never summed: a gauge is point-in-time
    state (queue depth, EWMA, rows resident) whose cross-group sum is
    usually meaningless, so each sample gains a ``group="<idx>"`` label
    and the per-group series stay individually visible.  This keeps the
    rollup's gauge label sets disjoint from any single group's -- the
    property the differential test asserts.

Locking: ``merge_groups`` touches snapshots only -- plain lists already
detached from their registries.  The caller collects each group's
registry SEQUENTIALLY (``MetricRegistry.collect`` does its own brief
locking), so no group lock is ever held across another group's scrape.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

from .registry import FamilySnapshot, MetricRegistry


def merge_groups(
    per_group: Sequence[Tuple[str, Iterable[FamilySnapshot]]],
) -> List[FamilySnapshot]:
    """Merge ``(group_label, snapshots)`` pairs under the sum/relabel
    rule above.  First declaration of a family wins HELP/TYPE (the
    ``render`` precedent)."""
    order: List[str] = []
    meta: Dict[str, Tuple[str, str]] = {}
    sums: Dict[str, Dict[Tuple[str, Tuple], float]] = {}
    relabeled: Dict[str, List] = {}
    for gid, snaps in per_group:
        for snap in snaps:
            if snap.name not in meta:
                order.append(snap.name)
                meta[snap.name] = (snap.mtype, snap.help)
                sums[snap.name] = {}
                relabeled[snap.name] = []
            if snap.mtype == "gauge":
                relabeled[snap.name].extend(
                    (suffix, labels + (("group", str(gid)),), value)
                    for suffix, labels, value in snap.samples)
            else:
                acc = sums[snap.name]
                for suffix, labels, value in snap.samples:
                    key = (suffix, labels)
                    acc[key] = acc.get(key, 0.0) + value
    out = []
    for name in order:
        mtype, help_text = meta[name]
        samples = [(suffix, labels, value)
                   for (suffix, labels), value in sums[name].items()]
        samples.extend(relabeled[name])
        out.append(FamilySnapshot(name, mtype, help_text, samples))
    return out


class GroupRollup:
    """A ``render()``-compatible view over N per-group registries: its
    ``collect()`` scrapes each group in sequence and returns the merged
    fleet snapshot.  Holds no lock of its own."""

    __slots__ = ("_groups",)

    def __init__(self, groups: Sequence[Tuple[str, MetricRegistry]]):
        self._groups = list(groups)

    def collect(self) -> List[FamilySnapshot]:
        return merge_groups(
            [(gid, reg.collect()) for gid, reg in self._groups])
