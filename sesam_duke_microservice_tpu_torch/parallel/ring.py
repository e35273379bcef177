"""Ring-parallel corpus scoring: query blocks rotating around the mesh.

Counterpart of the JAX package's ``parallel/ring.py``, the ring-attention
pattern on this workload's corpus axis.  Where ``parallel.sharded`` copies
the whole query block to every shard and merges per-shard top-Ks, the ring
splits BOTH axes:

  * corpus feature tensors: record-axis split (as in parallel.sharded);
  * query block: ALSO split -- shard s starts with query block s;
  * D steps: every shard scores its resident query block against its
    local corpus rows, threading the block's running global top-K through
    the scan (``ops.scoring.scan_topk(init=...)``), then hands the block
    and its carry to the next shard.  After D hops each block has visited
    every shard and its top-K is back home.

The visit order is the JAX ring's exactly: at step t shard s holds block
``(s - t) mod D``; the carry moves from shard i to shard i + 1 on EVERY
hop (the last one brings each block's top-K home), and the query payload
-- the big per-hop transfer -- skips the final dead hop.  A hop is a
``.to(next device)`` copy (nothing when the next shard shares the device).
With that order the port's ring gives the JAX ring's index sets, ties in
the same places (tests/test_torch_ring.py).

The ring is the regime for large query blocks -- bulk re-matching,
backfills (``engine.rematch``) -- where copying Q query tensors to every
shard would dominate device memory.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from ..ops import scoring as S
from .sharded import LeadingAxisPlacer, Mesh, shard_offsets, tree_map


def _rotate(mesh: Mesh, blocks: List) -> List:
    """One hop: shard i + 1 receives shard i's block (a roll by one)."""
    d = mesh.size
    return [tree_map(lambda t, dev=mesh.devices[i]: t.to(
                dev, non_blocking=True), blocks[(i - 1) % d])
            for i in range(d)]


def build_ring_scorer(plan, mesh: Mesh, *, chunk: int = 512,
                      top_k: int = 64,
                      group_filtering: bool = False) -> Callable:
    """Ring variant of ``parallel.sharded.build_sharded_scorer``::

        fn(qfeats, corpus_feats, corpus_valid, corpus_deleted, corpus_group,
           query_group, query_row, min_logit)
        -> (top_logit, top_index, count), each a per-shard list

    Both sides are per-shard lists: the corpus as ``ShardedCorpus.place``
    gives it, the queries as ``RingQueryPlacer.place`` (equal blocks, one
    per shard).  Block s's results come back on shard s's device."""
    pair_logits = S.build_pair_logits(plan)

    def score(qfeats, corpus_feats, corpus_valid, corpus_deleted,
              corpus_group, query_group, query_row, min_logit):
        d = mesh.size
        offsets = shard_offsets(mesh, corpus_valid[0].shape[0])
        qlocal = query_group[0].shape[0]
        tl = [torch.full((qlocal, top_k), S.NEG_INF, dtype=torch.float32,
                         device=dev) for dev in mesh.devices]
        ti = [torch.full((qlocal, top_k), -1, dtype=torch.int32, device=dev)
              for dev in mesh.devices]
        cnt = [torch.zeros((qlocal,), dtype=torch.int32, device=dev)
               for dev in mesh.devices]
        qf, qg, qr = list(qfeats), list(query_group), list(query_row)
        for step in range(d):
            for s in range(d):
                tl[s], ti[s], cnt[s] = S.scan_topk(
                    pair_logits, qf[s], corpus_feats[s], corpus_valid[s],
                    corpus_deleted[s], corpus_group[s], qg[s], qr[s],
                    min_logit, chunk=chunk, top_k=top_k,
                    group_filtering=group_filtering, row_offset=offsets[s],
                    init=(tl[s], ti[s], cnt[s]))
            if step + 1 < d:
                qf, qg, qr = (_rotate(mesh, x) for x in (qf, qg, qr))
            tl, ti, cnt = (_rotate(mesh, x) for x in (tl, ti, cnt))
        return tl, ti, cnt

    return score


class RingQueryPlacer(LeadingAxisPlacer):
    """Places query-side host arrays onto the mesh, query-axis split.

    Pads the query count up to a multiple of ``mesh.size`` (padding rows
    get ``query_row=-1`` / ``query_group=-2`` and score against nothing
    the caller keeps)."""

    def __init__(self, mesh: Mesh):
        super().__init__(mesh, mesh.size)

    def place(self, qfeats, query_group: np.ndarray, query_row: np.ndarray):
        n = query_group.shape[0]
        cap = self.padded_capacity(n)
        return (self._put_tree(qfeats, n, cap),
                self._put(query_group, n, cap, -2),
                self._put(query_row, n, cap, -1))
