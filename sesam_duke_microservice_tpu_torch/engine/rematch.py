"""Bulk corpus-vs-corpus re-match over the ring layout.

Counterpart of the JAX package's ``engine/rematch.py``: re-scoring EVERY
live record against the whole corpus -- a link-database backfill after a
lost or retired link store, a re-match after a threshold change, or the
first population of bulk-imported records.  The service batch path copies
its (small) query block to every shard; here the query block IS the
corpus, so the ring (``parallel.ring``) splits both axes: each shard holds
N/D queries and N/D corpus rows, scores its resident queries against its
local rows and hands the block on -- D hops, O(N/D) transfer a hop.

Exactness: the ring carry merge is the same running top-K the single and
replicated layouts use, so surviving pairs equal the brute-force
scorer's (tests/test_torch_rematch.py).  Surviving pairs are
host-finalized on the exact double-precision path and emitted through the
workload's normal listener chain; links assert idempotently
(``links.base.CONFIDENCE_EPSILON``), so re-matching an intact link
database is a no-op for pollers.

Reachable from the REST surface as ``POST /{kind}/{name}/rematch`` and
from Python as ``ring_rematch(workload)``.

A serving group: the frontend broadcasts a ``rematch`` op before it runs
(``parallel/dispatch.py``), follower replicas replay the device-program
side (placement, ring passes, escalation re-runs) in lockstep through
``replay_rematch``, and every result fetch (``_gather``) is a collective
all processes enter, because the ring's outputs are split over every
process's shards.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger("ring-rematch")

_INITIAL_TOP_K = 64


def _gather(mesh, tree):
    """The ring's per-shard outputs (a list per output) as host arrays in
    global shard order: plain transfers in one process, one
    ``all_gather`` a list across processes -- a collective every process
    of the group enters, in this same order."""
    from ..parallel.sharded import gather_shards

    if isinstance(tree, tuple):
        return tuple(_gather(mesh, t) for t in tree)
    return gather_shards(mesh, tree)


def ring_rematch(workload, *,
                 query_block_rows: Optional[int] = None) -> Dict:
    """Re-score every live record against the whole corpus via the ring,
    ``query_block_rows`` queries a pass (default 4,096 a shard).

    Call with the workload lock held.  Returns run stats.  Requires a
    device-family backend (the corpus host mirror supplies both the corpus
    and the query features); the host backend has no feature tensors to
    ride the mesh."""
    from ..parallel import dispatch

    index = workload.index
    if getattr(index, "corpus", None) is None:
        raise ValueError(
            "ring re-match needs a device-family backend (device/ann/"
            "sharded); the host backend has no corpus tensors")
    d = dispatch.current()
    key = getattr(index, "_dispatch_key", None)
    if d is not None and key is not None:
        # a serving group: followers replay the device-program side of
        # this exact run (same block bounds, same escalation decisions
        # from the gathered counts) so the ring's collectives meet; any
        # failure latches (dispatch.latch_on_failure)
        with d.op_lock:
            d.broadcast(dispatch.with_trace_ctx(
                ("rematch", key, query_block_rows)))
            with dispatch.latch_on_failure(
                    d, "frontend rematch aborted mid-run"):
                return _ring_rematch_impl(
                    index, workload.processor, index.schema,
                    query_block_rows=query_block_rows, finalize=True)
    return _ring_rematch_impl(index, workload.processor, index.schema,
                              query_block_rows=query_block_rows,
                              finalize=True)


def replay_rematch(index, processor, query_block_rows=None) -> None:
    """Follower-side replay (``parallel.dispatch`` op ``rematch``): the
    same device-program sequence with host finalization off."""
    _ring_rematch_impl(index, processor, index.schema,
                       query_block_rows=query_block_rows, finalize=False)


def _default_mesh(index):
    """The index's own mesh, else the serving mesh when it lives on the
    index's device type, else one shard on the index's device."""
    from ..parallel.sharded import Mesh
    from .sharded_matcher import serving_mesh

    mesh = getattr(index, "mesh", None)
    if mesh is not None:
        return mesh
    try:
        return serving_mesh(index.device)
    except (RuntimeError, ValueError):
        return Mesh([index.device])


def _same_device(a, b) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _resident_arrays(index, mesh, prop_names, chunk: int):
    """The corpus's own device tensors, leased from the arena, when they
    already lie in the ring's layout -- a mesh index on the mesh the pass
    uses, or a single-device index on a one-shard mesh on its device --
    as per-shard lists of the plan's device properties, each shard cut to
    the whole chunks that hold its rows below ``corpus.size`` (at least
    one); else None, and the pass places a copy of its own.

    The ring reads the shards' row offsets off shard 0's length.  Rows
    fill the corpus from the front, so wherever a later shard holds a
    row, shard 0 is whole and its length is the shards' true one."""
    corpus = index.corpus
    if getattr(index, "mesh", None) is mesh:
        feats, valid, deleted, group = corpus.device_arrays()
    elif mesh.size == 1 and _same_device(mesh.lead, corpus.device):
        feats, valid, deleted, group = ([t] for t in corpus.device_arrays())
    else:
        return None
    local = valid[0].shape[0]
    if mesh.spans_processes:
        # another rank's first shard need not be whole: keep every shard
        # at its full length, so the offsets read off it stay true
        return feats, valid, deleted, group
    used = [max(chunk, -(-min(max(corpus.size - s * local, 0), local)
                         // chunk) * chunk) for s in range(mesh.size)]
    feats = [{prop: {name: t[:n] for name, t in tensors.items()}
              for prop, tensors in shard.items() if prop in prop_names}
             for shard, n in zip(feats, used)]
    valid, deleted, group = ([t[:n] for t, n in zip(part, used)]
                             for part in (valid, deleted, group))
    return feats, valid, deleted, group


def _ring_rematch_impl(index, processor, schema, *,
                       query_block_rows, finalize: bool) -> Dict:
    from ..parallel.ring import RingQueryPlacer, build_ring_scorer
    from ..parallel.sharded import ShardedCorpus
    from .device_matcher import _CHUNK

    corpus = index.corpus
    mesh = _default_mesh(index)

    group_filtering = processor.group_filtering
    plan = index.plan
    t0 = time.perf_counter()

    # live rows only (valid, not tombstoned, not dukeDeleted)
    size = corpus.size
    live = corpus.row_valid[:size] & ~corpus.row_deleted[:size]
    live_rows = np.nonzero(live)[0]
    n = int(live_rows.size)
    stats = {"queries": n, "corpus_rows": n, "pairs_ranked": 0,
             "survivor_pairs": 0, "events": 0, "seconds": 0.0,
             "devices": int(mesh.size)}
    if n == 0:
        return stats

    # corpus placement: the corpus's own resident tensors where they lie
    # in the ring's layout, else host mirror -> record-axis shards (a
    # one-time bulk copy outside the arena's lease).  Only the plan's
    # device properties ride -- the ann embedding pseudo-property is
    # irrelevant to the brute-force ring pass
    prop_names = {spec.name for spec in plan.device_props}
    host_feats = {
        prop: {k: a[:size] for k, a in tensors.items()}
        for prop, tensors in corpus.feats.items() if prop in prop_names
    }
    placed = _resident_arrays(index, mesh, prop_names, _CHUNK)
    if placed is not None:
        max_k = sum(t.shape[0] for t in placed[1]) * mesh.world
    else:
        placer = ShardedCorpus(mesh, chunk=_CHUNK)
        placed = placer.place(
            host_feats, corpus.row_valid[:size], corpus.row_deleted[:size],
            corpus.row_group[:size])
        max_k = placer.padded_capacity(size)
    sfeats, svalid, sdeleted, sgroup = placed

    qplacer = RingQueryPlacer(mesh)
    min_logit = index.scorer_cache._min_logit()
    block = query_block_rows or 4096 * mesh.size
    scorers: Dict[int, object] = {}

    def scorer(k):
        if k not in scorers:
            scorers[k] = build_ring_scorer(
                plan, mesh, chunk=_CHUNK, top_k=k,
                group_filtering=group_filtering)
        return scorers[k]

    listeners = processor.listeners if finalize else []
    for listener in listeners:
        listener.batch_ready(n)
    threshold = schema.threshold
    maybe = schema.maybe_threshold
    row_ids = corpus.row_ids
    records = index.records

    try:
        for start in range(0, n, block):
            rows = live_rows[start:start + block]
            qfeats_np = {
                prop: {k: a[rows] for k, a in tensors.items()}
                for prop, tensors in host_feats.items()
            }
            qgroup = corpus.row_group[rows]
            qrow = rows.astype(np.int32)
            rqf, rqg, rqr = qplacer.place(qfeats_np, qgroup, qrow)

            k = min(_INITIAL_TOP_K, max(corpus.capacity, 1))
            while True:
                tl, ti, cnt = scorer(k)(
                    rqf, sfeats, svalid, sdeleted, sgroup, rqg, rqr,
                    np.float32(min_logit))
                # only cnt drives the widening decision: fetch it alone
                # per iteration
                cmax = int(_gather(mesh, cnt)[: rows.size].max(initial=0))
                if cmax <= k or k >= max_k:
                    break
                k = min(k * 2, max_k)
                logger.info("ring escalation: %d at the bound, width=%d",
                            cmax, k)
            top_logit, top_index = _gather(mesh, (tl, ti))
            top_logit = top_logit[: rows.size]
            top_index = top_index[: rows.size]
            stats["pairs_ranked"] += int(rows.size) * n
            if not finalize:
                continue

            # host finalization: each unordered pair is ranked from both
            # sides; keep the (qrow < crow) orientation so events emit once
            for qi in range(rows.size):
                qrow_global = int(rows[qi])
                record = records.get(row_ids[qrow_global])
                if record is None:
                    continue
                keep = top_logit[qi] > min_logit
                for crow in top_index[qi][keep]:
                    crow = int(crow)
                    if crow < 0 or crow <= qrow_global:
                        continue
                    candidate = records.get(row_ids[crow])
                    if candidate is None:
                        continue
                    stats["survivor_pairs"] += 1
                    prob = processor.compare(record, candidate)
                    if prob > threshold:
                        stats["events"] += 1
                        for listener in listeners:
                            listener.matches(record, candidate, prob)
                    elif maybe is not None and maybe != 0.0 and prob > maybe:
                        stats["events"] += 1
                        for listener in listeners:
                            listener.matches_perhaps(record, candidate, prob)
    finally:
        for listener in listeners:
            listener.batch_done()
    stats["seconds"] = round(time.perf_counter() - t0, 3)
    logger.info("ring re-match: %s", stats)
    return stats
