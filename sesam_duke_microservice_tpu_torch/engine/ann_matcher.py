"""The ``ann`` backend: embedding cosine blocking + exact rescoring.

Counterpart of the JAX package's ``engine/ann_matcher.py`` (flat
retrieval, bf16 and int8 storage).  Candidates are the cosine top-C of
each query over hashed-trigram record embeddings (``ops.encoder``); only
those rows are scored with the exact per-property kernels
(``ops.scoring.build_ann_scorer``) and finalized on the host -- the
configuration for corpora where brute force stops being free.

Emitted confidences for retrieved pairs are the brute-force backend's
(the same host finalization through ``DeviceProcessor``); the candidate
set is approximate, bounded below by recall escalation: when some query's
C retrieved rows all clear the pruning bound, the block re-runs with
doubled C, so a saturated retrieval never truncates silently.  The
embedding rides the ``DeviceCorpus`` feature tree under
``ops.encoder.ANN_PROP``, so growth, tombstones and uploads apply to it
unchanged.

IVF clustered retrieval (``DUKE_IVF``, off by default; ``ops.ivf``):
k-means cells over the corpus embeddings with a two-stage cell-probe
scan, trained lazily on the scoring path.  A saturated probe escalates
``nprobe`` in lockstep with the C ladder and finally falls back to the
flat scan, so truncation never passes silently.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.config import DukeSchema
from ..core.records import Record
from ..env import env_int
from ..ops import encoder as E
from ..ops import features as F
from ..ops import ivf as IVF
from ..ops import scoring as S
from .device_matcher import (
    _CHUNK,
    DeviceIndex,
    DeviceProcessor,
    _BlockResult,
    _PendingBlock,
    _Fetch,
    _ScorerCache,
    _device_clock,
    resolve_block,
)


class AnnIndex(DeviceIndex):
    """``DeviceIndex`` whose records also carry an embedding, with the
    two-stage ANN scorer.  ``DEVICE_ANN_DIM`` (256) and
    ``DEVICE_ANN_CANDIDATES`` (the initial C, 64) are read when the index
    is built."""

    def __init__(self, schema: DukeSchema, *, device):
        super().__init__(schema, device=device)
        self.initial_top_c = env_int("DEVICE_ANN_CANDIDATES", 64)
        self.dim = env_int("DEVICE_ANN_DIM", 256)
        self.encoder = E.RecordEncoder(schema, self.dim)
        # both ride in the snapshot fingerprint: a snapshot written under
        # another width or storage layout (a DUKE_EMB_INT8 flip) replays
        self.emb_storage = self.encoder.storage
        # IVF (DUKE_IVF): resolved at construction; trains lazily on the
        # scoring path once the corpus crosses DUKE_IVF_MIN_ROWS, under the
        # workload lock every mutation site already holds
        self.ivf = (IVF.IvfState(device=self.device,
                                 nshards=self._ivf_shards())
                    if IVF.enabled() else None)
        self.scorer_cache = _AnnScorerCache(self)

    def _ivf_shards(self) -> int:
        """Blocks of the IVF membership matrix: 1 on one device (the
        sharded index overrides with its mesh size)."""
        return 1

    def _extract(self, records: Sequence[Record], plan=None):
        return F.extract_batch(plan or self.plan, records,
                               encoder=self.encoder)

    def explain_retrieval(self, record: Record, candidate: Record,
                          group_filtering: bool = False) -> dict:
        """ANN retrieval provenance: the embedding cosine between the
        pair plus the candidate's actual rank in the query's top-C
        retrieval, the effective C after recall escalation (the width
        the search finished at), and under IVF the probed cells at that
        width and whether the candidate's cell was among them.  The rank
        re-runs the two-stage scorer for this one query (on the card: the
        segment-max kernel, the scan or the IVF probe, then the gathered
        Myers rescore, at Q = 1)."""
        out = super().explain_retrieval(record, candidate, group_filtering)
        out["mode"] = "ann"
        out["exhaustive"] = False
        out["top_c"] = self.initial_top_c
        out["emb_storage"] = self.emb_storage
        e1 = self.encoder.encode(record)
        e2 = self.encoder.encode(candidate)
        out["cosine"] = float(np.dot(e1, e2))  # encode() normalizes
        row = self.id_to_row.get(candidate.record_id)
        effective_c = None
        if row is not None:
            result = self._explain_retrieve(record, group_filtering)
            effective_c = int(result.top_index.shape[1])
            out["effective_top_c"] = effective_c
            positions = np.nonzero(result.top_index[0] == row)[0]
            if positions.size:
                out["rank"] = int(positions[0])
                out["retrieved"] = True
            else:
                out["rank"] = None
                out["retrieved"] = False
        ivf = self.ivf
        if ivf is not None and ivf.ready:
            # host replay of the probe's first stage (Q = 1 x K) at the
            # EFFECTIVE escalated width: the initial nprobe could claim
            # "cell not probed" for a pair the escalated (or flat
            # fallback) search did scan
            scores = e1 @ ivf.centroids.T
            nprobe = ivf.nprobe_for(
                effective_c if effective_c is not None
                else self.initial_top_c, self.initial_top_c)
            probed = np.argsort(-scores, kind="stable")[:nprobe]
            out["ivf"] = {
                "cells": ivf.ncells,
                "nprobe": nprobe,
                # nprobe == ncells: the ladder ended in the flat scan
                "flat_fallback": bool(nprobe >= ivf.ncells),
                "probed_cells": [int(c) for c in probed],
            }
            if row is not None and row < ivf.assigned_upto:
                cell = int(ivf.cell_of[row])
                out["ivf"]["candidate_cell"] = cell
                out["ivf"]["cell_probed"] = bool(
                    cell in set(int(c) for c in probed))
        return out


    def _explain_retrieve(self, record: Record, group_filtering: bool):
        """The explain replay's retrieval of one query: the resolved
        block of the serving scorer (the sharded index routes it through
        a serving group's op stream)."""
        return resolve_block(self.scorer_cache.dispatch_block(
            [record], group_filtering=group_filtering))


class _AnnScorerCache(_ScorerCache):
    """ANN scorers per (top_c, group_filtering, from_rows) (IVF scorers
    per (top_c, nprobe, group_filtering, from_rows)), and block dispatch
    with the recall-escalation ladder -- through the IVF cell probe when
    DUKE_IVF trained one, widening ``nprobe`` along the C ladder and
    falling back to the flat scan once every cell is probed."""

    def _build(self, top_c: int, group_filtering: bool, from_rows: bool):
        return S.build_ann_scorer(
            self.index.plan, chunk=_CHUNK, top_c=top_c,
            group_filtering=group_filtering, queries_from_rows=from_rows)

    def _ivf_scorer(self, top_c: int, nprobe: int, group_filtering: bool,
                    from_rows: bool):
        key = ("ivf", top_c, nprobe, group_filtering, from_rows)
        if key not in self._scorers:
            self._scorers[key] = self._build_ivf(top_c, nprobe,
                                                 group_filtering, from_rows)
        return self._scorers[key]

    def _build_ivf(self, top_c: int, nprobe: int, group_filtering: bool,
                   from_rows: bool):
        return IVF.build_ivf_scorer(
            self.index.plan, top_c=top_c, nprobe=nprobe,
            group_filtering=group_filtering, queries_from_rows=from_rows)

    def _split_embedding(self, cfeats_all):
        """The corpus tree -> (embedding tree, property features): the
        scorers take the two apart."""
        return (cfeats_all[E.ANN_PROP],
                {prop: t for prop, t in cfeats_all.items()
                 if prop != E.ANN_PROP})

    def _ivf_placers(self):
        """(centroid, membership) placement hooks of ``IvfState.
        device_tensors``: the defaults on one device."""
        return None, None

    def dispatch_block(self, records: Sequence[Record], *,
                       group_filtering: bool):
        index = self.index
        corpus = index.corpus
        n = len(records)
        min_logit = self._min_logit()
        if corpus.size == 0:
            return _BlockResult(
                np.full((n, 1), S.NEG_INF, np.float32),
                np.full((n, 1), -1, np.int32), min_logit,
            )
        start = _device_clock(index.device)
        qfeats, from_rows, query_row, query_group = self._prepare_queries(
            records, group_filtering)
        # gathered from the corpus rows by the scorer when from_rows
        q_emb = {} if from_rows else qfeats.pop(E.ANN_PROP)
        cfeats_all, cvalid, cdeleted, cgroup = corpus.device_arrays()
        emb_tree, cfeats = self._split_embedding(cfeats_all)
        # lazy IVF maintenance (train on the first crossing, assign
        # appended slices, refresh on doubling) under the workload lock
        # the dispatch path holds
        ivf = index.ivf
        if ivf is not None and not ivf.sync(corpus):
            ivf = None
        c0 = min(index.initial_top_c, corpus.capacity)

        def call(c):
            if ivf is not None:
                nprobe = ivf.nprobe_for(c, c0)
                if nprobe < ivf.ncells:
                    cents, cells = ivf.device_tensors(*self._ivf_placers())
                    return _Fetch(*self._ivf_scorer(
                        c, nprobe, group_filtering, from_rows)(
                        q_emb, qfeats, emb_tree, cents, cells, cfeats,
                        cvalid, cdeleted, cgroup, query_group, query_row,
                        min_logit))
                # every cell probed: the probe degenerated to a worse
                # flat scan -- fall back to the real one, so escalation
                # ends in exhaustive retrieval
            return _Fetch(*self._scorer(c, group_filtering, from_rows)(
                q_emb, qfeats, emb_tree, cfeats, cvalid, cdeleted, cgroup,
                query_group, query_row, min_logit))

        # recall escalation: every retrieved row cleared the bound (or,
        # under int8, sat in the ambiguity band at the cutoff) -> double C
        # (and, under IVF, nprobe); the dd context holds the property
        # features only
        return _PendingBlock(
            corpus.capacity, n, min_logit, c0, call,
            (qfeats, from_rows, query_row),
            needs_escalation=lambda cmax, c: cmax >= c,
            stage="ivf" if ivf is not None else "top_c", start=start)


class AnnProcessor(DeviceProcessor):
    """``DeviceProcessor`` over an ``AnnIndex``: ``pairs_compared`` counts
    the rescored candidates, not the whole corpus."""

    exhaustive = False
