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
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.config import DukeSchema
from ..core.records import Record
from ..env import env_int
from ..ops import encoder as E
from ..ops import features as F
from ..ops import scoring as S
from .device_matcher import (
    _CHUNK,
    DeviceIndex,
    DeviceProcessor,
    _BlockResult,
    _PendingBlock,
    _Fetch,
    _ScorerCache,
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
        self.scorer_cache = _AnnScorerCache(self)

    def _extract(self, records: Sequence[Record], plan=None):
        return F.extract_batch(plan or self.plan, records,
                               encoder=self.encoder)

    def explain_retrieval(self, record: Record, candidate: Record,
                          group_filtering: bool = False) -> dict:
        """ANN retrieval provenance: the embedding cosine between the
        pair plus the candidate's actual rank in the query's top-C
        retrieval and the effective C after recall escalation (the width
        the search finished at).  The rank re-runs the two-stage scorer
        for this one query (on the card: the segment-max kernel or the
        scan, then the gathered Myers rescore, at Q = 1)."""
        out = super().explain_retrieval(record, candidate, group_filtering)
        out["mode"] = "ann"
        out["exhaustive"] = False
        out["top_c"] = self.initial_top_c
        out["emb_storage"] = self.emb_storage
        e1 = self.encoder.encode(record)
        e2 = self.encoder.encode(candidate)
        out["cosine"] = float(np.dot(e1, e2))  # encode() normalizes
        row = self.id_to_row.get(candidate.record_id)
        if row is not None:
            result = resolve_block(self.scorer_cache.dispatch_block(
                [record], group_filtering=group_filtering))
            out["effective_top_c"] = int(result.top_index.shape[1])
            positions = np.nonzero(result.top_index[0] == row)[0]
            if positions.size:
                out["rank"] = int(positions[0])
                out["retrieved"] = True
            else:
                out["rank"] = None
                out["retrieved"] = False
        return out


class _AnnScorerCache(_ScorerCache):
    """ANN scorers per (top_c, group_filtering, from_rows), and block
    dispatch with the recall-escalation ladder."""

    def _scorer(self, top_c: int, group_filtering: bool, from_rows: bool):
        key = (top_c, group_filtering, from_rows)
        if key not in self._scorers:
            self._scorers[key] = S.build_ann_scorer(
                self.index.plan, chunk=_CHUNK, top_c=top_c,
                group_filtering=group_filtering, queries_from_rows=from_rows,
            )
        return self._scorers[key]

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
        qfeats, from_rows, query_row, query_group = self._prepare_queries(
            records, group_filtering)
        # gathered from the corpus rows by the scorer when from_rows
        q_emb = {} if from_rows else qfeats.pop(E.ANN_PROP)
        cfeats_all, cvalid, cdeleted, cgroup = corpus.device_arrays()
        emb_tree = cfeats_all[E.ANN_PROP]
        cfeats = {prop: t for prop, t in cfeats_all.items()
                  if prop != E.ANN_PROP}

        def call(c):
            return _Fetch(*self._scorer(c, group_filtering, from_rows)(
                q_emb, qfeats, emb_tree, cfeats, cvalid, cdeleted, cgroup,
                query_group, query_row, min_logit))

        # recall escalation: every retrieved row cleared the bound (or,
        # under int8, sat in the ambiguity band at the cutoff) -> double C;
        # the dd context holds the property features only
        return _PendingBlock(
            corpus.capacity, n, min_logit,
            min(index.initial_top_c, corpus.capacity), call,
            (qfeats, from_rows, query_row),
            needs_escalation=lambda cmax, c: cmax >= c, stage="top_c")


class AnnProcessor(DeviceProcessor):
    """``DeviceProcessor`` over an ``AnnIndex``: ``pairs_compared`` counts
    the rescored candidates, not the whole corpus."""

    exhaustive = False
