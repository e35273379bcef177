"""IVF clustered retrieval: k-means cells + two-stage probe scoring (the
JAX package's ``ops/ivf.py`` on torch, ``DUKE_IVF``, off by default).

The flat ``ann`` retrieval (``ops.encoder.retrieval_scan``) touches every
corpus row per query, O(N * D) work however concentrated the corpus is.
Exact f64 finalization makes retrieval a recall-only concern, so the
cell-probe playbook applies:

  * **train** -- k-means over the corpus embeddings: the assignment
    matmul and the per-cell sums on the device, the centroid fold on the
    host; seeded, so training is deterministic for a given corpus and
    device.  The per-cell sums are a one-hot matmul (a fixed-order
    reduction), not a float ``index_add_``, whose atomics on CUDA would
    make two trainings on the same corpus differ.  Trained lazily the
    first time a scoring pass sees the corpus past ``DUKE_IVF_MIN_ROWS``
    and refreshed when the corpus doubles past the trained size -- both
    under the workload lock the scoring path already holds, so the
    trainer needs NO lock of its own.
  * **bucket** -- every row is assigned to its nearest centroid;
    assignments are incremental (a streamed append assigns only the new
    slice -- ingest never retrains) and live in a padded ``(cells, B)``
    row-index matrix so the probe keeps static shapes.
  * **probe** -- per query: a (Q, K) query x centroid product picks the
    top-``nprobe`` cells, then a masked candidate scan scores ONLY those
    cells' rows (gathered embedding tiles, scored as the flat scan scores
    its chunks: bf16 products summed in f32, or the exact integer dot of
    the int8 codes) keeping a running top-C.

Both selections are ``lax.top_k``'s order (``ops.encoder.
_total_order_desc``: IEEE total order, ties to the lower position), and
the running top-C comes first in every merge, so an all-masked step never
displaces its -1 sentinels.  The f32 products run with TF32 off, as the
flat path's do (PyTorch's default).

Safety net: the exact rescoring of retrieved pairs is unchanged (the
shared ``ops.scoring.rescore_retrieved`` tail, which launches the
gathered Myers kernel on the card), and a saturated probe widens
``nprobe`` with the C-escalation ladder until it degenerates to the flat
scan (``engine.ann_matcher``) -- truncation never passes silently.  The
probe itself is plain PyTorch: the JAX package's probe is an XLA program
with no Pallas kernel in it.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional

import numpy as np
import torch

from ..env import env_flag, env_int
from . import encoder as E
from .bounds import NEG_INF

logger = logging.getLogger("ivf")


def enabled() -> bool:
    """The IVF master switch (read at index construction -- the resolved
    choice then rides the feature-cache fingerprint)."""
    return env_flag("DUKE_IVF", False)


def min_rows() -> int:
    """Corpus size below which IVF stays untrained (the flat scan is
    already cheap there and k-means would overfit a tiny corpus)."""
    return env_int("DUKE_IVF_MIN_ROWS", 4096)


def configured_cells(n_rows: int) -> int:
    """Cell count: DUKE_IVF_CELLS, or the ~sqrt(N) auto policy bucketed
    to a power of two (so corpus growth re-trains onto O(log N) distinct
    probe shapes, mirroring the capacity-doubling discipline)."""
    k = env_int("DUKE_IVF_CELLS", 0)
    if k <= 0:
        k = 1 << max(2, math.ceil(math.log2(max(4.0, math.sqrt(n_rows)))))
    return max(2, min(k, max(2, n_rows // 2)))


def configured_nprobe(ncells: int) -> int:
    """Initial probed-cell count: DUKE_IVF_NPROBE, or ~sqrt(K) auto."""
    p = env_int("DUKE_IVF_NPROBE", 0)
    if p <= 0:
        p = max(1, int(round(math.sqrt(ncells))))
    return max(1, min(p, ncells))


def scan_slots() -> int:
    """Candidate-slot chunk of the probe scan: bounds the transient
    (Q, slots, D) gathered-embedding tile."""
    return env_int("DUKE_IVF_SCAN_SLOTS", 1024)


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _slot_bucket(n: int) -> int:
    """Membership-matrix width bucket: pow2 up to 64, then 64-multiples.
    Cells are size-skewed in practice and the probe scan's work scales
    with the padded width, so past 64 the width follows the largest cell
    in 64-row steps."""
    if n <= 64:
        return _pow2(max(1, n))
    return -(-n // 64) * 64


# -- k-means ------------------------------------------------------------------

# rows per device step of training and assignment: bounds the (rows, K)
# score and one-hot matrices
_ROW_STEP = 65536


def _assign(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid cell per row: the first argmax of the cosine
    scores (rows and centroids are L2-normalized, so cosine and squared
    distance pick the same cell)."""
    return torch.argmax(x @ cents.T, dim=1)


def _normalize(cents: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(cents, axis=1, keepdims=True)
    cents /= np.where(norms > 0.0, norms, 1.0)
    return cents


def train_kmeans(x: np.ndarray, ncells: int, *, seed: int, iters: int,
                 device="cpu") -> np.ndarray:
    """Deterministic seeded k-means over L2-normalized rows ``x``.

    Returns (ncells, D) f32 L2-normalized centroids.  Init is a seeded row
    sample (the JAX package's); each Lloyd step runs the assignment matmul
    and the one-hot sum matmul on ``device`` and folds the centroids on
    the host.  Empty cells keep their previous centroid (they stay
    probeable and can re-acquire rows on the next refresh)."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    init = rng.choice(n, size=min(ncells, n), replace=False)
    cents = x[np.sort(init)].astype(np.float32).copy()
    if cents.shape[0] < ncells:  # degenerate tiny corpus: repeat rows
        reps = -(-ncells // cents.shape[0])
        cents = np.tile(cents, (reps, 1))[:ncells]
    cents = _normalize(cents)
    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        device)
    cell_ids = torch.arange(ncells, device=xt.device)
    for _ in range(max(1, iters)):
        ct = torch.from_numpy(cents).to(xt.device)
        sums = torch.zeros((ncells, xt.shape[1]), dtype=torch.float32,
                           device=xt.device)
        counts = torch.zeros((ncells,), dtype=torch.int64, device=xt.device)
        for s in range(0, n, _ROW_STEP):
            rows = xt[s:s + _ROW_STEP]
            assign = _assign(rows, ct)
            onehot = (assign[:, None] == cell_ids[None, :]).float()
            sums += onehot.T @ rows
            counts += torch.bincount(assign, minlength=ncells)
        sums = sums.cpu().numpy()
        counts = counts.cpu().numpy().astype(np.float32)
        nonempty = counts > 0.0
        folded = sums / np.where(nonempty, counts, 1.0)[:, None]
        cents = _normalize(
            np.where(nonempty[:, None], folded, cents).astype(np.float32))
    return cents


class IvfState:
    """Lazy-trained IVF index over one corpus's embedding rows.

    All mutation happens on the scoring path, which runs UNDER the
    workload lock (``_AnnScorerCache.dispatch_block``) -- no lock of its
    own.  Host state is authoritative; the device copies of the centroids
    and the membership matrix are re-made lazily per generation."""

    def __init__(self, *, device="cpu", seed: Optional[int] = None):
        self.device = torch.device(device)
        self.seed = seed if seed is not None else env_int(
            "DUKE_IVF_SEED", 1234)
        self.iters = env_int("DUKE_IVF_ITERS", 8)
        self.centroids: Optional[np.ndarray] = None   # (K, D) f32
        self.ncells = 0
        self.nprobe0 = 0
        self.cell_of = np.full((0,), -1, dtype=np.int32)  # per corpus row
        self.cell_rows: Optional[np.ndarray] = None   # (K, B) row ids
        self.counts: Optional[np.ndarray] = None      # (1, K)
        self.bucket = 0                               # B
        self.assigned_upto = 0
        self.trained_rows = 0
        self.generation = 0       # bumps on any centroid/membership change
        self._corpus_id: Optional[int] = None
        self._cap = 0
        self._dev: Optional[tuple] = None
        self._dev_gen = -1

    # -- queries -------------------------------------------------------------

    @property
    def ready(self) -> bool:
        return self.centroids is not None

    def nprobe_for(self, top_c: int, initial_top_c: int) -> int:
        """Probed cells at escalation width ``top_c``: the initial
        ``nprobe`` scaled with the C-doubling ladder, so a saturated probe
        widens its cell coverage in lockstep with its candidate budget;
        at >= ncells the caller falls back to the flat scan."""
        grow = max(1, top_c // max(1, initial_top_c))
        return min(self.ncells, max(1, self.nprobe0 * grow))

    def device_nbytes(self) -> int:
        """Bytes of the IVF state the device-byte ledger counts
        (``ivf_membership``): the centroids, the row assignment, the
        membership matrix and its counts, as the JAX package counts
        them."""
        return sum(int(getattr(arr, "nbytes", 0) or 0) for arr in (
            self.centroids, self.cell_of, self.cell_rows, self.counts))

    # -- state carried across ------------------------------------------------

    def load_arrays(self, centroids, cell_of, cell_rows, assigned_upto: int,
                    trained_rows: int, nprobe0: int, corpus=None) -> None:
        """Adopt a trained index from numpy arrays (the JAX package's
        ``IvfState`` fields, read off its object), so two implementations
        can probe one identical trained state.  ``corpus`` binds the state
        to the corpus whose rows it indexes (else the next ``sync``
        resets it)."""
        self.centroids = np.asarray(centroids, dtype=np.float32).copy()
        self.ncells = int(self.centroids.shape[0])
        self.nprobe0 = int(nprobe0)
        self.cell_of = np.asarray(cell_of, dtype=np.int32).copy()
        self.cell_rows = np.asarray(cell_rows, dtype=np.int32).copy()
        self.bucket = int(self.cell_rows.shape[1])
        self.counts = (self.cell_rows >= 0).sum(axis=1).reshape(
            1, self.ncells)
        self.assigned_upto = int(assigned_upto)
        self.trained_rows = int(trained_rows)
        if corpus is not None:
            self._corpus_id = id(corpus)
            self._cap = corpus.capacity
        self.generation += 1
        self._dev = None

    # -- maintenance (workload lock held) ------------------------------------

    def sync(self, corpus) -> bool:
        """Bring the IVF state up to date with ``corpus``; returns
        readiness.  Trains lazily past ``min_rows``, refreshes (full
        retrain + reassignment) once the corpus doubles past the trained
        size, and otherwise assigns only the appended slice -- streamed
        ingest never retrains."""
        if self._corpus_id != id(corpus):
            # corpus object replaced (value-slot rebuild, fresh index):
            # row numbering restarted, so membership must too
            self._reset()
            self._corpus_id = id(corpus)
        if not self.ready and corpus.size < min_rows():
            return False
        if not self.ready or corpus.size >= 2 * max(1, self.trained_rows):
            self._train(corpus)
        if self.ready:
            self._assign_new(corpus)
        return self.ready

    def _reset(self) -> None:
        self.centroids = None
        self.ncells = 0
        self.cell_of = np.full((0,), -1, dtype=np.int32)
        self.cell_rows = None
        self.counts = None
        self.bucket = 0
        self.assigned_upto = 0
        self.trained_rows = 0
        self._cap = 0
        self.generation += 1
        self._dev = None

    @staticmethod
    def _embeddings_f32(corpus, rows) -> np.ndarray:
        return E.dequantize_rows({
            name: arr[rows] for name, arr in corpus.feats[E.ANN_PROP].items()
        })

    def _train(self, corpus) -> None:
        n = corpus.size
        live = np.flatnonzero(corpus.row_valid[:n] & ~corpus.row_deleted[:n])
        if live.size < 2:
            return
        # train on a seeded sample, gathered out of the compact storage
        # FIRST and only then dequantized (the sample bounds host memory
        # too, not just the matmul)
        sample_max = env_int("DUKE_IVF_TRAIN_SAMPLE", 262144)
        rows = live
        if live.size > sample_max:
            rng = np.random.default_rng(self.seed)
            rows = np.sort(rng.choice(live, size=sample_max, replace=False))
        x = self._embeddings_f32(corpus, rows)
        self.ncells = configured_cells(live.size)
        self.centroids = train_kmeans(x, self.ncells, seed=self.seed,
                                      iters=self.iters, device=self.device)
        self.nprobe0 = configured_nprobe(self.ncells)
        self.trained_rows = n
        # full reassignment under the fresh centroids
        self.cell_of = np.full((corpus.capacity,), -1, dtype=np.int32)
        self.assigned_upto = 0
        self.cell_rows = None
        self.generation += 1
        self._dev = None
        self._assign_new(corpus)
        logger.info("IVF trained: %d cells over %d rows (nprobe0=%d, "
                    "bucket=%d)", self.ncells, int(live.size), self.nprobe0,
                    self.bucket)

    def _assign_rows(self, x: np.ndarray) -> np.ndarray:
        """Nearest-centroid assignment for a slice of f32 rows (device
        matmul; small next to the append's own extraction)."""
        xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        ct = torch.from_numpy(self.centroids).to(self.device)
        return _assign(xt.to(self.device), ct).to(torch.int32).cpu().numpy()

    def _assign_new(self, corpus) -> None:
        if self.cell_of.shape[0] < corpus.capacity:
            grown = np.full((corpus.capacity,), -1, dtype=np.int32)
            grown[: self.cell_of.shape[0]] = self.cell_of
            self.cell_of = grown
        lo, hi = self.assigned_upto, corpus.size
        if hi > lo:
            for s in range(lo, hi, _ROW_STEP):
                e = min(hi, s + _ROW_STEP)
                self.cell_of[s:e] = self._assign_rows(
                    self._embeddings_f32(corpus, slice(s, e)))
            self.assigned_upto = hi
            self.generation += 1
            self._dev = None
        self._rebuild_membership(corpus, lo)

    def _rebuild_membership(self, corpus, appended_from: int) -> None:
        """Maintain the padded (K, B) membership matrix.  Incremental for
        appended rows; a bucket overflow (some cell outgrew B) or a
        capacity change rebuilds from ``cell_of`` wholesale (O(N log N),
        rare by the bucketing)."""
        if self.cell_rows is None or self._cap != corpus.capacity:
            self._rebuild_full(corpus)
            return
        rows = np.arange(appended_from, self.assigned_upto)
        if rows.size == 0:
            return
        key = self.cell_of[rows].astype(np.int64)
        need = np.bincount(key, minlength=self.ncells).reshape(
            1, self.ncells)
        if (self.counts + need).max() > self.bucket:
            self._rebuild_full(corpus)
            return
        # vectorized grouped scatter with the live counts as base offsets
        # (a large streamed append must not loop per row in Python)
        order = np.argsort(key, kind="stable")
        sorted_key = key[order]
        starts = np.searchsorted(sorted_key, np.arange(self.ncells))
        rank = np.arange(rows.size) - starts[sorted_key]
        slots = self.counts.reshape(-1)[sorted_key] + rank
        self.cell_rows[sorted_key, slots] = rows[order].astype(np.int32)
        self.counts += need
        self.generation += 1
        self._dev = None

    def _rebuild_full(self, corpus) -> None:
        n = self.assigned_upto
        self._cap = corpus.capacity
        rows = np.arange(n)
        key = self.cell_of[:n].astype(np.int64)
        counts = np.bincount(key, minlength=self.ncells).reshape(
            1, self.ncells)
        self.bucket = _slot_bucket(int(counts.max(initial=1)))
        self.counts = counts
        mat = np.full((self.ncells, self.bucket), -1, dtype=np.int32)
        order = np.argsort(key, kind="stable")
        sorted_key = key[order]
        # slot index within each cell's run of the sorted order
        starts = np.searchsorted(sorted_key, np.arange(self.ncells))
        slot = np.arange(n) - starts[sorted_key]
        mat[sorted_key, slot] = rows[order].astype(np.int32)
        self.cell_rows = mat
        self.generation += 1
        self._dev = None

    # -- device copies -------------------------------------------------------

    def device_tensors(self):
        """(centroids f32, cell_rows int64) on the device, re-made when the
        generation moved."""
        if self._dev is None or self._dev_gen != self.generation:
            self._dev = (
                torch.from_numpy(self.centroids).to(self.device),
                torch.from_numpy(self.cell_rows).to(self.device,
                                                    torch.int64))
            self._dev_gen = self.generation
        return self._dev


# -- the probe ------------------------------------------------------------------


def _dequant(q_tree: Dict) -> torch.Tensor:
    emb = q_tree[E.ANN_TENSOR]
    if E.ANN_SCALE in q_tree:
        return emb.float() * q_tree[E.ANN_SCALE][:, None]
    return emb.float()


def _gathered_sims(q_tree: Dict, emb: torch.Tensor, scale, safe):
    """(Q, S) scores of each query against its own gathered rows ``safe``
    (Q, S): bf16 products summed in f32, or the exact integer dot of the
    int8 codes rescaled by both row scales (``ops.encoder.chunk_sims``'s
    arithmetic).  The rows are gathered and widened in query blocks: a
    block's gathered tile and its f32 copy together hold at most 3/4 of
    the bytes of the (Q, S, D) tile in storage width that the JAX package
    gathers at once."""
    q_emb = q_tree[E.ANN_TENSOR]
    q, s = safe.shape
    step = max(1, (q * emb.element_size()) // 8)
    out = []
    for lo in range(0, q, step):
        hi = min(q, lo + step)
        tile = emb.index_select(0, safe[lo:hi].reshape(-1)).reshape(
            hi - lo, s, -1)
        if scale is not None:
            wide = (torch.float32 if q_emb.shape[1] <= E._INT8_F32_EXACT_DIM
                    else torch.float64)
            raw = torch.bmm(tile.to(wide),
                            q_emb[lo:hi].to(wide)[:, :, None])[:, :, 0]
            out.append(raw.float())
        else:
            out.append(torch.bmm(
                tile.to(torch.bfloat16).float(),
                q_emb[lo:hi].to(torch.bfloat16).float()[:, :, None])[:, :, 0])
    sims = torch.cat(out, dim=0)
    if scale is not None:
        sims = ((sims * q_tree[E.ANN_SCALE][:, None])
                * scale.index_select(0, safe.reshape(-1)).reshape(q, s))
    return sims


def ivf_probe_topc(q_tree, emb_tree, centroids, cell_rows, corpus_valid,
                   corpus_deleted, corpus_group, query_group, query_row, *,
                   top_c: int, nprobe: int, slot_chunk: int,
                   group_filtering: bool):
    """Two-stage cell-probe retrieval: ``(top_sim (Q, C) f32, top_index
    (Q, C) int32)``, -1 for empty slots -- ``ops.encoder.
    retrieval_scan``'s contract.  The eligibility mask is ``ops.scoring.
    candidate_mask_gathered``, the scan's policy on gathered rows."""
    from .scoring import candidate_mask_gathered

    qf = _dequant(q_tree)                                    # (Q, D) f32
    q = qf.shape[0]
    cells = E._total_order_desc(qf @ centroids.T)[:, :nprobe]   # (Q, P)
    bucket = cell_rows.shape[1]
    cand = cell_rows.index_select(0, cells.reshape(-1)).reshape(
        q, nprobe * bucket)                     # corpus rows, -1 padded
    total = nprobe * bucket
    step = min(slot_chunk, _pow2(total))
    nsteps = -(-total // step)
    if nsteps * step != total:
        cand = torch.nn.functional.pad(cand, (0, nsteps * step - total),
                                       value=-1)
    emb = emb_tree[E.ANN_TENSOR]
    scale = emb_tree.get(E.ANN_SCALE)
    device = corpus_valid.device
    top_sim = torch.full((q, top_c), NEG_INF, dtype=torch.float32,
                         device=device)
    top_idx = torch.full((q, top_c), -1, dtype=torch.int32, device=device)
    for si in range(nsteps):
        rows = cand[:, si * step:(si + 1) * step]
        safe = rows.clamp_min(0)
        sims = _gathered_sims(q_tree, emb, scale, safe)
        flat = safe.reshape(-1)
        mask = candidate_mask_gathered(
            *(t.index_select(0, flat).reshape(q, step)
              for t in (corpus_valid, corpus_deleted, corpus_group)),
            rows, query_group, query_row, group_filtering)
        sims = torch.where(mask, sims, NEG_INF)
        # the running top-C first: the positional tie-break keeps its -1
        # sentinels from being displaced by all-masked slots
        merged_sim = torch.cat([top_sim, sims], dim=1)
        merged_idx = torch.cat([top_idx, rows.to(torch.int32)], dim=1)
        sel = E._total_order_desc(merged_sim)[:, :top_c]
        top_sim = merged_sim.gather(1, sel)
        top_idx = merged_idx.gather(1, sel)
    return top_sim, top_idx


def build_ivf_scorer(plan, *, top_c: int, nprobe: int,
                     group_filtering: bool = False,
                     queries_from_rows: bool = False):
    """The IVF scoring program: ``ops.scoring.build_ann_scorer``'s
    signature plus the two IVF tensors::

        fn(q_emb, qfeats, emb_tree, centroids, cell_rows, corpus_feats,
           corpus_valid, corpus_deleted, corpus_group, query_group,
           query_row, min_logit) -> (top_logit, top_index, count)

    ``count`` carries the flat program's saturation semantics
    (above-bound candidates, widened by the int8 cosine-ambiguity
    credit), so the shared escalation loop drives nprobe / C growth."""
    from . import scoring as S

    pair_logits = S.build_gathered_pair_logits(plan)
    slot_chunk = scan_slots()

    def score(q_emb, qfeats, emb_tree, centroids, cell_rows, corpus_feats,
              corpus_valid, corpus_deleted, corpus_group, query_group,
              query_row, min_logit):
        emb_tree = E.as_emb_tree(emb_tree)
        if queries_from_rows:
            qrows = query_row.clamp_min(0)
            q_tree = {name: arr.index_select(0, qrows)
                      for name, arr in emb_tree.items()}
            qfeats = S.gather_rows(corpus_feats, qrows)
        else:
            q_tree = E.as_emb_tree(q_emb)
        top_sim, top_index = ivf_probe_topc(
            q_tree, emb_tree, centroids, cell_rows, corpus_valid,
            corpus_deleted, corpus_group, query_group, query_row,
            top_c=top_c, nprobe=nprobe, slot_chunk=slot_chunk,
            group_filtering=group_filtering)
        return S.rescore_retrieved(
            pair_logits, qfeats, corpus_feats, top_sim, top_index,
            float(np.float32(min_logit)),
            amb_eps=S.retrieval_amb_eps(q_tree, emb_tree))

    return score
