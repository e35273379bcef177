"""Mesh-sharded serving backends: the REST service over a device mesh.

Counterpart of the JAX package's ``engine/sharded_matcher.py`` over a
``parallel.sharded.Mesh`` -- one process's, or one that spans the
processes of a serving group (``parallel.multihost``), each holding its
own shards -- the ``sharded`` (``ann``) and ``sharded-brute`` (``device``)
backends:

  * ``ShardedDeviceCorpus`` keeps the append / tombstone / incremental
    update model of ``DeviceCorpus`` (the host numpy mirror stays the
    rebuildable truth) but holds one device tree per shard, on that
    shard's device: each appended range and each tombstone goes to the
    shard that owns the row (a range may straddle a shard boundary), and
    capacity grows in ``mesh.size * DEVICE_CHUNK`` granules so every
    shard holds whole scan chunks;
  * ``ShardedDeviceIndex`` / ``ShardedAnnIndex`` are the exact and the
    ``ann`` blocking backends over that corpus -- snapshots, value-slot
    growth, deletes and the ``CandidateIndex`` interface are inherited;
  * the scorer caches swap the single-device programs for the mesh ones
    (``parallel.sharded`` / ``parallel.ann_sharded``): per-shard scans
    with global row offsets, local exact rescoring, the top-K merge on the
    lead device;
  * the certified dd finalize runs on the mesh (``_MeshProgramLift``):
    the resolved block's survivors are gathered across shards to the lead
    device, then the same ``ops.scoring`` dd program runs on them with an
    identity index, bit-identical to the single-device path; a mesh that
    spans processes finalizes on the host instead (``supports_dd``).

Queries are uploaded per block and copied to every shard (never gathered
from corpus rows), escalation (K for brute force, C for ``ann``) runs
unchanged through ``_PendingBlock`` / ``resolve_block``, and host
finalization is the same double-precision path, so emitted probabilities
equal the single-device backends' (tests/test_torch_sharded_service.py).

The mesh: ``serving_mesh`` builds one process-wide mesh, by default one
shard per visible CUDA card.  ``set_serving_devices`` pins it to any list
of devices, a device possibly repeated (``[cpu] * 8`` in the CPU tests,
``[cuda:0] * 4`` in chip_smoke.py): several logical shards on one card
run one after the other and measure no scaling.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from ..core.config import DukeSchema
from ..core.records import Record
from ..parallel.sharded import (
    Mesh,
    build_replicated_gather,
    corpus_mesh,
    rule_sharding,
    split,
)
from .ann_matcher import AnnIndex, AnnProcessor, _AnnScorerCache
from .device_matcher import (
    _CHUNK,
    DeviceCorpus,
    DeviceIndex,
    DeviceProcessor,
    _count_device_bytes,
    _ScorerCache,
    _to_device,
)

logger = logging.getLogger("sharded-matcher")

_MESH_LOCK = threading.Lock()
_MESH: Optional[Mesh] = None
# this process's shard devices as set_serving_devices pinned them
_PINNED: Optional[tuple] = None


def pinned_devices() -> Optional[tuple]:
    """The devices ``set_serving_devices`` pinned (this process's
    shards), or None."""
    return _PINNED


def _global_mesh(local: Sequence) -> Mesh:
    """Join the multi-process job when one is configured (a no-op
    otherwise), then the mesh over every process's shards, ``local``
    being this process's."""
    from ..parallel import multihost

    multihost.initialize(devices=local)
    return multihost.global_corpus_mesh(local)


def set_serving_devices(devices: Optional[Sequence]) -> Optional[Mesh]:
    """Pin the process-wide serving mesh to ``devices`` (one shard each, a
    device may repeat), or with None drop it so the next ``serving_mesh``
    builds the default.  In a multi-process job (``JAX_COORDINATOR_ADDRESS``
    set) ``devices`` are this process's shards and the mesh spans every
    rank's.  Call before the first sharded workload is built: workloads
    keep the mesh they were built on."""
    global _MESH, _PINNED
    pinned = (tuple(torch.device(d) for d in devices)
              if devices is not None else None)
    mesh = _global_mesh(corpus_mesh(pinned).devices) if pinned else None
    with _MESH_LOCK:
        _MESH, _PINNED = mesh, pinned
    telemetry.MESH_DEVICES.set(mesh.size if mesh is not None else 0)
    return mesh


def serving_mesh(device=None) -> Mesh:
    """The process-wide 1-D corpus mesh the sharded backends serve from:
    the pinned one (``set_serving_devices``), else one shard per visible
    CUDA card, or for a CPU ``device`` a one-shard mesh on it -- joined
    with every other process's shards when a multi-process job is
    configured (``parallel.multihost``).  One mesh for all workloads, so
    hot config reloads keep it."""
    global _MESH
    dev = torch.device(device) if device is not None else None
    with _MESH_LOCK:
        mesh, built = _MESH, False
        if mesh is None:
            local = corpus_mesh(None if dev is None or dev.type == "cuda"
                                else [dev]).devices
            mesh = _global_mesh(local)
            _MESH, built = mesh, True
    if dev is not None and mesh.lead.type != dev.type:
        raise ValueError(f"the serving mesh {mesh} is not on {dev}")
    if built:
        telemetry.MESH_DEVICES.set(mesh.size)
        logger.info("serving mesh: %d shard(s) on %s%s", mesh.size,
                    sorted({str(d) for d in mesh.devices}),
                    f" (rank {mesh.rank} of {mesh.world})"
                    if mesh.spans_processes else "")
    return mesh


class ShardedDeviceCorpus(DeviceCorpus):
    """``DeviceCorpus`` whose device copy is split on the record axis:
    ``device_arrays`` returns per-shard lists, shard s holding rows
    ``[s * L, (s + 1) * L)`` of the capacity on ``mesh.devices[s]``.

    Capacity grows in ``mesh.size * chunk`` granules (every shard always
    holds whole scan chunks -- the mesh scorers' per-shard ``row_offset``
    arithmetic needs it).  The arena leases the total: it knows no
    mesh."""

    def __init__(self, plan, mesh: Mesh):
        super().__init__(plan, mesh.lead)
        self.mesh = mesh
        # the granule of parallel.sharded.ShardedCorpus
        self.granule = mesh.size * _CHUNK

    def _local_cap(self) -> int:
        return self.capacity // self.mesh.size

    def _shard_rows(self, lo: int, hi: int):
        """(local shard, local lo, local hi, global lo, global hi) for each
        of this process's shards the global range ``[lo, hi)`` touches."""
        local = self._local_cap()
        base = self.mesh.shard_base
        first = max(lo // local, base)
        last = min((hi - 1) // local, base + self.mesh.local_size - 1)
        for g in range(first, last + 1):
            a, b = max(lo, g * local), min(hi, (g + 1) * local)
            yield g - base, a - g * local, b - g * local, a, b

    def _upload_full(self) -> None:
        cap, mesh = self.capacity, self.mesh
        per_prop = {
            prop: split(mesh, {name: arr[:cap]
                               for name, arr in tensors.items()},
                        lambda rows, dev, p=prop: _to_device(rows, dev, p))
            for prop, tensors in self.feats.items()}
        self._device_feats = [
            {prop: parts[s] for prop, parts in per_prop.items()}
            for s in range(mesh.local_size)]
        masks = [split(mesh, arr[:cap], _to_device)
                 for arr in (self.row_valid, self.row_deleted,
                             self.row_group)]
        self._device_masks = list(zip(*masks))

    def _upload_rows(self, lo: int, hi: int) -> None:
        masks = (self.row_valid, self.row_deleted, self.row_group)
        for s, a, b, ga, gb in self._shard_rows(lo, hi):
            dev = self.mesh.devices[s]
            shard = self._device_feats[s]
            for prop, tensors in self.feats.items():
                for name, arr in tensors.items():
                    shard[prop][name][a:b] = _to_device(arr[ga:gb], dev,
                                                        prop)
            for t, arr in zip(self._device_masks[s], masks):
                t[a:b] = _to_device(arr[ga:gb], dev)

    def _upload_mask_rows(self, rows: List[int]) -> None:
        local = self._local_cap()
        rows = np.asarray(rows, dtype=np.int64)
        for s, dev in enumerate(self.mesh.devices):
            g = self.mesh.shard_base + s
            mine = rows[rows // local == g]
            if mine.size == 0:
                continue
            idx = _to_device(mine - g * local, dev)
            valid, deleted, _ = self._device_masks[s]
            valid[idx] = _to_device(self.row_valid[mine], dev)
            deleted[idx] = _to_device(self.row_deleted[mine], dev)

    def _arrays(self):
        masks = self._device_masks
        return (self._device_feats, [m[0] for m in masks],
                [m[1] for m in masks], [m[2] for m in masks])

    def _device_nbytes(self) -> int:
        # each process leases the bytes of the shards it holds
        total = super()._device_nbytes()
        return total * self.mesh.local_size // self.mesh.size

    def device_bytes(self):
        out = {"corpus_tensors": 0, "corpus_embeddings": 0, "int8_scales": 0}
        feats, masks = self._device_feats, self._device_masks
        for s in range(len(feats or ())):
            _count_device_bytes(out, feats[s], masks[s])
        return out


class _MeshProgramLift:
    """What both mesh scorer caches share: queries upload (and are copied
    to every shard) instead of being gathered from corpus rows, and the dd
    survivor rescore runs through a gather to the lead device."""

    queries_from_rows = False

    def __init__(self, index):
        super().__init__(index)
        self.mesh = index.mesh

    @property
    def supports_dd(self) -> bool:
        """The dd survivor gather needs every shard in this process: a
        mesh that spans processes finalizes on the host (the frontend
        runs finalization alone, so a gather across processes would be a
        collective the followers never enter), as the JAX package does."""
        return not self.mesh.spans_processes

    # single-writer mesh observability (plain ints, snapshotted at scrape
    # time by service/metrics.py -- never a registry write here)
    _dd_gathers = 0
    _dd_gather_rows = 0

    def _dd_call(self, fn, qfeats, cfeats_all, names, query_row,
                 top_index: np.ndarray):
        """Certified dd finalize over the mesh: gather the resolved
        block's (Q, K) survivors from the split corpus tensors into one
        compact block on the lead device, then run the SAME single-device
        dd program on it with an identity index.  Clipping ``top_index``
        before the gather reproduces the single-device "-1 gathers row 0"
        semantics, so the verdicts are bit-identical."""
        gather = getattr(self, "_dd_gather_fn", None)
        if gather is None:
            gather = self._dd_gather_fn = build_replicated_gather(self.mesh)
        q, k = top_index.shape
        rows = np.clip(top_index, 0, None).reshape(-1)
        gathered = gather([{name: shard[name] for name in names}
                           for shard in cfeats_all], rows)
        self._dd_gathers += 1
        self._dd_gather_rows += int(q * k)
        ident = torch.arange(q * k, dtype=torch.int32,
                             device=self.mesh.lead).reshape(q, k)
        return fn(qfeats, gathered, query_row, ident)


class _ShardedScorerCache(_MeshProgramLift, _ScorerCache):
    """Brute-force scorer cache over the mesh (parallel.sharded)."""

    def _build(self, top_k: int, group_filtering: bool, from_rows: bool):
        from ..parallel.sharded import build_sharded_scorer

        return build_sharded_scorer(
            self.index.plan, self.mesh, chunk=_CHUNK, top_k=top_k,
            group_filtering=group_filtering)


class _ShardedAnnScorerCache(_MeshProgramLift, _AnnScorerCache):
    """``ann`` scorer cache over the mesh (parallel.ann_sharded), with
    the single-device call convention: the per-shard embedding trees ride
    beside the per-shard property trees and are put back together per
    shard."""

    def _split_embedding(self, cfeats_all):
        pairs = [super(_ShardedAnnScorerCache, self)._split_embedding(tree)
                 for tree in cfeats_all]
        return [p[0] for p in pairs], [p[1] for p in pairs]

    @staticmethod
    def _rejoin(corpus_emb, corpus_feats):
        from ..ops import encoder as E

        return [dict(feats, **{E.ANN_PROP: emb})
                for emb, feats in zip(corpus_emb, corpus_feats)]

    def _build(self, top_c: int, group_filtering: bool, from_rows: bool):
        from ..parallel.ann_sharded import build_sharded_ann_scorer

        base = build_sharded_ann_scorer(
            self.index.plan, self.mesh, chunk=_CHUNK, top_c=top_c,
            group_filtering=group_filtering)

        def call(q_emb, qfeats, corpus_emb, corpus_feats, cvalid, cdeleted,
                 cgroup, query_group, query_row, min_logit):
            return base(q_emb, qfeats, self._rejoin(corpus_emb, corpus_feats),
                        cvalid, cdeleted, cgroup, query_group, query_row,
                        min_logit)

        return call

    def _build_ivf(self, top_c: int, nprobe: int, group_filtering: bool,
                   from_rows: bool):
        from ..parallel.ann_sharded import build_sharded_ivf_scorer

        base = build_sharded_ivf_scorer(
            self.index.plan, self.mesh, top_c=top_c, nprobe=nprobe,
            group_filtering=group_filtering)

        def call(q_emb, qfeats, corpus_emb, centroids, cell_rows,
                 corpus_feats, cvalid, cdeleted, cgroup, query_group,
                 query_row, min_logit):
            return base(q_emb, qfeats, self._rejoin(corpus_emb, corpus_feats),
                        centroids, cell_rows, cvalid, cdeleted, cgroup,
                        query_group, query_row, min_logit)

        return call

    def _ivf_placers(self):
        """The shared partition rules: the small centroid table is copied
        to every shard, the stacked (nshards * K, B) membership matrix of
        local rows splits so each shard gets its own (K, B) block."""
        mesh = self.mesh
        repl = rule_sharding(mesh, "centroids")
        split = rule_sharding(mesh, "ivf_membership")
        return (lambda a: repl(torch.from_numpy(a)),
                lambda a: split(torch.from_numpy(a).to(torch.int64)))


class ShardedDeviceIndex(DeviceIndex):
    """Exact brute-force blocking over a record-axis-split corpus."""

    def __init__(self, schema: DukeSchema, *, device=None,
                 mesh: Optional[Mesh] = None):
        # the corpus factory runs inside super().__init__
        self.mesh = mesh if mesh is not None else serving_mesh(device)
        super().__init__(schema, device=self.mesh.lead)
        self.scorer_cache = _ShardedScorerCache(self)

    def _make_corpus(self, plan) -> ShardedDeviceCorpus:
        return ShardedDeviceCorpus(plan, self.mesh)


class ShardedAnnIndex(AnnIndex):
    """Embedding-ANN blocking over a record-axis-split corpus: corpus
    embeddings and feature tensors split over the mesh, per-shard cosine
    top-C and local exact rescoring, the merge on the lead device.
    Everything else -- encoder, snapshots, recall escalation -- is
    ``AnnIndex``."""

    def __init__(self, schema: DukeSchema, *, device=None,
                 mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else serving_mesh(device)
        super().__init__(schema, device=self.mesh.lead)
        self.scorer_cache = _ShardedAnnScorerCache(self)

    def _make_corpus(self, plan) -> ShardedDeviceCorpus:
        return ShardedDeviceCorpus(plan, self.mesh)

    def _ivf_shards(self) -> int:
        # the IVF membership matrix stacks per-shard (K, B) blocks of
        # LOCAL row ids, so the split hands each shard its own block
        return self.mesh.size

    def _explain_retrieve(self, record: Record, group_filtering: bool):
        """On a mesh that spans processes the explain replay's retrieval
        goes through the serving group's op stream: under the op lock the
        frontend broadcasts an ``explain`` op and every process runs the
        same block program on the global mesh (a collective the followers
        never entered would pair with their next one), so the rank it
        reports is among the whole corpus's rows, the JAX package's
        retrieval provenance.  Called with the workload lock held."""
        from ..parallel import dispatch

        d = dispatch.current()
        key = getattr(self, "_dispatch_key", None)
        if d is None or key is None or not self.mesh.spans_processes:
            return super()._explain_retrieve(record, group_filtering)
        with d.op_lock:
            d.broadcast(dispatch.with_trace_ctx(
                ("explain", key, record, group_filtering)))
            with dispatch.latch_on_failure(
                    d, "frontend explain retrieval aborted after broadcast"):
                return super()._explain_retrieve(record, group_filtering)


# the JAX package's processor names: a mesh index needs nothing of its
# processor that the single-device one lacks
ShardedDeviceProcessor = DeviceProcessor
ShardedAnnProcessor = AnnProcessor
