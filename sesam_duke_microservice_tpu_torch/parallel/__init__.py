"""Mesh-parallel scale-out: sharded corpus scoring.

Counterpart of the JAX package's ``parallel``, with two layouts for the
corpus-axis scale-out:

  * ``sharded`` / ``ann_sharded`` -- corpus record axis split over a
    ``Mesh`` of torch devices, queries replicated; every shard scores the
    block against its local rows and the lead device merges the
    per-shard top-Ks.  The layout for service-sized query batches.
  * ``ring`` -- queries split too; blocks rotate around the mesh carrying
    their running top-K.  The regime for large query blocks (bulk
    re-matching).

A mesh may span processes: ``multihost`` joins a ``torch.distributed``
job and builds the global mesh (each process holding its own shards), and
``dispatch`` is the serving group that keeps the processes in lockstep --
the frontend broadcasts every mesh operation, the followers replay it.
"""

from .ann_sharded import build_sharded_ann_scorer, build_sharded_ivf_scorer
from .ring import RingQueryPlacer, build_ring_scorer
from .sharded import (
    Mesh,
    ShardedCorpus,
    build_replicated_gather,
    build_sharded_scorer,
    corpus_mesh,
    merge_topk,
)

__all__ = [
    "Mesh",
    "RingQueryPlacer",
    "ShardedCorpus",
    "build_replicated_gather",
    "build_ring_scorer",
    "build_sharded_ann_scorer",
    "build_sharded_ivf_scorer",
    "build_sharded_scorer",
    "corpus_mesh",
    "merge_topk",
]
