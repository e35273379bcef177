"""Mesh-parallel scale-out: sharded corpus scoring driven by one process.

Counterpart of the JAX package's ``parallel`` for a single-host mesh, with
two layouts for the corpus-axis scale-out:

  * ``sharded`` / ``ann_sharded`` -- corpus record axis split over a
    ``Mesh`` of torch devices, queries replicated; every shard scores the
    block against its local rows and the lead device merges the
    per-shard top-Ks.  The layout for service-sized query batches.
  * ``ring`` -- queries split too; blocks rotate around the mesh carrying
    their running top-K.  The regime for large query blocks (bulk
    re-matching).

Multi-host meshes (process groups) are not part of this package yet.
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
