"""Sharded corpus scoring over a 1-D device mesh, driven by one process.

Counterpart of the JAX package's ``parallel/sharded.py``.  Data layout:

  * corpus feature tensors: split along the record axis -- shard s holds
    rows ``[s * L, (s + 1) * L)`` of a capacity ``D * L`` on
    ``mesh.devices[s]``, every shard whole scan chunks;
  * query block: replicated -- every shard scores the same queries against
    its local rows, so no query-side traffic but one copy per device;
  * merge: each shard's local (Q, K) top-K goes to the lead device
    (``mesh.devices[0]``), where ``merge_topk`` reduces the D candidate
    lists to the global top-K.  Only Q * K * D pairs move, never the
    candidate matrix.

One process drives every shard it holds, as the JAX package's
single-controller ``jit`` does: shard s's scan runs on its own device
with ``row_offset = s * L``, so self-exclusion and the returned row ids
stay global.  A mesh may span processes (``parallel.multihost``): each
process then holds the shards of its rank (rank-major global order), the
merge gathers every process's local top-Ks with one ``all_gather`` and
the counts sum with one integer ``all_reduce``, so every process gets the
same merged result bit for bit; a one-process mesh keeps its plain
transfers.  A device may repeat in a mesh (``[cuda:0] * 4``): the shards then
run one after the other on that card, which proves the layout, the global
row offsets and the merge, and measures no scaling.  Every record-axis
split of a whole tree goes through ``split``; the IVF placers of
``engine.sharded_matcher`` read their families' layout from
``PARTITION_RULES``.

Exactness: each shard's top-K is ordered by (logit descending, row
ascending), with ``-1`` in its empty slots; the merge lays the shards out
shard 0's K first, then shard 1's, ..., and a stable descending sort
keeps the lower position among equal logits -- so the merged top-K equals
the single-device scan's, ties and ``-1`` fill included
(tests/test_torch_parallel.py holds it against the JAX scorers).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import scoring as S

# Partition rules of the IVF families (read by the IVF placers in
# engine/sharded_matcher.py through ``rule_sharding``): the stacked
# membership matrix of shard-local rows splits on its leading axis, the
# small centroid table is copied to every shard.  The corpus tensors always
# split (``split``, ``LeadingAxisPlacer``) and the scorers' query blocks
# always replicate (``replicate``).
PARTITION_RULES: Dict[str, str] = {
    "ivf_membership": "split",
    "centroids": "replicate",
}


class Mesh:
    """A 1-D mesh: one ``torch.device`` per shard, shard order = axis
    order.  A device may repeat (several logical shards on one card).

    ``devices`` are THIS process's shards.  A mesh that spans processes
    (``world`` > 1, built by ``parallel.multihost.global_corpus_mesh``)
    has ``world * len(devices)`` shards in all, rank-major: this
    process's shards are the global shards ``shard_base ..
    shard_base + local_size - 1``; ``backend`` is the job's collective
    backend."""

    def __init__(self, devices: Sequence, *, world: int = 1, rank: int = 0,
                 backend: Optional[str] = None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.world = world
        self.rank = rank
        self.backend = backend

    @property
    def local_size(self) -> int:
        """Shards this process holds (the length of every per-shard
        list)."""
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards of the whole mesh, every process's."""
        return len(self.devices) * self.world

    @property
    def shard_base(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * len(self.devices)

    @property
    def spans_processes(self) -> bool:
        return self.world > 1

    @property
    def lead(self) -> torch.device:
        """Where merged results land (the replicated layout's home)."""
        return self.devices[0]

    def local(self) -> "Mesh":
        """This process's shards as a mesh of one process (itself when
        the mesh is one process's already)."""
        return self if self.world == 1 else Mesh(self.devices)

    def __repr__(self) -> str:
        where = (f", rank {self.rank} of {self.world}"
                 if self.spans_processes else "")
        return f"Mesh({[str(d) for d in self.devices]}{where})"


def corpus_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the given devices, else one shard per visible
    CUDA card."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError(
                "no CUDA device is available for the default mesh; pass "
                "the devices explicitly (e.g. [torch.device('cpu')] * 8)")
    return Mesh(devices)


def tree_map(fn, tree):
    """``fn`` over the tensor leaves of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def replicate(mesh: Mesh, tree) -> List:
    """The replicated layout: one copy of ``tree`` per shard, on its
    device; shards on one device share one copy (no transfer when the
    tree already lives there)."""
    copies: Dict[torch.device, object] = {}
    out = []
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = tree_map(
                lambda t, d=dev: t.to(d, non_blocking=True), tree)
        out.append(copies[dev])
    return out


def _to(t, dev):
    return t.to(dev, non_blocking=True)


def split(mesh: Mesh, tree, put: Callable = _to) -> List:
    """The record-axis layout: global shard g gets rows
    ``[g * L, (g + 1) * L)`` of every leaf, moved by
    ``put(rows, device)`` -- by default ``.to`` (a view where the device
    is the tensor's own); host arrays pass their upload function.  Only
    this process's shards are placed (the list is per local shard)."""
    n = first_leaf(tree).shape[0]
    if n % mesh.size:
        raise ValueError(f"leading axis {n} does not split over "
                         f"{mesh.size} shards")
    local = n // mesh.size
    base = mesh.shard_base
    return [tree_map(lambda t, g=base + s, d=dev: put(
                t[g * local:(g + 1) * local], d), tree)
            for s, dev in enumerate(mesh.devices)]


def rule_sharding(mesh: Mesh, family: str) -> Callable:
    """The placement of ``family`` (a PARTITION_RULES key): a function of
    a tensor tree returning the per-shard list."""
    rule = PARTITION_RULES[family]
    if rule == "split":
        return lambda tree: split(mesh, tree)
    return lambda tree: replicate(mesh, tree)


def shard_offsets(mesh: Mesh, local_cap: int) -> List[int]:
    """Global row offset of each of this process's shards."""
    return [(mesh.shard_base + s) * int(local_cap)
            for s in range(mesh.local_size)]


def merge_topk(mesh: Mesh, top_logit: Sequence[torch.Tensor],
               top_index: Sequence[torch.Tensor], top_k: int):
    """Reduce per-shard (Q, K) candidates to the global top-K on the lead
    device: ``(out_logit, out_index, merged_logit (Q, D*K))``.

    The layout is the JAX merge's transpose: query q's row holds shard 0's
    K entries first, then shard 1's, ...; the STABLE descending sort then
    breaks ties by that position, as ``lax.top_k`` does.  On a mesh that
    spans processes one ``all_gather`` brings every rank's (Q, L, K)
    block, laid out rank-major -- the global shard order -- so every
    process sorts the same merged row and gets the same result."""
    lead = mesh.lead
    logits = torch.stack([t.to(lead) for t in top_logit], dim=1)  # (Q,L,K)
    index = torch.stack([t.to(lead) for t in top_index], dim=1)
    if mesh.spans_processes:
        from . import multihost

        parts = multihost.all_gather(mesh, [logits, index])
        logits = torch.cat([p[0] for p in parts], dim=1)  # (Q, D, K)
        index = torch.cat([p[1] for p in parts], dim=1)
    q = logits.shape[0]
    merged_logit = logits.reshape(q, -1)
    merged_index = index.reshape(q, -1)
    order = torch.sort(merged_logit, dim=1, descending=True,
                       stable=True).indices[:, :top_k]
    return (merged_logit.gather(1, order), merged_index.gather(1, order),
            merged_logit)


def sum_counts(mesh: Mesh, counts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-shard (Q,) int32 counts summed on the lead device (in int64,
    returned int32 as every scorer's count is); across processes one
    integer ``all_reduce``."""
    lead = mesh.lead
    total = counts[0].to(lead, torch.int64)
    for c in counts[1:]:
        total = total + c.to(lead, torch.int64)
    if mesh.spans_processes:
        from . import multihost

        total = multihost.all_reduce(mesh, total, "sum")
    return total.to(torch.int32)


def max_counts(mesh: Mesh, counts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-shard (Q,) int32 counts' maximum on the lead device; across
    processes one integer ``all_reduce``."""
    lead = mesh.lead
    out = torch.stack([c.to(lead) for c in counts]).amax(dim=0)
    if mesh.spans_processes:
        from . import multihost

        out = multihost.all_reduce(mesh, out, "max")
    return out


def gather_shards(mesh: Mesh, per_shard: Sequence[torch.Tensor]):
    """Per-shard tensors of equal shapes concatenated in global shard
    order, on the host as numpy: local transfers, and across processes
    one ``all_gather`` that every process enters (the ring's
    query-split outputs)."""
    local = torch.cat([t.to(mesh.lead) for t in per_shard])
    if not mesh.spans_processes:
        return local.cpu().numpy()
    from . import multihost

    parts = multihost.all_gather(mesh, [local])
    return torch.cat([p[0] for p in parts]).cpu().numpy()


def build_sharded_scorer(plan, mesh: Mesh, *, chunk: int = 512,
                         top_k: int = 64,
                         group_filtering: bool = False) -> Callable:
    """``ops.scoring.build_corpus_scorer`` over a record-axis-split corpus::

        fn(qfeats, corpus_feats, corpus_valid, corpus_deleted, corpus_group,
           query_group, query_row, min_logit)
        -> (top_logit (Q, K), top_index (Q, K) global rows, count (Q,))

    ``corpus_*`` are per-shard lists (``ShardedCorpus.place``, or a
    ``ShardedDeviceCorpus``' ``device_arrays``), every shard's capacity a
    multiple of ``chunk``; the query side is one tree on any device, copied
    to each shard's device.  The outputs land on the lead device."""
    pair_logits = S.build_pair_logits(plan)

    def score(qfeats, corpus_feats, corpus_valid, corpus_deleted,
              corpus_group, query_group, query_row, min_logit):
        offsets = shard_offsets(mesh, corpus_valid[0].shape[0])
        qf, qg, qr = (replicate(mesh, t)
                      for t in (qfeats, query_group, query_row))
        tl, ti, cnt = [], [], []
        for s in range(mesh.local_size):
            out = S.scan_topk(
                pair_logits, qf[s], corpus_feats[s], corpus_valid[s],
                corpus_deleted[s], corpus_group[s], qg[s], qr[s], min_logit,
                chunk=chunk, top_k=top_k, group_filtering=group_filtering,
                row_offset=offsets[s])
            tl.append(out[0])
            ti.append(out[1])
            cnt.append(out[2])
        out_logit, out_index, _ = merge_topk(mesh, tl, ti, top_k)
        return out_logit, out_index, sum_counts(mesh, cnt)

    return score


def build_replicated_gather(mesh: Mesh) -> Callable:
    """Gather corpus rows from record-axis-split trees into one compact
    tree on the lead device.

    ``gather(cfeats, rows)``: ``cfeats`` the per-shard trees, ``rows`` a
    flat host vector of global (non-negative) row ids; returns the tree of
    ``(len(rows), ...)`` tensors.  Each shard gathers the rows it owns on
    its own device and only those rows travel.  This is the bridge that
    lets the sharded backends reuse the single-device dd rescore program
    bit for bit: gather a resolved block's (Q, K) survivors here, then
    rescore them with an identity ``top_index``.  One process's mesh
    only: a row of another process's shard is not here to gather."""
    if mesh.spans_processes:
        raise ValueError("the replicated gather needs every shard in this "
                         "process")
    lead = mesh.lead

    def gather(cfeats, rows):
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        local = first_leaf(cfeats[0]).shape[0]
        shard = rows // local
        out = tree_map(
            lambda t: torch.empty((rows.size,) + tuple(t.shape[1:]),
                                  dtype=t.dtype, device=lead), cfeats[0])
        for s, dev in enumerate(mesh.devices):
            pos = np.nonzero(shard == s)[0]
            if pos.size == 0:
                continue
            src = torch.from_numpy(rows[pos] - s * local).to(dev)
            dst = torch.from_numpy(pos).to(lead)

            def put(o, t, src=src, dst=dst):
                o.index_copy_(0, dst, t.index_select(0, src).to(lead))
                return o

            _zip_apply(put, out, cfeats[s])
        return out

    return gather


def _zip_apply(fn, out, tree):
    if isinstance(out, dict):
        for k in out:
            _zip_apply(fn, out[k], tree[k])
    else:
        fn(out, tree)


class LeadingAxisPlacer:
    """Shared placement machinery: pad the leading axis of host arrays to
    ``granule`` multiples and split it over the mesh.

    Base for ``ShardedCorpus`` (record axis, granule = mesh.size * chunk)
    and ``parallel.ring.RingQueryPlacer`` (query axis, granule =
    mesh.size) -- one copy of the padding convention; the split is
    ``split``'s."""

    def __init__(self, mesh: Mesh, granule: int):
        self.mesh = mesh
        self.granule = granule

    def padded_capacity(self, size: int) -> int:
        g = self.granule
        return max(g, ((size + g - 1) // g) * g)

    def _put(self, arr: np.ndarray, size: int, cap: int, fill=0,
             prop: Optional[str] = None) -> List[torch.Tensor]:
        """A host array padded to ``cap`` rows, one slice per shard on
        its device (uint16 chars widen to int32, the card's layout)."""
        from ..engine.device_matcher import _to_device

        if arr.shape[0] != cap:
            out = np.full((cap,) + arr.shape[1:], fill, dtype=arr.dtype)
            out[:size] = arr[:size]
            arr = out
        return split(self.mesh, arr,
                     lambda rows, dev: _to_device(rows, dev, prop))

    def _put_tree(self, feats: Dict[str, Dict[str, np.ndarray]],
                  size: int, cap: int) -> List[Dict]:
        per = {prop: {name: self._put(arr, size, cap, prop=prop)
                      for name, arr in tensors.items()}
               for prop, tensors in feats.items()}
        return [{prop: {name: parts[s] for name, parts in tensors.items()}
                 for prop, tensors in per.items()}
                for s in range(self.mesh.local_size)]


class ShardedCorpus(LeadingAxisPlacer):
    """Places host corpus arrays onto the mesh, record-axis split.

    The capacity is padded up to a multiple of ``mesh.size * chunk`` so
    every shard gets the same number of whole scan chunks (padding rows
    are ``valid=False`` and masked out by the scorer)."""

    def __init__(self, mesh: Mesh, *, chunk: int = 512):
        super().__init__(mesh, mesh.size * chunk)
        self.chunk = chunk

    def place(self, feats: Dict[str, Dict[str, np.ndarray]],
              row_valid: np.ndarray, row_deleted: np.ndarray,
              row_group: np.ndarray):
        """Pad to the shard granule and split over the mesh: returns
        (feats, valid, deleted, group), each a per-shard list."""
        size = row_valid.shape[0]
        cap = self.padded_capacity(size)
        return (self._put_tree(feats, size, cap),
                self._put(row_valid, size, cap, False),
                self._put(row_deleted, size, cap, False),
                self._put(row_group, size, cap, -1))
