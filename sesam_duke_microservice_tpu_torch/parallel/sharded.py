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

One process drives every shard, as the JAX package's single-controller
``jit`` does: shard s's scan runs on its own device with
``row_offset = s * L``, so self-exclusion and the returned row ids stay
global.  A device may repeat in a mesh (``[cuda:0] * 4``): the shards then
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
    order.  A device may repeat (several logical shards on one card)."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """Where merged results land (the replicated layout's home)."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


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
    """The record-axis layout: shard s gets rows ``[s * L, (s + 1) * L)``
    of every leaf, moved by ``put(rows, mesh.devices[s])`` -- by default
    ``.to`` (a view where the device is the tensor's own); host arrays
    pass their upload function."""
    n = first_leaf(tree).shape[0]
    if n % mesh.size:
        raise ValueError(f"leading axis {n} does not split over "
                         f"{mesh.size} shards")
    local = n // mesh.size
    return [tree_map(lambda t, s=s, d=dev: put(
                t[s * local:(s + 1) * local], d), tree)
            for s, dev in enumerate(mesh.devices)]


def rule_sharding(mesh: Mesh, family: str) -> Callable:
    """The placement of ``family`` (a PARTITION_RULES key): a function of
    a tensor tree returning the per-shard list."""
    rule = PARTITION_RULES[family]
    if rule == "split":
        return lambda tree: split(mesh, tree)
    return lambda tree: replicate(mesh, tree)


def shard_offsets(mesh: Mesh, local_cap: int) -> List[int]:
    """Per-shard global row offset."""
    return [s * int(local_cap) for s in range(mesh.size)]


def merge_topk(mesh: Mesh, top_logit: Sequence[torch.Tensor],
               top_index: Sequence[torch.Tensor], top_k: int):
    """Reduce per-shard (Q, K) candidates to the global top-K on the lead
    device: ``(out_logit, out_index, merged_logit (Q, D*K))``.

    The layout is the JAX merge's transpose: query q's row holds shard 0's
    K entries first, then shard 1's, ...; the STABLE descending sort then
    breaks ties by that position, as ``lax.top_k`` does."""
    lead = mesh.lead
    logits = torch.stack([t.to(lead) for t in top_logit], dim=1)  # (Q,D,K)
    index = torch.stack([t.to(lead) for t in top_index], dim=1)
    q = logits.shape[0]
    merged_logit = logits.reshape(q, -1)
    merged_index = index.reshape(q, -1)
    order = torch.sort(merged_logit, dim=1, descending=True,
                       stable=True).indices[:, :top_k]
    return (merged_logit.gather(1, order), merged_index.gather(1, order),
            merged_logit)


def sum_counts(mesh: Mesh, counts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-shard (Q,) int32 counts summed on the lead device (in int64,
    returned int32 as every scorer's count is)."""
    lead = mesh.lead
    total = counts[0].to(lead, torch.int64)
    for c in counts[1:]:
        total = total + c.to(lead, torch.int64)
    return total.to(torch.int32)


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
        for s in range(mesh.size):
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
    rescore them with an identity ``top_index``."""
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
                for s in range(self.mesh.size)]


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
