"""Multi-process scale-out: a ``torch.distributed`` job and its global
corpus mesh.

Counterpart of the JAX package's ``parallel/multihost.py``.  One Python
process per host (or per card); ``initialize`` joins the job through a
``torch.distributed.TCPStore`` at the coordinator address, and the global
corpus mesh's record axis spans every process's local shards:

  * the corpus axis shards over ALL processes' shards, rank-major: rank
    r's local shards follow rank r-1's, so global shard ``r * L + s`` is
    rank r's local shard s (every rank holds the same number ``L``);
  * every process keeps the whole host mirror (bit-identical across the
    group, ``parallel/dispatch.py`` invariant 1) and places only its own
    shards on its devices;
  * the only cross-process traffic of a scoring pass is the top-K merge:
    one ``all_gather`` of each process's local (Q, L, K) logits and
    global row ids, and one integer ``all_reduce`` of the candidate
    counts (``parallel.sharded``); the ring rematch hands its blocks
    across the process boundary point to point (``parallel.ring``).

``initialize()`` reads the JAX package's env names --
``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID`` --
and is a no-op (False) when nothing configures a coordinator, so the same
entry point serves one process or a group.  The JAX module's Cloud-TPU
metadata auto-detect has no counterpart: a GPU job always names its
coordinator.

The collective backend follows the layout, decided once at start-up from
every rank's shard devices (exchanged through the store) and never as a
retry after a failure:

  * ``gloo`` for a mesh on the CPU;
  * ``nccl`` when each rank has a card of its own;
  * ``gloo`` when ranks share a card (NCCL refuses two ranks on one
    device): the corpus tensors and the kernels stay on the card, and
    each collective's few (Q, K) tensors cross through host memory
    (``_to_wire``).

``init_process_group`` gets an explicit ``timeout``
(``COLLECTIVE_TIMEOUT_S``): a process that stops entering the lockstep
collectives fails its peers' collective in seconds, loudly, instead of
hanging them.
"""

from __future__ import annotations

import datetime
import json
import logging
import socket
import threading
from typing import List, Optional, Sequence

import torch

from ..env import env_str

logger = logging.getLogger("multihost")

# a collective whose peer never arrives raises after this long (gloo and
# nccl both honour the process group's timeout per operation)
COLLECTIVE_TIMEOUT_S = 60.0
# joining the job: every rank must reach the store within this window
RENDEZVOUS_TIMEOUT_S = 300.0

_LAYOUT_KEY = "sesam_duke/layout/{}"


class Job:
    """The joined job: world size, this process's rank, the store (also
    the dispatcher's KV rendezvous) and the collective backend."""

    def __init__(self, world: int, rank: int, store, backend: str,
                 local_shards: int):
        self.world = world
        self.rank = rank
        self.store = store
        self.backend = backend
        self.local_shards = local_shards


_LOCK = threading.Lock()
_JOB: Optional[Job] = None


def job() -> Optional[Job]:
    """The joined job, or None for a single-process run."""
    return _JOB


def process_count() -> int:
    return _JOB.world if _JOB is not None else 1


def process_index() -> int:
    return _JOB.rank if _JOB is not None else 0


def _int_env(name: str) -> Optional[int]:
    raw = env_str(name)
    return int(raw) if raw and raw.isdigit() else None


def default_local_devices(device: str = "cuda") -> List[torch.device]:
    """This process's shard devices when the caller names none: the
    pinned serving devices (``engine.sharded_matcher.set_serving_devices``),
    else one shard on the CPU for a ``cpu`` device, else one shard per
    visible CUDA card (one on the CPU when there is none)."""
    from ..engine import sharded_matcher as SM

    pinned = SM.pinned_devices()
    if pinned is not None:
        return list(pinned)
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 0
    if n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")]


def _card_identity(dev: torch.device) -> str:
    """A card's identity across processes: its UUID where torch reports
    one (two processes with different CUDA_VISIBLE_DEVICES may call one
    card by two indices), else host and index."""
    uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None)
    if uuid is not None:
        return str(uuid)
    return f"{socket.gethostname()}/{dev.index or 0}"


def choose_backend(layouts: Sequence[dict]) -> str:
    """The collective backend for every rank's shard layout (each a
    ``{"types": [...], "cards": [...]}`` record): gloo on the CPU, nccl
    when the ranks' cards are disjoint, gloo when two ranks share one."""
    types = {t for lay in layouts for t in lay["types"]}
    if types == {"cpu"}:
        return "gloo"
    if types != {"cuda"}:
        raise RuntimeError(
            f"a serving mesh needs every shard on one device type; the "
            f"ranks' shards are on {sorted(types)}")
    owners = {}
    for rank, lay in enumerate(layouts):
        for card in set(lay["cards"]):
            if card in owners and owners[card] != rank:
                return "gloo"
            owners[card] = rank
    return "nccl"


def _exchange_layout(store, world: int, rank: int,
                     devices: Sequence[torch.device]) -> List[dict]:
    mine = {
        "types": [d.type for d in devices],
        "cards": [_card_identity(d) for d in devices if d.type == "cuda"],
        "shards": len(devices),
    }
    store.set(_LAYOUT_KEY.format(rank), json.dumps(mine))
    keys = [_LAYOUT_KEY.format(r) for r in range(world)]
    store.wait(keys, datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    layouts = [json.loads(store.get(k).decode()) for k in keys]
    counts = {lay["shards"] for lay in layouts}
    if len(counts) != 1:
        raise RuntimeError(
            f"every process must serve the same number of shards (the "
            f"record axis splits evenly); the ranks serve "
            f"{[lay['shards'] for lay in layouts]}")
    return layouts


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               devices: Optional[Sequence] = None) -> bool:
    """Join (or skip) the multi-process job; True when it spans processes.

    Arguments default from ``JAX_COORDINATOR_ADDRESS`` (``host:port``;
    rank 0 hosts the store there), ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``.  With no coordinator this is a single-process
    run: nothing happens and it returns False.  Idempotent: the service
    entry point joins first, and every sharded index construction calls
    through ``serving_mesh`` again.  ``devices`` are this process's shard
    devices (default ``default_local_devices()``); their layout across
    ranks picks the collective backend."""
    global _JOB
    import torch.distributed as dist

    with _LOCK:
        if _JOB is not None:
            return _JOB.world > 1
        address = coordinator_address or env_str("JAX_COORDINATOR_ADDRESS")
        if address is None:
            return False
        world = num_processes or _int_env("JAX_NUM_PROCESSES")
        rank = process_id if process_id is not None else _int_env(
            "JAX_PROCESS_ID")
        if world is None or rank is None:
            raise RuntimeError(
                "a multi-process job needs JAX_NUM_PROCESSES and "
                "JAX_PROCESS_ID beside JAX_COORDINATOR_ADDRESS")
        host, _, port = address.rpartition(":")
        logger.info("joining the job at %s as process %d/%d", address, rank,
                    world)
        store = dist.TCPStore(
            host or "localhost", int(port), world, is_master=rank == 0,
            timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
        devices = [torch.device(d) for d in (
            devices if devices is not None else default_local_devices())]
        layouts = _exchange_layout(store, world, rank, devices)
        backend = choose_backend(layouts)
        if backend == "nccl":
            torch.cuda.set_device(devices[0])
        dist.init_process_group(
            backend, store=dist.PrefixStore("process_group", store),
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        _JOB = Job(world, rank, store, backend, len(devices))
        logger.info(
            "joined the job: process %d/%d, %d local / %d global shard(s), "
            "collective backend %s", rank, world, len(devices),
            len(devices) * world, backend)
        return world > 1


def shutdown() -> None:
    """Leave the job (the process group; the store goes with the
    process).  A no-op for a single-process run."""
    global _JOB
    import torch.distributed as dist

    with _LOCK:
        if _JOB is None:
            return
        _JOB = None
        if dist.is_initialized():
            dist.destroy_process_group()


def global_corpus_mesh(devices: Sequence):
    """The 1-D corpus mesh over every process's shards: ``devices`` are
    this process's, and in a joined job the mesh's record axis spans all
    ranks (rank-major); single-process it is ``corpus_mesh(devices)``."""
    from .sharded import Mesh

    j = _JOB
    if j is None or j.world == 1:
        return Mesh(devices)
    if len(devices) != j.local_shards:
        raise RuntimeError(
            f"the job was joined with {j.local_shards} local shard(s); "
            f"a mesh of {len(devices)} cannot span it")
    return Mesh(devices, world=j.world, rank=j.rank, backend=j.backend)


# -- collectives ---------------------------------------------------------------
# Every helper below is entered by every process of the mesh in one global
# order (the dispatcher's op lock on the frontend, the op stream on the
# followers).  COLLECTIVES counts them per kind (plain ints, one writer: the
# thread that holds the op lock).

COLLECTIVES = {"all_gather": 0, "all_reduce": 0, "ring_hop": 0}


def _to_wire(mesh, t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective sends: gloo runs its collectives on host
    memory here, so a card's tensor is copied to the host first (the
    result is copied back by the caller); nccl takes it where it is."""
    if mesh.backend == "gloo" and t.device.type != "cpu":
        return t.cpu()
    return t


def _pack(tensors: Sequence[torch.Tensor]):
    """One byte vector holding ``tensors`` back to back, and the spec
    that splits it again: one collective carries them all."""
    parts = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    spec = [(t.dtype, tuple(t.shape), p.numel())
            for t, p in zip(tensors, parts)]
    return torch.cat(parts), spec


def _unpack(buf: torch.Tensor, spec, device) -> List[torch.Tensor]:
    out, off = [], 0
    for dtype, shape, n in spec:
        # clone: a fresh storage keeps the dtype view aligned
        out.append(buf[off:off + n].clone().view(dtype).reshape(shape)
                   .to(device))
        off += n
    return out


def all_gather(mesh, tensors: Sequence[torch.Tensor]) -> List[List]:
    """Every rank's ``tensors`` (the same shapes and dtypes on every
    rank), rank-major, on ``mesh.lead``: one ``all_gather``."""
    import torch.distributed as dist

    buf, spec = _pack(tensors)
    wire = _to_wire(mesh, buf)
    out = [torch.empty_like(wire) for _ in range(mesh.world)]
    COLLECTIVES["all_gather"] += 1
    dist.all_gather(out, wire)
    return [_unpack(o, spec, mesh.lead) for o in out]


def all_reduce(mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over every rank (``sum`` or ``max``), on ``t``'s
    device: one ``all_reduce``."""
    import torch.distributed as dist

    wire = _to_wire(mesh, t).clone()
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(wire, op={"sum": dist.ReduceOp.SUM,
                              "max": dist.ReduceOp.MAX}[op])
    return wire.to(t.device)


def ring_hop(mesh, tensors: Sequence[torch.Tensor], device) -> List:
    """One hop of the ring across the process boundary: ``tensors`` go to
    rank + 1, and rank - 1's arrive (same shapes and dtypes), on
    ``device``.  gloo's point-to-point takes host tensors only, so the
    hop crosses through host memory there; one send and one receive a
    hop carry the whole block (packed)."""
    import torch.distributed as dist

    buf, spec = _pack(tensors)
    wire = _to_wire(mesh, buf)
    incoming = torch.empty_like(wire)
    nxt = (mesh.rank + 1) % mesh.world
    prev = (mesh.rank - 1) % mesh.world
    COLLECTIVES["ring_hop"] += 1
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, wire, nxt),
        dist.P2POp(dist.irecv, incoming, prev),
    ])
    for w in works:
        w.wait()
    return _unpack(incoming, spec, device)
