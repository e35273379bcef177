"""Shared-memory parallel feature extraction (a copy of the JAX package's
``ops/parallel_extract.py``).

Bulk ingest is host-bound Python glue: per-value string encoding, flat
list construction, gram / phonetic / class loops (``ops.features``).
Threads are GIL-bound there, and a process pool that returns tensors pays
pickling and IPC of ~1 KB a row both ways.  So the workers write their
slice's feature tensors straight into ``multiprocessing.shared_memory``
segments at their row offsets and return nothing; only the record values
(a few hundred bytes of strings a record) ride the task pickle.  Output
shapes and dtypes come from running the extractor on an empty batch, so
the layout has one definition.

Workers are spawned, never forked: the parent holds a CUDA context.  Each
hides the card from itself (``CUDA_VISIBLE_DEVICES=""``) before anything
else runs, and imports only numpy and the torch-free ``ops.features`` /
``ops.embedding``.  Env knobs (``DEVICE_MAX_*``, ``DUKE_TPU_NATIVE``)
reach workers through the inherited environment; the specs ship with
each call, so grown widths are always current.

On for slabs of at least ``DEVICE_EXTRACT_PARALLEL_MIN`` (8192) records
when ``DEVICE_EXTRACT_WORKERS`` is two or more.  Off by default (0): the
pool's first slab pays its spawned workers' start, which on the card's
host costs far more than the serial extraction of the slabs the service
is sent, and later slabs gain little (PERF.md, "the pool's and the
cache's defaults").  A pool that breaks (a worker killed mid-task) or a
shared-memory allocation that fails logs a warning, counts one
``serial_retries`` in ``STATS`` and returns None: the caller extracts the
slab serially.  Any other exception a worker
raises propagates: it is a fault of the extraction, not of the pool.
"""

from __future__ import annotations

import atexit
import logging
import os
import threading
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from multiprocessing import get_context, shared_memory
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..env import env_int

logger = logging.getLogger("parallel-extract")

_POOL: Optional[ProcessPoolExecutor] = None
_POOL_WORKERS = 0
# guards pool creation / replacement AND serializes map calls: two
# workloads extracting at once must not race the lazy init (a leaked pool)
# or have a worker-count change terminate a pool mid-map
_POOL_LOCK = threading.Lock()

# since the process started: slabs extracted in parallel, the worker tasks
# they ran, and slabs retried serially after a failure
STATS = {"slabs": 0, "tasks": 0, "serial_retries": 0}
_STATS_LOCK = threading.Lock()


def workers() -> int:
    """Read at call time, so a process can retune it live.  Default 0:
    the pool is off unless asked for (the module docstring says why)."""
    return env_int("DEVICE_EXTRACT_WORKERS", 0)


def min_records() -> int:
    """Smallest slab worth the process-pool fan-out."""
    return env_int("DEVICE_EXTRACT_PARALLEL_MIN", 8192)


def enabled(n_records: int) -> bool:
    return workers() >= 2 and n_records >= min_records()


def _pool() -> ProcessPoolExecutor:
    """Call with _POOL_LOCK held.  ProcessPoolExecutor, not mp.Pool: a
    worker dying mid-task raises BrokenProcessPool from map(), which the
    caller turns into a serial retry, where mp.Pool.map would block for
    ever holding the workload lock."""
    global _POOL, _POOL_WORKERS
    w = workers()
    if _POOL is not None and _POOL_WORKERS != w:
        _shutdown_locked()
    if _POOL is None:
        _POOL = ProcessPoolExecutor(
            max_workers=w, mp_context=get_context("spawn"),
            initializer=_worker_init,
        )
        _POOL_WORKERS = w
        atexit.register(_shutdown)
    return _POOL


def _shutdown_locked() -> None:
    global _POOL
    if _POOL is not None:
        _POOL.shutdown(wait=False, cancel_futures=True)
        _POOL = None


def _shutdown() -> None:
    with _POOL_LOCK:
        _shutdown_locked()


def _worker_init() -> None:
    # a worker never touches the card: hide it before any import could
    # create a CUDA context
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _worker_extract(task) -> None:
    """Extract one record slice into the shared segments.  Runs in a
    spawned worker; returns None -- the tensors travel through shm."""
    specs, encoder, values_by_prop, lo, layout = task
    from . import features as F

    handles = []
    try:
        for spec in specs:
            out = F.extract_property(spec, values_by_prop[spec.name])
            for tname, arr in out.items():
                _write(layout[(spec.name, tname)], lo, arr, handles)
        if encoder is not None:
            records = _records_from_values(values_by_prop, encoder.props)
            emb = encoder.encode_batch(records).astype(np.float32)
            _write(layout[("__ann__", "emb_f32")], lo, emb, handles)
    finally:
        for shm in handles:
            shm.close()


def _write(entry, lo: int, arr: np.ndarray, handles: list) -> None:
    shm_name, shape, dtype = entry
    shm = shared_memory.SharedMemory(name=shm_name)
    handles.append(shm)
    view = np.ndarray(shape, dtype=np.dtype(dtype), buffer=shm.buf)
    view[lo:lo + arr.shape[0]] = arr


def _records_from_values(values_by_prop: Dict[str, List[List[str]]],
                         props: Sequence[str]):
    """Minimal Record stand-ins for the encoder (it reads only
    ``_values``), so records never ride the task pickle twice."""
    from ..core.records import Record

    n = len(next(iter(values_by_prop.values())))
    out = []
    for i in range(n):
        r = Record.__new__(Record)
        r._values = {
            prop: values_by_prop[prop][i]
            for prop in props
            if prop in values_by_prop and values_by_prop[prop][i]
        }
        out.append(r)
    return out


def _count_retry(what: str) -> None:
    logger.warning("%s; extracting the slab serially", what, exc_info=True)
    with _STATS_LOCK:
        STATS["serial_retries"] += 1


def extract_batch_parallel(plan, records, *, encoder=None
                           ) -> Optional[Dict[str, Dict[str, np.ndarray]]]:
    """Shared-memory fan-out of ``features._extract_serial`` (plus the
    embedding when ``encoder`` is given); returns None when the pool or
    shared memory failed (the caller extracts serially)."""
    from . import embedding as E
    from . import features as F

    n = len(records)
    nw = max(1, workers())
    per = -(-n // nw)

    # the task payload: per-property value lists (strings), not Record
    # objects -- smaller pickles and no Record internals on the wire
    empty: List[str] = []
    prop_names = [s.name for s in plan.device_props]
    if encoder is not None:
        prop_names = sorted(set(prop_names) | set(encoder.props))
    values_by_prop = {
        name: [r._values.get(name, empty) for r in records]
        for name in prop_names
    }

    # output layout from the extractor itself on an empty batch
    layout: Dict[tuple, tuple] = {}
    segments: List[shared_memory.SharedMemory] = []

    def alloc(key, shape, dtype) -> None:
        nbytes = max(1, int(np.prod(shape)) * np.dtype(dtype).itemsize)
        shm = shared_memory.SharedMemory(create=True, size=nbytes)
        segments.append(shm)
        layout[key] = (shm.name, shape, str(np.dtype(dtype)))

    try:
        try:
            for spec in plan.device_props:
                proto = F.extract_property(spec, [])
                for tname, arr in proto.items():
                    alloc((spec.name, tname), (n,) + arr.shape[1:],
                          arr.dtype)
            if encoder is not None:
                alloc(("__ann__", "emb_f32"), (n, encoder.dim), np.float32)
        except OSError:
            # /dev/shm too small for the slab (containers default to 64 MB)
            _count_retry("shared-memory allocation failed")
            return None

        tasks = []
        for w in range(nw):
            lo, hi = w * per, min(n, (w + 1) * per)
            if lo >= hi:
                break
            slice_values = {
                name: vals[lo:hi] for name, vals in values_by_prop.items()
            }
            tasks.append((plan.device_props, encoder, slice_values, lo,
                          layout))
        try:
            with _POOL_LOCK:
                # list() drains the generator so a dead worker's
                # BrokenProcessPool surfaces here, inside the retry guard
                list(_pool().map(_worker_extract, tasks))
        except BrokenProcessPool:
            _count_retry("shared-memory extraction failed")
            _shutdown()
            return None
        with _STATS_LOCK:
            STATS["slabs"] += 1
            STATS["tasks"] += len(tasks)

        out: Dict[str, Dict[str, np.ndarray]] = {}
        for spec in plan.device_props:
            out[spec.name] = {}
        for (prop, tname), (shm_name, shape, dtype) in layout.items():
            shm = next(s for s in segments if s.name == shm_name)
            view = np.ndarray(shape, dtype=np.dtype(dtype), buffer=shm.buf)
            if (prop, tname) == ("__ann__", "emb_f32"):
                # workers emit f32; the storage conversion (bf16 bits, or
                # int8 codes + scale) is the serial path's own function
                out[E.ANN_PROP] = E.corpus_tensors_from_f32(
                    view, encoder.storage)
            else:
                out[prop][tname] = view.copy()
        return out
    finally:
        for shm in segments:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
