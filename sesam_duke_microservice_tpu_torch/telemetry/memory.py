"""Device-byte ledger: registration-based device-buffer accounting (the
JAX package's ``telemetry/memory.py`` on torch).

Owners of device-resident state register a components callable
(``register(owner, kind, name, fn)`` — ``fn() -> {component: bytes}``)
held through a weakref, so a reloaded-away workload drops out of the
books automatically.  ``engine.workload.Workload`` registers its corpus
tensors, (``ann``) embeddings / int8 scales and (IVF) cell membership at
construction, reading the ``nbytes`` of the ``DeviceCorpus`` tensors; the
shared device arena (``ops.arena``) registers its resident corpus bytes
once, and the one process-wide component (the digest-keyed feature
cache) is computed here.  The port has no AOT executable store.

Scrape surfaces:

  * per-workload ``duke_device_bytes{kind,workload,component}`` — emitted
    by the app collector (service/metrics.py) beside every other
    workload gauge; it reads this ledger via ``components_for``.
  * process-wide ``duke_device_bytes{component}`` (feature cache),
    ``duke_device_headroom_bytes`` and
    ``duke_device_overflow_days`` — emitted by ``collect`` on
    ``telemetry.GLOBAL`` (one device budget per process).

Headroom = budget − total registered bytes.  The budget resolves from
``DUKE_HBM_BUDGET_MB``, else the total memory of the card the workloads
run on (``torch.cuda.mem_get_info``), else a documented 16 GiB default
(a CPU-only process).  The
overflow forecast extrapolates the corpus-byte growth rate observed
across scrapes: days-to-overflow = headroom / (bytes per day); -1 means
"no growth observed" (never extrapolate from silence).

All byte math reads tensor sizes (``nbytes``, a host read: no device
sync) lock-free (torn reads tolerated — the /stats stance); the ledger's
own dict is guarded by a leaf lock taken only at register/scrape time.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..env import env_int
from .registry import FamilySnapshot, add_render_hook

DEFAULT_BUDGET_BYTES = 16 << 30  # 16 GiB: one modern accelerator's HBM

_REG_LOCK = threading.Lock()
# id(owner) -> (weakref(owner), kind, name, components_fn, logical)
_ENTRIES: Dict[int, tuple] = {}  # guarded by: _REG_LOCK [writes]
# (unix_ts, corpus_bytes) scrape-time samples driving the growth forecast
_growth: deque = deque(maxlen=256)  # guarded by: _REG_LOCK


def register(owner: object, kind: str, name: str,
             fn: Callable[[], Dict[str, int]], *,
             logical: bool = False) -> None:
    """Enroll ``owner``'s device buffers; ``fn`` must be lock-free and
    must not strongly reference ``owner`` (close over a weakref).

    ``logical`` marks a per-tenant VIEW of bytes whose physical owner is
    registered elsewhere (arena-enabled workloads view corpus tensors
    the arena attributes once): logical arena-tier components are
    reported per owner for attribution but excluded from the budget
    totals, so no byte counts twice against the headroom."""
    key = id(owner)
    with _REG_LOCK:
        _ENTRIES[key] = (weakref.ref(owner), kind, name, fn, logical)


def _iter_live() -> List[Tuple[str, str, object, Callable, bool]]:
    """Live registrations, pruning dead/closed owners in passing."""
    out = []
    with _REG_LOCK:
        items = list(_ENTRIES.items())
    dead = []
    for key, (ref, kind, name, fn, logical) in items:
        owner = ref()
        if owner is None:
            dead.append(key)
            continue
        if getattr(owner, "closed", False):
            continue  # replaced by reload; the weakref reaps it later
        out.append((kind, name, owner, fn, logical))
    if dead:
        with _REG_LOCK:
            for key in dead:
                _ENTRIES.pop(key, None)
    return out


# -- once-per-scrape ledger pass ---------------------------------------------
#
# The app collector calls components_for() per workload and the
# GLOBAL collector walks the whole ledger again in the SAME render — at
# 200 tenants that would be 400+ component-callable evaluations per scrape.
# registry.render() brackets every scrape with the hooks below; inside
# a bracket the FIRST ledger read evaluates every callable once into a
# thread-local snapshot and every later read (either API) serves from
# it.  Direct calls outside a render (debug endpoints, tests) see no
# cache at all — no staleness window exists.

_PASS = threading.local()


def _begin_render() -> None:
    _PASS.active = True
    _PASS.snapshot = None


def _end_render() -> None:
    _PASS.active = False
    _PASS.snapshot = None


add_render_hook(_begin_render, _end_render)


def _eval_components(fn: Callable) -> Dict[str, float]:
    try:
        return {k: float(v) for k, v in fn().items() if v}
    except Exception:
        return {}  # a mid-mutation read must never fail a scrape


def _ledger_pass() -> Dict[int, tuple]:
    """id(owner) -> (kind, name, components, logical) — ONE evaluation
    of every live registration, cached for the duration of the active
    render (none active: computed fresh, never cached)."""
    snapshot = (getattr(_PASS, "snapshot", None)
                if getattr(_PASS, "active", False) else None)
    if snapshot is not None:
        return snapshot
    snapshot = {
        id(owner): (kind, name, _eval_components(fn), logical)
        for kind, name, owner, fn, logical in _iter_live()
    }
    if getattr(_PASS, "active", False):
        _PASS.snapshot = snapshot
    return snapshot


def components_for(owner: object) -> Dict[str, float]:
    """One owner's current component bytes (empty if unregistered) —
    the app collector's per-workload read."""
    if getattr(_PASS, "active", False):
        entry = _ledger_pass().get(id(owner))
        return dict(entry[2]) if entry is not None else {}
    with _REG_LOCK:
        entry = _ENTRIES.get(id(owner))
    if entry is None:
        return {}
    return _eval_components(entry[3])


def process_components() -> Dict[str, float]:
    """Process-wide buffers outside any workload: the feature cache."""
    out: Dict[str, float] = {}
    try:
        from ..ops import feature_cache as FC

        out["feature_cache"] = float(FC.stats()[3])
    except Exception:
        pass
    return out


# the CUDA device the process's workloads run on, set by the first CUDA
# workload's registration (one card per process); None: CPU only
_cuda_device = None


def note_device(device) -> None:
    """Remember the CUDA device the budget and the live-bytes cross-check
    read (the workload calls this with its torch device)."""
    global _cuda_device
    if device is not None and getattr(device, "type", None) == "cuda":
        _cuda_device = device


_budget_cache: Dict[object, float] = {}


def budget_bytes() -> Tuple[float, str]:
    """(bytes, source) — DUKE_HBM_BUDGET_MB, else the card's total
    memory (``torch.cuda.mem_get_info``, read once per device: the total
    never changes), else the documented default."""
    mb = env_int("DUKE_HBM_BUDGET_MB", 0)
    if mb > 0:
        return float(mb) * 1024 * 1024, "env"
    dev = _cuda_device
    if dev is not None:
        total = _budget_cache.get(dev)
        if total is None:
            try:
                import torch

                total = float(torch.cuda.mem_get_info(dev)[1])
            except Exception:
                total = 0.0
            _budget_cache[dev] = total
        if total:
            return total, "device"
    return float(DEFAULT_BUDGET_BYTES), "default"


_CORPUS_COMPONENTS = ("corpus_tensors", "corpus_embeddings", "int8_scales",
                      "ivf_membership")
# components an arena-enabled workload only VIEWS (the arena owns the
# physical device bytes and attributes them once): excluded from the
# budget totals when the registration is logical.  ivf_membership stays
# physical either way -- the arena does not manage IVF uploads.
_ARENA_VIEW_COMPONENTS = ("corpus_tensors", "corpus_embeddings",
                          "int8_scales")


def _totals(now_unix: Optional[float] = None
            ) -> Tuple[float, float, List[Tuple[str, str, str, float]]]:
    """(total_bytes, corpus_bytes, [(kind, name, component, bytes)]) and
    feed the growth ring with the corpus share.  Logical registrations'
    arena-tier components appear in the rows (per-tenant attribution)
    but never in the totals -- the arena's own registration carries the
    physical bytes exactly once."""
    rows: List[Tuple[str, str, str, float]] = []
    total = 0.0
    corpus = 0.0
    for kind, name, comps, logical in _ledger_pass().values():
        for comp, nbytes in sorted(comps.items()):
            rows.append((kind, name, comp, nbytes))
            if logical and comp in _ARENA_VIEW_COMPONENTS:
                continue  # a view: the arena row already counted it
            total += nbytes
            if comp in _CORPUS_COMPONENTS:
                corpus += nbytes
    for comp, nbytes in sorted(process_components().items()):
        rows.append(("process", "", comp, nbytes))
        total += nbytes
    now_unix = time.time() if now_unix is None else now_unix
    with _REG_LOCK:
        if not _growth or _growth[-1][1] != corpus:
            _growth.append((now_unix, corpus))
    return total, corpus, rows


def growth_bytes_per_day() -> float:
    """Corpus-byte growth rate across observed scrapes (0 until two
    distinct observations exist)."""
    with _REG_LOCK:
        if len(_growth) < 2:
            return 0.0
        (t0, b0), (t1, b1) = _growth[0], _growth[-1]
    dt = t1 - t0
    if dt <= 0 or b1 <= b0:
        return 0.0
    return (b1 - b0) / dt * 86400.0


def overflow_days(headroom: float) -> float:
    """Days until the corpus growth rate consumes ``headroom``; -1 when
    no growth has been observed (never extrapolate from silence)."""
    rate = growth_bytes_per_day()
    if rate <= 0.0:
        return -1.0
    return max(0.0, headroom) / rate


def live_arrays_bytes() -> Optional[int]:
    """Backend cross-check: the bytes the caching allocator has handed
    out on the card (``torch.cuda.memory_allocated``, a host read), or
    None in a CPU-only process."""
    dev = _cuda_device
    if dev is None:
        return None
    try:
        import torch

        return int(torch.cuda.memory_allocated(dev))
    except Exception:
        return None


def debug_snapshot() -> Dict[str, object]:
    """``GET /debug/memory`` payload (the JAX package's keys).
    ``live_arrays_bytes`` is the caching allocator's ``memory_allocated``
    on the card, the cross-check of the PHYSICAL ``total_bytes``:
    arena-enabled workloads' corpus rows are logical views (their
    ``logical`` flag marks them here), and the allocator's bytes
    correspond to the arena's resident tier plus the non-logical
    registrations -- spilled tenants' mirrors are host numpy, invisible
    to both sides of the check (None in a CPU-only process)."""
    budget, source = budget_bytes()
    total, corpus, rows = _totals()
    headroom = budget - total
    logical_owners = {
        (kind, name) for kind, name, _comps, logical
        in _ledger_pass().values() if logical
    }
    out = {
        "budget_bytes": int(budget),
        "budget_source": source,
        "total_bytes": int(total),
        "corpus_bytes": int(corpus),
        "headroom_bytes": int(headroom),
        "growth_bytes_per_day": round(growth_bytes_per_day(), 3),
        "overflow_days": round(overflow_days(headroom), 3),
        "workloads": [
            {"kind": kind, "workload": name, "component": comp,
             "bytes": int(nbytes),
             # the marker appears ONLY on arena-view rows so the other
             # rows keep their exact shape
             **({"logical": True}
                if (kind, name) in logical_owners
                and comp in _ARENA_VIEW_COMPONENTS else {})}
            for kind, name, comp, nbytes in rows if kind != "process"
        ],
        "process": {comp: int(nbytes)
                    for kind, _n, comp, nbytes in rows if kind == "process"},
        "live_arrays_bytes": live_arrays_bytes(),
    }
    from ..ops import arena

    out["arena"] = arena.ARENA.debug_snapshot()
    return out


def _reset_for_tests() -> None:
    # NOTE: this also drops the arena's import-time enrollment; it
    # re-enrolls at its next admission (ops.arena.DeviceArena.admit)
    with _REG_LOCK:
        _ENTRIES.clear()
        _growth.clear()


def collect() -> List[FamilySnapshot]:
    """Scrape-time collector (registered on ``telemetry.GLOBAL``):
    process-component bytes + the headroom/forecast gauges.  The
    per-workload ``duke_device_bytes`` samples come from the app
    collector."""
    budget, _source = budget_bytes()
    total, _corpus, rows = _totals()
    headroom = budget - total
    proc_samples = [("", (("component", comp),), nbytes)
                    for kind, _n, comp, nbytes in rows if kind == "process"]
    return [
        FamilySnapshot(
            "duke_device_bytes", "gauge",
            "Registered device-buffer bytes by component (per-workload "
            "series carry kind/workload labels; the process-wide "
            "feature cache carries only component)", proc_samples),
        FamilySnapshot(
            "duke_device_headroom_bytes", "gauge",
            "Device memory budget (DUKE_HBM_BUDGET_MB, else the card's "
            "total memory, else 16 GiB) minus all registered device "
            "bytes", [("", (), headroom)]),
        FamilySnapshot(
            "duke_device_overflow_days", "gauge",
            "Days until the observed corpus-byte growth rate consumes "
            "the headroom (-1 = no growth observed yet)",
            [("", (), overflow_days(headroom))]),
    ]
