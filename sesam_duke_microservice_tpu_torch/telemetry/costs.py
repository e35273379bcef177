"""Cost ledger (a copy of the JAX package's ``telemetry/costs.py``,
with a device ledger of its own).

Answers "who is spending the hardware" from measurements the engine
already takes: every batch's per-phase durations (encode / retrieve /
score / persist — ``engine.processor`` and ``engine.device_matcher``
both observe them into the workload's ``PhaseRecorder``) are ALSO summed
into this process-wide host busy ledger by ``note_busy``, called once
per batch by the thread that measured them.  Build time accumulates
separately through ``note_compile`` (amortized capacity spend, not batch
latency): in the port a "compile" is the first-use build of a native
library, ``ops.cuda_kernels.build_library`` (nvcc) and
``native.build_library`` (g++).

Attribution invariant (proven by test): the per-workload × per-phase
``duke_cost_device_seconds_total`` counters — emitted at scrape time
from the same PhaseRecorders — sum to ``busy_seconds_total()`` within
float tolerance, because ``note_busy`` receives exactly the four phase
durations each batch observed.  The ledger survives config reloads (it
is process-global) while PhaseRecorders die with their workloads, so
``/debug/costs`` reports the residual as ``unattributed_seconds``
instead of pretending the books always balance.

The phase durations are host-clock busy time: the dispatching thread's
time inside a batch, whether it launched work, waited on the card or
ran host code.  The card's own time is a separate ledger:
``note_device`` takes each scoring pass's CUDA-event device time
(``ProfileStats.device_seconds``, 0 on the CPU): for each program, the
time from its first queued op to its last as the card's clock reads
them, so the card's waits for the host's next launch inside a program
count as device time.

Utilization: ``duke_device_utilization`` = CUDA-event device seconds
inside a sliding window / window wall time — the busy fraction the
autoscaler reads for scale-down headroom, an upper bound where the
passes are bound by their launches.  The window is a slot ring
like ``slo.SloTracker``'s, recomputed exactly at scrape.

Locking: one leaf lock, taken once per BATCH (never per record/pair)
and once per scrape — the same budget the SLO trackers spend.  The
bench's attribution-off arm calls ``configure(False)``; disabled,
``note_busy`` is one module-global read and a return.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from .registry import FamilySnapshot

# busy-fraction window: 12 slots of 5 s = a 60 s sliding window (short
# enough to track load swings, long enough to smooth batch granularity)
WINDOW_S = 60.0
_SLOT_S = 5.0
_N_SLOTS = int(WINDOW_S / _SLOT_S) + 1

_lock = threading.Lock()
_enabled = True  # guarded by: _lock [writes]
_busy_total = 0.0  # guarded by: _lock
_compile_total = 0.0  # guarded by: _lock
_compile_count = 0  # guarded by: _lock
_device_total = 0.0  # guarded by: _lock
# [slot_index, device_seconds] per 5 s slot, lazily recycled
_slots: List[List[float]] = [[-1, 0.0] for _ in range(_N_SLOTS)]  # guarded by: _lock
_started = time.monotonic()


def configure(enabled: bool) -> None:
    """Runtime toggle (the bench's attribution-off arm)."""
    global _enabled
    with _lock:
        _enabled = bool(enabled)


def enabled() -> bool:
    return _enabled


def note_busy(seconds: float) -> None:
    """Credit one batch's measured host busy seconds (the sum of its
    four phase durations).  Called once per batch by the thread that
    holds the workload lock — the leaf ``_lock`` nests under it but
    never the reverse."""
    if not _enabled or seconds <= 0.0:
        return
    global _busy_total
    with _lock:
        _busy_total += seconds


def note_device(seconds: float, now: Optional[float] = None) -> None:
    """Credit one scoring pass's CUDA-event device seconds into the
    utilization window.  Called once per batch, like ``note_busy``."""
    if not _enabled or seconds <= 0.0:
        return
    now = time.monotonic() if now is None else now
    slot_idx = int(now // _SLOT_S)
    global _device_total
    with _lock:
        _device_total += seconds
        cell = _slots[slot_idx % _N_SLOTS]
        if cell[0] != slot_idx:
            cell[0], cell[1] = slot_idx, 0.0
        cell[1] += seconds


def note_compile(seconds: float) -> None:
    """Credit one first-use build of a native library (an nvcc or g++
    run): counted always (the canary prober reads the count), its
    seconds while the ledger is on."""
    global _compile_total, _compile_count
    with _lock:
        _compile_count += 1
        if _enabled and seconds > 0.0:
            _compile_total += seconds


def compile_count() -> int:
    """nvcc and g++ builds this process ran -- the port's counterpart of
    the JAX package's XLA compile counter."""
    with _lock:
        return _compile_count


def busy_seconds_total() -> float:
    with _lock:
        return _busy_total


def device_seconds_total() -> float:
    with _lock:
        return _device_total


def compile_seconds_total() -> float:
    with _lock:
        return _compile_total


def utilization(now: Optional[float] = None) -> float:
    """Device-busy fraction over the sliding window: CUDA-event device
    seconds over the window's wall (clamped to uptime so a fresh process
    is not under-reported against a window it has not lived through
    yet)."""
    now = time.monotonic() if now is None else now
    window = min(WINDOW_S, max(now - _started, _SLOT_S))
    min_slot = int((now - window) // _SLOT_S)
    with _lock:
        busy = sum(c[1] for c in _slots if c[0] >= min_slot)
    return min(1.0, busy / window)


def _reset_for_tests() -> None:
    global _busy_total, _compile_total, _device_total, _enabled, _started
    with _lock:
        _busy_total = 0.0
        _compile_total = 0.0
        _device_total = 0.0
        _enabled = True
        for cell in _slots:
            cell[0], cell[1] = -1, 0.0
        _started = time.monotonic()


def snapshot(now: Optional[float] = None) -> Dict[str, object]:
    """Process-wide ledger state for ``/debug/costs``."""
    now = time.monotonic() if now is None else now
    with _lock:
        busy, comp = _busy_total, _compile_total
        on = _enabled
    return {
        "enabled": on,
        "busy_seconds_total": round(busy, 6),
        "compile_seconds_total": round(comp, 6),
        "utilization": round(utilization(now), 6),
        "window_seconds": WINDOW_S,
    }


def collect() -> List[FamilySnapshot]:
    """Scrape-time collector (registered on ``telemetry.GLOBAL``, so
    every plane that renders GLOBAL serves the ledger)."""
    with _lock:
        busy, comp = _busy_total, _compile_total
    return [
        FamilySnapshot(
            "duke_cost_busy_seconds_total", "counter",
            "Measured host busy seconds across all workloads (each "
            "batch's four phase durations on the host clock, summed once "
            "per batch); the reconciliation target for "
            "duke_cost_device_seconds_total",
            [("", (), busy)]),
        FamilySnapshot(
            "duke_cost_compile_seconds_total", "counter",
            "Seconds spent building scorer programs (first-use builds "
            "of the native libraries) — amortized capacity spend "
            "that overlaps serving",
            [("", (), comp)]),
        FamilySnapshot(
            "duke_device_utilization", "gauge",
            "CUDA-event device-seconds of the scoring passes (each "
            "program from its first queued op to its last, launch gaps "
            "included) / wall over a sliding 60 s window (the "
            "autoscaler's busy-fraction headroom signal; 0 on the CPU)",
            [("", (), utilization())]),
    ]
