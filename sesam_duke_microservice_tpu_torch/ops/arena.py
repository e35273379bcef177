"""The shared device-memory arena: multi-tenant residency on the card
(the JAX package's ``ops/arena.py`` on torch).

One process serving many workloads cannot let every tenant pin its
padded corpus tensors on the card forever: idle tenants' padding would
crowd out hot ones, and the first tenant past the budget would die on an
allocator OOM.  The arena is the process-wide residency ledger that
fixes both:

  * every device-corpus upload **admits** through :meth:`DeviceArena.
    admit` first.  Admission holds the tenant's device tensor bytes
    against the budget (``telemetry.memory.budget_bytes``: the
    ``DUKE_HBM_BUDGET_MB`` ceiling, else the card's total memory, else
    16 GiB);
  * past the budget, the coldest resident tenants **spill**: their
    device tensors are dropped (the numpy host mirror is the durable
    tier) and the next query **faults the corpus back in** through the
    normal full upload.  Victim order is the cost ledger's accumulated
    per-tenant device-seconds, with admission recency as the tiebreak:
    an idle tenant is evicted before a busy one;
  * when eviction cannot make room (the admitting tenant alone exceeds
    the budget), admission raises :class:`ArenaAdmissionError`, which
    the HTTP layer maps to a 503 instead of an allocator OOM.

The ledger, not ``torch.cuda.memory_reserved``, is what admission reads:
the caching allocator keeps freed blocks reserved, so ``reserved`` never
falls after a spill while ``memory_allocated`` does.

``DUKE_ARENA=0`` disables the subsystem: ``admit`` becomes a no-op and
per-workload tensors stay pinned.

Lock order: ``DeviceArena._lock`` is OUTER to every corpus
``_upload_lock``: admission runs *before* the caller takes its own
upload lock (engine.device_matcher.DeviceCorpus.device_arrays), and a
spill inside admission takes only the *victim's* upload lock.  A victim
mid-upload (past its own admit, inside its upload lock) just finishes;
the spill lands right after, and the victim's next query re-admits (one
transient fault).  The arena never spills the admitting owner.

Scrape surfaces (registered on ``telemetry.GLOBAL`` at import):
``duke_arena_bytes{tier}`` (device = resident lease bytes, host =
spilled lease bytes living on their host mirrors) and
``duke_arena_faults_total`` (spill -> re-upload round trips).  The
device-byte ledger attributes resident arena bytes ONCE (owner = arena);
tenants keep per-workload *logical* views (telemetry.memory ``logical``
registrations), so attribution survives without double counting.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional

from ..telemetry import GLOBAL
from ..env import env_flag
from ..telemetry.registry import FamilySnapshot

logger = logging.getLogger("arena")

__all__ = [
    "ARENA",
    "ArenaAdmissionError",
    "DeviceArena",
    "arena_enabled",
]


def arena_enabled() -> bool:
    """``DUKE_ARENA=0`` pins per-workload tensors exactly as before."""
    return env_flag("DUKE_ARENA", True)


class ArenaAdmissionError(Exception):
    """Admission refused: the corpus does not fit the HBM budget even
    after spilling every eligible resident tenant.  The HTTP layer maps
    this to 503 -- the loud, actionable alternative to an allocator OOM
    (raise ``DUKE_HBM_BUDGET_MB``, shrink the corpus, or shed the
    tenant)."""

    def __init__(self, label: str, need: int, budget: int, resident: int):
        super().__init__(
            f"HBM budget exhausted admitting {label or 'corpus'}: "
            f"need {need} bytes, budget {budget}, "
            f"{resident} still resident after spilling"
        )
        self.need = need
        self.budget = budget
        self.resident = resident


def _weak_callable(fn):
    """Resolver for an owner-supplied callback that must not pin the
    owner: bound methods (corpus.spill_device) are held through
    ``WeakMethod`` so the lease's weakref pruning still fires; plain
    functions/lambdas are held directly (they close over weakrefs by
    convention -- see engine.workload._arena_heat)."""
    if fn is None:
        return lambda: None
    if hasattr(fn, "__self__"):
        wm = weakref.WeakMethod(fn)
        return wm
    return lambda: fn


class _Lease:
    """One corpus' residency record (guarded by: DeviceArena._lock,
    except ``heat_fn`` which is immutable after creation)."""

    __slots__ = ("ref", "label", "nbytes", "resident", "spilled_once",
                 "last_touch", "spill_fn", "heat_fn", "faults")

    def __init__(self, owner, label: str, spill_fn, heat_fn):
        self.ref = weakref.ref(owner)
        self.label = label
        self.nbytes = 0
        self.resident = False
        self.spilled_once = False  # distinguishes fault-ins from cold starts
        self.last_touch = 0.0
        self.spill_fn = _weak_callable(spill_fn)
        self.heat_fn = _weak_callable(heat_fn)
        self.faults = 0

    def heat(self) -> float:
        fn = self.heat_fn()
        if fn is None:
            return 0.0
        try:
            return float(fn())
        except Exception:
            return 0.0


class DeviceArena:
    """Process-wide residency ledger for device corpus mirrors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._leases: Dict[int, _Lease] = {}  # id(owner) -> lease; guarded by: self._lock
        self.faults = 0       # spill -> fault-in round trips; guarded by: self._lock [writes]
        self.spills = 0       # guarded by: self._lock [writes]
        self.admissions = 0   # guarded by: self._lock [writes]
        self.rejections = 0   # guarded by: self._lock [writes]

    # -- admission ----------------------------------------------------------

    def admit(self, owner, nbytes: int, *, spill: Callable[[], int],
              label: str = "", heat: Optional[Callable[[], float]] = None
              ) -> None:
        """Hold ``nbytes`` of device residency for ``owner``, spilling
        colder tenants as needed.  Call BEFORE taking the owner's upload
        lock (lock order: arena outer).  Idempotent and cheap while the
        owner is already resident at the same size (one lock + dict hit).
        Raises :class:`ArenaAdmissionError` when the budget cannot fit
        the owner even after spilling everything eligible."""
        if not arena_enabled():
            return
        if self is ARENA:
            # ledger resets (tests) drop the import-time enrollment;
            # re-register lazily so resident tensors stay attributed.
            # Unlocked membership probe: register() is idempotent.
            from ..telemetry import memory

            if id(ARENA) not in memory._ENTRIES:
                _enroll_ledger()
        nbytes = int(nbytes)
        victims: List[_Lease] = []
        with self._lock:
            lease = self._leases.get(id(owner))
            if lease is None:
                lease = self._leases[id(owner)] = _Lease(
                    owner, label, spill, heat)
            lease.last_touch = time.monotonic()
            if label:
                lease.label = label
            if heat is not None:
                lease.heat_fn = _weak_callable(heat)
            if lease.resident and lease.nbytes == nbytes:
                return  # steady state: already resident at this size
            budget = self._budget_bytes()
            resident = sum(
                entry.nbytes for entry in self._live_leases()
                if entry.resident and entry is not lease)
            if resident + nbytes > budget:
                victims = self._pick_victims(
                    lease, resident + nbytes - budget)
                resident -= sum(v.nbytes for v in victims)
            if resident + nbytes > budget:
                self.rejections += 1
                raise ArenaAdmissionError(
                    lease.label, nbytes, int(budget), int(resident))
            if lease.spilled_once and not lease.resident:
                lease.faults += 1
                self.faults += 1
            was_resident = lease.resident
            lease.resident = True
            lease.nbytes = nbytes
            if not was_resident:
                self.admissions += 1
            # spill victims while still holding the arena lock: each
            # spill takes only the VICTIM's upload lock (never the
            # admitting owner's -- _pick_victims excludes it), so the
            # arena-outer/upload-inner order holds on every path
            for victim in victims:
                self._spill_locked(victim)

    def _budget_bytes(self) -> float:
        from ..telemetry import memory

        return memory.budget_bytes()[0]

    def _live_leases(self) -> List[_Lease]:
        """Leases whose owners are alive, pruning the rest (call with
        self._lock held)."""
        dead = [key for key, entry in self._leases.items()
                if entry.ref() is None]
        for key in dead:
            del self._leases[key]
        return list(self._leases.values())

    def _pick_victims(self, admitting: _Lease, shortfall: int
                      ) -> List[_Lease]:
        """Coldest-first resident leases covering ``shortfall`` bytes
        (call with self._lock held).  Order: accumulated cost-ledger
        device-seconds ascending (idle tenants first), admission recency
        as tiebreak."""
        candidates = [
            entry for entry in self._live_leases()
            if entry.resident and entry is not admitting and entry.nbytes > 0
        ]
        candidates.sort(key=lambda e: (e.heat(), e.last_touch))
        out: List[_Lease] = []
        freed = 0
        for entry in candidates:
            if freed >= shortfall:
                break
            out.append(entry)
            freed += entry.nbytes
        return out

    def _spill_locked(self, lease: _Lease) -> None:
        """Drop one victim's device mirrors (call with self._lock held;
        takes the victim's upload lock inside -- see module lock order)."""
        try:
            fn = lease.spill_fn()
            if fn is not None:
                fn()
        except Exception:  # a wedged victim must not fail the admission
            logger.exception("arena spill failed for %s", lease.label)
        lease.resident = False
        lease.spilled_once = True
        self.spills += 1
        logger.info("arena spilled %s (%d bytes) to host tier",
                    lease.label or "corpus", lease.nbytes)

    # -- bookkeeping --------------------------------------------------------

    def forget(self, owner) -> None:
        with self._lock:
            self._leases.pop(id(owner), None)

    def tier_bytes(self) -> Dict[str, int]:
        """{tier: bytes}: device = resident leases, host = spilled
        leases (their host mirrors are the fault-in source)."""
        device = 0
        host = 0
        with self._lock:
            for entry in self._live_leases():
                if entry.resident:
                    device += entry.nbytes
                elif entry.spilled_once:
                    host += entry.nbytes
        return {"device": device, "host": host}

    def device_bytes(self) -> int:
        return self.tier_bytes()["device"]

    def debug_snapshot(self) -> Dict[str, object]:
        """The /debug/memory ``arena`` block."""
        with self._lock:
            rows = [
                {"label": entry.label,
                 "bytes": int(entry.nbytes),
                 "resident": bool(entry.resident),
                 "faults": int(entry.faults),
                 "heat_device_seconds": round(entry.heat(), 6)}
                for entry in self._live_leases()
            ]
            counters = {
                "admissions": self.admissions,
                "spills": self.spills,
                "faults": self.faults,
                "rejections": self.rejections,
            }
        tiers = self.tier_bytes()
        return {
            "enabled": arena_enabled(),
            "tiers": tiers,
            "leases": rows,
            **counters,
        }

    def _reset_for_tests(self) -> None:
        with self._lock:
            self._leases.clear()
            self.faults = 0
            self.spills = 0
            self.admissions = 0
            self.rejections = 0


ARENA = DeviceArena()


def _arena_components() -> Dict[str, int]:
    """The arena's device-byte ledger registration: resident tensor
    bytes, attributed ONCE here (owner = arena) while tenants carry
    logical views -- telemetry.memory excludes those views from the
    budget totals, so no byte counts twice against the headroom."""
    nbytes = ARENA.device_bytes()
    return {"corpus_tensors": nbytes} if nbytes else {}


def _enroll_ledger() -> None:
    from ..telemetry import memory

    memory.register(ARENA, "arena", "", _arena_components)


_enroll_ledger()


def collect() -> List[FamilySnapshot]:
    """Scrape-time collector (registered on ``telemetry.GLOBAL``)."""
    tiers = ARENA.tier_bytes()
    return [
        FamilySnapshot(
            "duke_arena_bytes", "gauge",
            "Shared device-memory arena bytes by tier (device = "
            "resident corpus mirrors, host = spilled tenants waiting "
            "to fault back in)",
            [("", (("tier", tier),), float(nbytes))
             for tier, nbytes in sorted(tiers.items())]),
        FamilySnapshot(
            "duke_arena_faults_total", "counter",
            "Corpus fault-ins: a spilled tenant's first query "
            "re-admitted and re-uploaded its device mirrors",
            [("", (), float(ARENA.faults))]),
    ]


GLOBAL.register_collector(collect)
