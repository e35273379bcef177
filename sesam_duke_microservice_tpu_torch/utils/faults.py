"""Deterministic ingest crash sites for the kill-differential tests, and
the canary prober's verdict-flip drill.

The port's share of the JAX package's ``utils/faults.py``: the ingest
crash sites and ``probe_flip`` (the port has no replicas, leaders or
federation groups).  Activation is the ``DUKE_FAULTS`` env var (or
``configure()`` from tests), a ``;``/``,``-separated spec; the token
kinds read here are

  ``crash_at=<site>:<n>``   SIGKILL this process the ``n``-th time the
                            named crash site is reached -- no cleanup, no
                            atexit, the honest crash a restart must
                            recover from.

Sites: ``post_store_put`` (store rows durable, index and links not yet
applied), ``post_journal_append`` (batch journaled, not yet flushed),
``pre_flush``, ``mid_flush`` (links asserted, not committed),
``post_flush_pre_truncate`` (committed, watermark not yet written),
``mid_journal_write`` (HALF the journal frame written first: a torn
tail) and ``mid_snapshot_save`` (snapshot tmp written, rename pending).

  ``probe_flip=<n>``        corrupt the ``n``-th canary verdict the
                            prober checks (service/prober.py readback
                            seam) -- drives the mismatch latch and the
                            ``/healthz`` degraded detection drill.

Other token kinds of the JAX package's spec are accepted and ignored, so
one spec drives both packages.  With no spec every hook is one env read.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
from typing import Dict, Optional, Tuple

from .. import telemetry
from ..env import env_str


class FaultPlan:
    def __init__(self, spec: str):
        self.spec = spec
        # crash site name -> 1-based occurrence that kills the process
        self._crash_at: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._crash_counts: Dict[str, int] = {}  # guarded by: self._lock
        self._probe_flip_at: Optional[int] = None
        self._probe_count = 0  # guarded by: self._lock
        for raw in spec.replace(",", ";").split(";"):
            kind, _, args = raw.strip().partition("=")
            kind = kind.strip()
            if kind not in ("crash_at", "probe_flip"):
                continue
            parts = [p for p in args.partition("@")[0].split(":") if p]
            try:
                if kind == "probe_flip":
                    self._probe_flip_at = int(parts[0])
                else:
                    self._crash_at[parts[0]] = int(parts[1])
            except (IndexError, ValueError) as e:
                raise ValueError(
                    f"bad DUKE_FAULTS token {raw.strip()!r}: {e}") from e

    def probe_flip(self) -> bool:
        """Count one canary-verdict check; True iff this is the
        configured occurrence (spec ``probe_flip=<n>``) -- the prober
        then corrupts that one verdict at its readback seam, exactly as
        a finalize corruption would surface."""
        if self._probe_flip_at is None:
            return False
        with self._lock:
            self._probe_count += 1
            hit = self._probe_count == self._probe_flip_at
        if hit:
            telemetry.FAULTS_INJECTED.labels(kind="probe_flip").inc()
        return hit

    def crash_hit(self, site: str) -> bool:
        """Count one arrival at ``site``; True iff this is the configured
        occurrence.  Split from ``crash_now`` so a site that must do
        damage first (``mid_journal_write`` writes half a frame) can
        interleave the two; plain sites use ``check_crash``."""
        n = self._crash_at.get(site)
        if n is None:
            return False
        with self._lock:
            count = self._crash_counts.get(site, 0) + 1
            self._crash_counts[site] = count
        return count == n

    def crash_now(self, site: str) -> None:
        """Die the way a real crash dies: SIGKILL to self."""
        telemetry.FAULTS_INJECTED.labels(kind="crash_at").inc()
        print(f"duke-faults: injected crash at {site}", file=sys.stderr,
              flush=True)
        os.kill(os.getpid(), signal.SIGKILL)

    def check_crash(self, site: str) -> None:
        if self.crash_hit(site):
            self.crash_now(site)


_cached: Tuple[Optional[str], Optional[FaultPlan]] = (None, None)
_override: Optional[FaultPlan] = None
_override_set = False


def configure(spec: Optional[str]) -> Optional[FaultPlan]:
    """Test hook: install (or clear, with None) an explicit plan that
    wins over the env var.  Returns the installed plan."""
    global _override, _override_set
    _override = FaultPlan(spec) if spec else None
    _override_set = spec is not None
    return _override


def active() -> Optional[FaultPlan]:
    """The current fault plan, or None (the common case)."""
    global _cached
    if _override_set:
        return _override
    spec = env_str("DUKE_FAULTS") or None
    cached_spec, cached_plan = _cached
    if spec != cached_spec:
        cached_plan = FaultPlan(spec) if spec else None
        _cached = (spec, cached_plan)
    return cached_plan


def check_crash(site: str) -> None:
    """With an active plan arming ``crash_at=<site>:<n>``, the n-th
    arrival SIGKILLs the process; otherwise a no-op."""
    plan = active()
    if plan is not None:
        plan.check_crash(site)
