"""Deterministic fault injection: the serving group's dispatch faults, the
write-behind flush and feed-lock drills, the ingest crash sites for the
kill-differential tests, and the canary prober's verdict-flip drill.

The port's share of the JAX package's ``utils/faults.py``.  Activation is
the ``DUKE_FAULTS`` env var (or ``configure()`` from tests), a
``;``/``,``-separated spec.  Probabilities are resolved by *hashing* the
injection site's coordinates (seed, kind, op index, follower index), not
by drawing from a shared RNG stream, so a spec injects the same faults at
the same ops whatever the thread interleaving.  The token kinds read here
(``p`` in [0,1]; ``@tag`` filters to one dispatch op tag):

  ``seed=<int>``                   hash seed (default 0)
  ``drop=<p>[@tag]``               transient send failure (first attempt
                                   only -- the retry layer must heal it)
  ``delay=<p>:<seconds>[@tag]``    sleep before the send
  ``dup=<p>[@tag]``                send the frame twice (same stream seq
                                   -- the follower must drop the dup)
  ``partition=<f>:<from>:<to>``    every send attempt to follower ``f``
                                   fails for op index in [from, to) --
                                   exhausts the retries, forcing eviction
  ``crash_follower=<f>:<n>``       follower ``f``'s replay loop dies hard
                                   at its ``n``-th received op
  ``crash_leader=<n>``             the dispatcher raises LeaderCrash
                                   before broadcasting op ``n``
  ``flush_fail=<n>``               the ``n``-th write-behind link flush
                                   raises (drives the latch and the
                                   ``/readyz`` unready flip)
  ``slow_lock=<p>:<seconds>``      feed-path lock acquisitions sleep
                                   first (drives the bounded-backoff
                                   mid-stream deadline path)
  ``crash_at=<site>:<n>``          SIGKILL this process the ``n``-th time
                                   the named crash site is reached -- no
                                   cleanup, no atexit, the honest crash a
                                   restart must recover from
  ``probe_flip=<n>``               corrupt the ``n``-th canary verdict the
                                   prober checks (service/prober.py
                                   readback seam) -- drives the mismatch
                                   latch and the ``/healthz`` degraded
                                   detection drill
  ``fed_down=<g>``                 federation group ``g`` is unreachable:
                                   every router call into it raises
                                   GroupUnavailable -- drives the
                                   scatter-gather degraded-mode contract
                                   (dead ranges 503 + Retry-After, live
                                   ranges keep serving)

Crash sites: ``post_store_put`` (store rows durable, index and links not
yet applied), ``post_journal_append`` (batch journaled, not yet flushed),
``pre_flush``, ``mid_flush`` (links asserted, not committed),
``post_flush_pre_truncate`` (committed, watermark not yet written),
``mid_journal_write`` (HALF the journal frame written first: a torn
tail) and ``mid_snapshot_save`` (snapshot tmp written, rename pending);
the range-migration sites (federation/migrate.py): ``pre_freeze`` (state
recorded, map not yet frozen), ``post_snapshot`` (range snapshot taken,
nothing shipped), ``mid_replay`` (snapshot loaded at the target, journal
slice partly replayed), ``pre_cutover`` (target complete, map still names
the source) and ``post_cutover`` (map cut over, drain pending).

Every token kind is the JAX package's, so one spec drives both packages.
Every injected fault counts in ``duke_faults_injected_total{kind}``.
Wired into ``parallel/dispatch.py`` (send path and follower loop),
``links/write_behind.py`` (flush), ``service/app.py`` (the streamed
feed's lock), the ingest and migration crash sites, the prober and the
federation router (``fed_down``); with no spec every hook is one env
read.
"""

from __future__ import annotations

import hashlib
import os
import signal
import sys
import threading
import time
from typing import Dict, Optional, Tuple

from .. import telemetry
from ..env import env_str


class LeaderCrash(RuntimeError):
    """Injected leader death: the dispatcher aborts before broadcasting."""


class InjectedSendFailure(OSError):
    """Injected transient send failure.  Subclasses OSError so any code
    treating it generically sees a socket-like error, but it is raised
    BEFORE any bytes hit the wire -- retrying it cannot tear a frame."""


class InjectedFlushFailure(IOError):
    """Injected write-behind flush failure (latches the buffer)."""


# cached label children: fault kinds are a tiny closed set, so each child
# resolves through the family lock at most once
_KIND_CHILDREN: Dict[str, object] = {}


def _count(kind: str) -> None:
    child = _KIND_CHILDREN.get(kind)
    if child is None:
        child = telemetry.FAULTS_INJECTED.labels(kind=kind)
        _KIND_CHILDREN[kind] = child
    child.inc()


def _unit(seed: int, *key) -> float:
    """Deterministic uniform draw in [0, 1) from the site coordinates (the
    JAX package's formula, so one spec hits the same sites in both)."""
    h = hashlib.sha256(repr((seed,) + key).encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class FaultPlan:
    def __init__(self, spec: str):
        self.spec = spec
        self.seed = 0
        # (p, tag-or-None) rules
        self._drop: list = []
        self._dup: list = []
        # (p, seconds, tag-or-None)
        self._delay: list = []
        # follower -> (from_op, to_op)
        self._partitions: Dict[int, Tuple[int, int]] = {}
        # follower -> op count at which its loop dies
        self._follower_crash: Dict[int, int] = {}
        self._leader_crash: Optional[int] = None
        self._flush_fail_at: Optional[int] = None
        self._slow_lock: Optional[Tuple[float, float]] = None
        # crash site name -> 1-based occurrence that kills the process
        self._crash_at: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._crash_counts: Dict[str, int] = {}  # guarded by: self._lock
        self._probe_flip_at: Optional[int] = None
        self._probe_count = 0  # guarded by: self._lock
        self._flush_count = 0  # guarded by: self._lock
        self._lock_count = 0  # guarded by: self._lock
        # federation groups whose router calls fail
        self._fed_down: set = set()
        for raw in spec.replace(",", ";").split(";"):
            token = raw.strip()
            if not token:
                continue
            kind, _, args = token.partition("=")
            kind = kind.strip()
            args, _, tag = args.partition("@")
            tag = tag.strip() or None
            parts = [p for p in args.split(":") if p != ""]
            try:
                if kind == "seed":
                    self.seed = int(parts[0])
                elif kind == "drop":
                    self._drop.append((float(parts[0]), tag))
                elif kind == "dup":
                    self._dup.append((float(parts[0]), tag))
                elif kind == "delay":
                    self._delay.append((float(parts[0]), float(parts[1]),
                                        tag))
                elif kind == "partition":
                    self._partitions[int(parts[0])] = (int(parts[1]),
                                                       int(parts[2]))
                elif kind == "crash_follower":
                    self._follower_crash[int(parts[0])] = int(parts[1])
                elif kind == "crash_leader":
                    self._leader_crash = int(parts[0])
                elif kind == "flush_fail":
                    self._flush_fail_at = int(parts[0])
                elif kind == "slow_lock":
                    self._slow_lock = (float(parts[0]), float(parts[1]))
                elif kind == "probe_flip":
                    self._probe_flip_at = int(parts[0])
                elif kind == "crash_at":
                    self._crash_at[parts[0]] = int(parts[1])
                elif kind == "fed_down":
                    self._fed_down.add(int(parts[0]))
                else:
                    raise ValueError(f"unknown fault kind {kind!r}")
            except (IndexError, ValueError) as e:
                raise ValueError(
                    f"bad DUKE_FAULTS token {token!r}: {e}") from e

    # -- dispatcher send path -------------------------------------------------

    def check_leader_crash(self, op_index: int) -> None:
        if self._leader_crash is not None and op_index == self._leader_crash:
            _count("crash_leader")
            raise LeaderCrash(
                f"injected leader crash at op {op_index} (DUKE_FAULTS)")

    def before_send(self, tag: str, follower: int, op_index: int,
                    attempt: int) -> None:
        """Called before each send attempt; sleeps for delay faults and
        raises ``InjectedSendFailure`` for drop / partition faults --
        always BEFORE any bytes are written, so a retry is stream-safe."""
        window = self._partitions.get(follower)
        if window is not None and window[0] <= op_index < window[1]:
            _count("partition")
            raise InjectedSendFailure(
                f"injected partition: follower {follower} unreachable "
                f"for op {op_index}")
        if attempt == 0:
            for p, seconds, t in self._delay:
                if (t is None or t == tag) and _unit(
                        self.seed, "delay", op_index, follower) < p:
                    _count("delay")
                    time.sleep(seconds)
                    break
            for p, t in self._drop:
                if (t is None or t == tag) and _unit(
                        self.seed, "drop", op_index, follower) < p:
                    _count("drop")
                    raise InjectedSendFailure(
                        f"injected send drop at op {op_index} "
                        f"(follower {follower})")

    def dup_send(self, tag: str, follower: int, op_index: int) -> bool:
        for p, t in self._dup:
            if (t is None or t == tag) and _unit(
                    self.seed, "dup", op_index, follower) < p:
                _count("dup")
                return True
        return False

    # -- follower loop --------------------------------------------------------

    def follower_crash(self, follower: int, op_count: int) -> bool:
        if self._follower_crash.get(follower) == op_count:
            _count("crash_follower")
            return True
        return False

    # -- write-behind flush ---------------------------------------------------

    def check_flush(self, name: str) -> None:
        """Count one write-behind flush; raise ``InjectedFlushFailure`` at
        the configured occurrence (spec ``flush_fail=<n>``)."""
        if self._flush_fail_at is None:
            return
        with self._lock:
            self._flush_count += 1
            hit = self._flush_count == self._flush_fail_at
        if hit:
            _count("flush_fail")
            raise InjectedFlushFailure(
                f"injected {name} flush failure (DUKE_FAULTS flush_fail)")

    # -- canary prober --------------------------------------------------------

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
            _count("probe_flip")
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
        _count("crash_at")
        print(f"duke-faults: injected crash at {site}", file=sys.stderr,
              flush=True)
        os.kill(os.getpid(), signal.SIGKILL)

    def check_crash(self, site: str) -> None:
        if self.crash_hit(site):
            self.crash_now(site)

    # -- federation router ----------------------------------------------------

    def fed_group_down(self, group: int) -> bool:
        """True iff router calls into federation group ``group`` should
        fail (spec ``fed_down=<g>``) -- the deterministic dead-group fault
        behind the degraded-mode contract."""
        if group in self._fed_down:
            _count("fed_down")
            return True
        return False

    # -- lock paths -----------------------------------------------------------

    def lock_delay(self) -> float:
        """Seconds the feed path should stall before a lock attempt (spec
        ``slow_lock=<p>:<seconds>``; the n-th attempt draws
        ``_unit(seed, "slow_lock", n)``)."""
        if self._slow_lock is None:
            return 0.0
        p, seconds = self._slow_lock
        with self._lock:
            self._lock_count += 1
            n = self._lock_count
        if _unit(self.seed, "slow_lock", n) < p:
            _count("slow_lock")
            return seconds
        return 0.0


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
