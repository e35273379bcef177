"""Sharded serving federation (the JAX package's ``federation/`` on torch).

Everything below this package is ONE serving group: a corpus that must
fit one card's memory, one ingest path serialized through one workload
lock, one link feed.  This package puts a **digest-range partition
router** above N independent groups:

  * ``ranges.py`` -- the partition map: the 64-bit routing keyspace
    (``route_key`` over the store record id) split into fixed digest
    ranges, each owned by one group; versioned, epoch-stamped and
    atomically persisted, so a stale router can never write to a
    range's old owner.
  * ``router.py`` -- the scatter-gather router: ingest batches partition
    by owner group and fan out with per-group timeouts and bounded
    full-jitter retries; link feeds merge across groups under a
    composite per-range cursor (the opaque federated ``?since=`` token);
    a dead group degrades only ITS ranges (503 + Retry-After) while the
    rest keep serving.
  * ``migrate.py`` -- live range rebalancing as a crash-consistent state
    machine (freeze → snapshot → journal-slice replay → cutover →
    drain), built from the durable-state primitives: checksummed
    state shipping, idempotent ``assert_links``, epoch fencing,
    watermarked journal replay.  Proven by a kill-at-every-site chaos
    differential (tests/test_torch_federation_chaos.py).

``Federation`` (here) assembles the pieces: it builds the N groups from
one ServiceConfig (per-group data folders under ``<root>/federation/
g<i>``), loads-or-creates the partition map, resumes any interrupted
migration, and hands the router to the HTTP frontend
(``service/federation_plane.py``).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Tuple

from ..core.config import ServiceConfig
from ..engine.workload import Workload, build_workload, resolve_device
from .migrate import MIGRATION_STATE_FILE, RangeMigrator
from .ranges import PartitionMap, route_key  # noqa: F401  (re-export)
from .router import FederationRouter, LocalGroup

logger = logging.getLogger("federation")

__all__ = [
    "Federation",
    "FederationRouter",
    "LocalGroup",
    "PartitionMap",
    "RangeMigrator",
    "route_key",
]

DEFAULT_RANGES_PER_GROUP = 4


class Federation:
    """N serving groups + partition map + router + migrator, one bundle.

    Each group is a full serving stack (every configured workload built
    via ``build_workload`` over the group's OWN data folder -- its own
    record stores, link journals, corpus snapshots), so group state is
    as isolated on disk as it would be across machines; ``LocalGroup``
    is the in-process stand-in for the group's leader endpoint, and the
    router only ever talks through that seam.  A real multi-host
    deployment slots an RPC client into the same seam -- the map,
    cursor, fencing and migration semantics are transport-independent.
    """

    def __init__(self, config: ServiceConfig, *, n_groups: int,
                 data_folder: Optional[str] = None,
                 ranges_per_group: int = DEFAULT_RANGES_PER_GROUP,
                 backend: str = "host", device="cuda"):
        if n_groups < 1:
            raise ValueError("a federation needs at least one group")
        self.config = config
        self.backend = backend
        # every group's workloads score on this one device (the host
        # backend runs no device code and resolves none); ``cuda`` without
        # a card raises here, before any folder is touched
        self.device = None if backend == "host" else resolve_device(device)
        root = data_folder or config.data_folder
        self.data_folder = os.path.join(root, "federation")
        os.makedirs(self.data_folder, exist_ok=True)
        self.map_path = os.path.join(self.data_folder, "partition_map.json")
        self.map = PartitionMap.load_or_create(
            self.map_path, n_groups=n_groups,
            n_ranges=max(1, ranges_per_group) * n_groups)
        if self.map.n_groups != n_groups:
            raise ValueError(
                f"persisted partition map names {self.map.n_groups} "
                f"group(s), but the federation was started with "
                f"{n_groups} -- group topology changes go through range "
                "migration, not a restart flag")
        self.groups: List[LocalGroup] = [
            LocalGroup(idx, self._build_group(idx), epoch=self.map.epoch)
            for idx in range(n_groups)
        ]
        self.router = FederationRouter(lambda: self.map, self.groups)
        self.migrator = RangeMigrator(self)
        # one admin migration at a time; the flag flips under the lock,
        # the migration body runs WITHOUT it (it takes workload locks)
        self._admin_lock = threading.Lock()
        self._migrating: Optional[str] = None  # guarded by: self._admin_lock [writes]
        # a migration interrupted by a crash resumes before serving --
        # the frozen range stays frozen (writes 429) until it completes,
        # so resume-at-start mirrors journal recovery's stance: finish
        # the redo before traffic
        if os.path.exists(os.path.join(self.data_folder,
                                       MIGRATION_STATE_FILE)):
            logger.warning("resuming interrupted range migration")
            self.migrator.resume()

    # -- group assembly -------------------------------------------------------

    def group_folder(self, idx: int) -> str:
        return os.path.join(self.data_folder, f"g{idx}")

    def _build_group(self, idx: int) -> Dict[Tuple[str, str], Workload]:
        """Every configured workload, built over group ``idx``'s own
        data folder (journal recovery and store replay run inside
        ``build_workload`` exactly as for a standalone service -- scoped
        to the group folder, so one group's replay flips only its own
        readiness)."""
        import dataclasses

        out: Dict[Tuple[str, str], Workload] = {}
        for kind, registry in (("deduplication", self.config.deduplications),
                               ("recordlinkage",
                                self.config.record_linkages)):
            for name, wc in registry.items():
                folder = os.path.join(self.group_folder(idx), kind, name)
                os.makedirs(folder, exist_ok=True)
                gwc = dataclasses.replace(wc, data_folder=folder)
                out[(kind, name)] = build_workload(
                    gwc, self.config, backend=self.backend,
                    device=self.device or "cpu", persistent=True)
        return out

    def group_folders(self) -> List[str]:
        """Every per-workload data folder across groups -- the readiness
        probe's recovery scopes."""
        out = []
        for idx in range(len(self.groups)):
            for (kind, name) in self.groups[idx].workloads:
                out.append(os.path.join(self.group_folder(idx), kind, name))
        return out

    # -- admin: live rebalancing ----------------------------------------------

    def migrate_range(self, range_id: str, target_group: int) -> dict:
        """Move one digest range to ``target_group`` live (the writes to
        that range 429 during the freeze window; reads and every other
        range keep serving).  Serialized: one migration at a time."""
        with self._admin_lock:
            if self._migrating is not None:
                raise RuntimeError(
                    f"migration of range {self._migrating} already in "
                    "progress")
            self._migrating = range_id
        try:
            return self.migrator.migrate(range_id, target_group)
        finally:
            with self._admin_lock:
                self._migrating = None

    def migration_status(self) -> dict:
        return self.migrator.status()

    def close(self) -> None:
        for group in self.groups:
            group.close()
