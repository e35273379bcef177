"""Link model and link databases: in-memory, and the durable SQLite one
behind write-behind with its crash journal (``link-database-type="h2"``).

``create_link_database`` is a copy of the JAX package's factory
(``links/__init__.py``): same file names, knobs and defaults.
"""

import logging
import os

from ..env import env_flag
from . import journal as journal_mod
from .base import Link, LinkDatabase, LinkKind, LinkStatus
from .journal import LinkJournal
from .memory import InMemoryLinkDatabase
from .sqlite import SqliteLinkDatabase
from .write_behind import WriteBehindLinkDatabase

__all__ = ["Link", "LinkDatabase", "LinkKind", "LinkStatus", "LinkJournal",
           "InMemoryLinkDatabase", "SqliteLinkDatabase",
           "WriteBehindLinkDatabase", "create_link_database"]

logger = logging.getLogger("links")


def create_link_database(link_database_type: str, data_folder=None,
                         is_record_linkage: bool = False) -> LinkDatabase:
    """Factory mirroring App.java:566-611: 'h2' (durable; SQLite here) or
    'in-memory'; 'h2' without a data folder (the ephemeral mode) is in
    memory too.

    Unless ``DUKE_WRITE_BEHIND=0``, the durable backend is wrapped in
    ``WriteBehindLinkDatabase`` so each batch's flush transaction
    overlaps the next batch's scoring; every row-returning read drains
    first, so feed and lookup semantics are unchanged.  Unless
    ``DUKE_JOURNAL=0``, the wrapper journals every sealed batch durably
    BEFORE it is acked and replays journaled-but-unapplied batches here
    at open -- on a background thread behind a write fence unless
    ``DUKE_RECOVERY_OVERLAP=0``.  The in-memory backend is never wrapped.
    """
    if link_database_type == "in-memory":
        return InMemoryLinkDatabase()
    if link_database_type != "h2":
        raise ValueError(
            f"Got an unknown 'link-database-type' value: "
            f"'{link_database_type}'")
    if data_folder is None:
        return InMemoryLinkDatabase()
    name = "recordlinkdatabase" if is_record_linkage else "linkdatabase"
    os.makedirs(data_folder, exist_ok=True)
    journal_path = os.path.join(data_folder, name + ".journal")

    def warn_stranded(why: str) -> None:
        # a journal left by an earlier journaled run may hold acked
        # batches the flusher never applied; with journaling off it is
        # deliberately left untouched (it replays when DUKE_JOURNAL is
        # re-enabled), but stranding acked data must never be silent
        try:
            size = os.path.getsize(journal_path)
        except OSError:
            return
        if size > 0:
            logger.warning(
                "%s: existing link journal %s (%d bytes) is NOT "
                "being replayed (%s); any acked-but-unapplied "
                "batches in it stay stranded until the service "
                "restarts with DUKE_JOURNAL=1",
                data_folder, journal_path, size, why,
            )

    db = SqliteLinkDatabase(os.path.join(data_folder, name + ".sqlite"))
    if not env_flag("DUKE_WRITE_BEHIND", True):
        # synchronous writes: durable before the ack by construction
        warn_stranded("DUKE_WRITE_BEHIND=0")
        return db
    if not env_flag("DUKE_JOURNAL", True):
        logger.warning(
            "DUKE_JOURNAL=0: write-behind link batches for %s are "
            "acknowledged before they are durable; a crash in that "
            "window permanently loses acked links", data_folder,
        )
        warn_stranded("DUKE_JOURNAL=0")
        return WriteBehindLinkDatabase(db)
    journal = LinkJournal(journal_path)
    wrapped = WriteBehindLinkDatabase(db, journal=journal)
    # recovery scoped to this workload's data folder; overlapped replay
    # serves feed reads from the committed prefix (X-Recovering) while
    # writes stay fenced, =0 replays here before the factory returns
    if env_flag("DUKE_RECOVERY_OVERLAP", True):
        wrapped.recover_async(scope=data_folder)
    else:
        with journal_mod.recovery_in_progress(data_folder):
            wrapped.recover()
    return wrapped
