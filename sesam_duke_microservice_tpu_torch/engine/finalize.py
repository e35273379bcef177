"""Host finalization of device-scored survivor pairs.

Counterpart of the JAX package's ``engine/finalize.py`` on its host path
(``device=False``, i.e. ``DUKE_DEVICE_FINALIZE=0``, whose event stream and
link rows the JAX package documents as bit-identical to its default):

  * **Parallel**: per-query survivor finalization fans out over a worker
    pool sized by ``DUKE_FINALIZE_THREADS`` (else the processor's
    ``threads``).  Workers only compute the exact f64 ``compare`` per
    survivor and the would-be events; the caller emits listener events in
    strict query order, so streams are identical at any thread count.
  * **Skippable** (decisive-band pruning, ``DUKE_DECISIVE_BAND``): a
    survivor whose optimistic device logit, with the certified f32 margin
    credited in its favor, still cannot reach ``min(threshold,
    maybe_threshold)`` emits no event, so its host ``compare`` is skipped.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

from ..core.records import Record
from ..env import env_flag, env_str
from ..ops import bounds as B


class QueryOutcome:
    """One query's finalization result: ``events`` holds
    ``(event_name, candidate, probability)`` in survivor (descending device
    logit) order; an empty list means ``no_match_for``."""

    __slots__ = ("events", "survivors", "rescored", "skipped")

    def __init__(self, events: List[Tuple[str, Record, float]],
                 survivors: int, rescored: int, skipped: int):
        self.events = events
        self.survivors = survivors
        self.rescored = rescored
        self.skipped = skipped


def _resolve_threads(threads: int) -> int:
    env = env_str("DUKE_FINALIZE_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            logging.getLogger("finalize").warning(
                "ignoring non-integer DUKE_FINALIZE_THREADS=%r", env)
    return max(1, threads)


class FinalizeExecutor:
    """Block-scoped survivor-finalization executor (one per processor; the
    pool is created on the first multi-threaded block and reused)."""

    def __init__(self, threads: int = 1):
        self.threads = _resolve_threads(threads)
        self.decisive = env_flag("DUKE_DECISIVE_BAND", True)
        self._pool: Optional[ThreadPoolExecutor] = None

    def shutdown(self) -> None:
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def finalize_block(self, proc, block: Sequence[Record],
                       result) -> List[QueryOutcome]:
        """Every query's outcome for one scored block, in query order.

        ``proc`` is the owning DeviceProcessor (``compare``, the record
        mirror, thresholds); ``result`` is the resolved ``_BlockResult``.
        """
        database = proc.database
        row_ids = database.corpus.row_ids
        resolver = database.records.get
        threshold = proc.schema.threshold
        maybe = proc.schema.maybe_threshold
        # recomputed per block: long-text demotion can move a property to
        # the host side between batches, and the bound must track it
        prune = (B.decisive_prune_logit(proc.schema, database.plan)
                 if self.decisive else None)
        compare = proc.compare

        def one(qi: int, record: Record) -> QueryOutcome:
            events: List[Tuple[str, Record, float]] = []
            survivors = result.survivor_triples(qi)
            rescored = skipped = 0
            rec_id = record.record_id
            for _, row, device_logit in survivors:
                rid = row_ids[row]
                if rid is None or rid == rec_id:
                    continue
                if prune is not None and device_logit <= prune:
                    skipped += 1
                    continue
                candidate = resolver(rid)
                if candidate is None:
                    continue
                prob = compare(record, candidate)
                rescored += 1
                if prob > threshold:
                    events.append(("matches", candidate, prob))
                elif maybe is not None and maybe != 0.0 and prob > maybe:
                    events.append(("matches_perhaps", candidate, prob))
            return QueryOutcome(events, len(survivors), rescored, skipped)

        if self.threads <= 1 or len(block) <= 1:
            return [one(qi, r) for qi, r in enumerate(block)]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.threads,
                                            thread_name_prefix="finalize")
        # map() preserves submission order: outcomes line up with the block
        return list(self._pool.map(one, range(len(block)), block))
