"""Candidate-index (blocking database) interface.

The framework's equivalent of Duke's ``Database`` plugin point as the
reference subclasses it (IncrementalLuceneDatabase.java:57,459-492): index
records, answer candidate queries with group/deleted filtering, point-lookup
by id.  Implementations:

  * ``index.inverted.InvertedIndex`` -- host token inverted index with
    Lucene-compatible semantics, the ``host`` backend;
  * ``engine.device_matcher.DeviceIndex`` -- the corpus as device-resident
    padded feature tensors scored brute force.
"""

from __future__ import annotations

from typing import List, Optional

from ..core.records import Record


class CandidateIndex:
    def index(self, record: Record) -> None:
        """Add/replace a record (replaces any previous record with same ID)."""
        raise NotImplementedError

    def commit(self) -> None:
        """Make indexed records visible to subsequent queries."""
        raise NotImplementedError

    def find_record_by_id(self, record_id: str) -> Optional[Record]:
        raise NotImplementedError

    def find_candidate_matches(self, record: Record,
                               group_filtering: bool = False) -> List[Record]:
        """Candidate records for pair scoring.

        With ``group_filtering`` (record linkage), records sharing the
        query's ``dukeGroupNo`` are excluded; records flagged
        ``dukeDeleted=true`` are always excluded
        (IncrementalLuceneDatabase.java:467-478).
        """
        raise NotImplementedError

    def delete(self, record: Record) -> None:
        raise NotImplementedError

    def set_indexing_disabled(self, disabled: bool) -> None:
        """http-transform support (IncrementalLuceneDatabase.java:95-97)."""
        raise NotImplementedError

    def close(self) -> None:
        pass
