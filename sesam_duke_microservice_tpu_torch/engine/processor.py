"""Host pair scoring: the exact f64 oracle the device path finalizes with.

Counterpart of the JAX package's ``engine/processor.py``, reduced to what
the device backend uses: ``Processor.compare`` (per comparison property,
the max over value pairs of ``Property.compare_probability``, folded with
naive Bayes from a 0.5 prior; properties with no values on either side
contribute nothing) and the ``ProfileStats`` counters.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.bayes import combine_probabilities
from ..core.config import DukeSchema
from ..core.records import Record


@dataclass
class ProfileStats:
    batches: int = 0
    records_processed: int = 0
    candidates_retrieved: int = 0
    pairs_compared: int = 0
    # host-finalization split: survivors rescored with the exact f64
    # compare vs survivors skipped by decisive-band pruning
    pairs_rescored: int = 0
    pairs_skipped: int = 0
    retrieval_seconds: float = 0.0
    compare_seconds: float = 0.0


class Processor:
    """Naive-Bayes pair probability over a schema's comparison properties."""

    def __init__(self, schema: DukeSchema):
        self.schema = schema

    def compare(self, r1: Record, r2: Record) -> float:
        probs = []
        for prop in self.schema.comparison_properties():
            vs1 = [v for v in r1.get_values(prop.name) if v]
            vs2 = [v for v in r2.get_values(prop.name) if v]
            if not vs1 or not vs2:
                continue
            best = 0.0
            for v1 in vs1:
                for v2 in vs2:
                    p = prop.compare_probability(v1, v2)
                    if p > best:
                        best = p
            probs.append(best)
        return combine_probabilities(probs)
