"""Capped exponential backoff with full jitter (a copy of the JAX
package's ``utils/backoff.py``): the write-behind flusher's retry ladder
and the feed handler's mid-stream lock retries draw their delays here.
Full jitter (uniform(0, ceiling)) decorrelates retriers contending for
the same resource."""

from __future__ import annotations

import random


def full_jitter_delay(attempt: int, base_s: float, cap_s: float) -> float:
    """Delay before retry ``attempt`` (1-based): uniform in
    [0, min(base * 2^(attempt-1), cap)]."""
    ceiling = min(base_s * (2 ** min(max(attempt, 1) - 1, 32)), cap_s)
    return random.uniform(0, ceiling)
