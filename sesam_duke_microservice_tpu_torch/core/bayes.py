"""Naive-Bayes probability combination (Duke's ``Utils.computeBayes``).

The matching engine combines per-property match probabilities with the
classic naive-Bayes odds product, starting from a 0.5 prior (reference hot
loop: SURVEY.md section 3.2; driven from App.java:1005 / App.java:1159 into the
Duke jar).  The equivalent log-odds form used on device is::

    combined = sigmoid(sum_i logit(p_i))

which is exactly the repeated ``compute_bayes`` fold — on TPU the combine is
therefore a masked sum over a logit tensor (see ops.bayes).
"""

from __future__ import annotations

import math
from typing import Iterable

# Probabilities are clamped away from {0, 1} so a single certain property
# cannot produce inf logits; 1e-10 keeps us well inside float32 on device.
_EPS = 1e-10


def compute_bayes(p1: float, p2: float) -> float:
    """Combine two probabilities: ``p1*p2 / (p1*p2 + (1-p1)*(1-p2))``."""
    num = p1 * p2
    den = num + (1.0 - p1) * (1.0 - p2)
    if den == 0.0:
        return 0.5
    return num / den


def probability_logit(p: float) -> float:
    """log-odds of p, clamped to avoid infinities."""
    p = min(max(p, _EPS), 1.0 - _EPS)
    return math.log(p / (1.0 - p))


def combine_probabilities(probabilities: Iterable[float]) -> float:
    """Fold probabilities with naive Bayes from a 0.5 prior.

    Implemented in log-odds space (mathematically identical to the pairwise
    ``compute_bayes`` fold, and the formulation the device kernels use).
    """
    total = 0.0
    for p in probabilities:
        total += probability_logit(p)
    return 1.0 / (1.0 + math.exp(-total))
