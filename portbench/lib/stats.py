"""Percentiles over every sample."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of all of ``values``, linear
    between the two nearest ranks; a missing sample is ``inf`` and
    counts as the slowest."""
    if not values:
        return math.nan
    v = sorted(values)
    at = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(at), math.ceil(at)
    if lo == hi or v[hi] == v[lo]:
        return float(v[lo])
    return float(v[lo] + (v[hi] - v[lo]) * (at - lo))

