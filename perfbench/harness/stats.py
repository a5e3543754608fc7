"""Statistics of the end-to-end metrics."""

import math
import statistics


def percentile(values, q):
    """Nearest-rank ``q``-th percentile of all ``values`` (``inf`` for a
    failed solve counts above any limit)."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def spread(values):
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
