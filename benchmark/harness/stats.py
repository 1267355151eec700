"""Statistics of a run and of a set of runs."""

import statistics

import numpy as np


def rate(count, seconds):
    """Work over the whole window: ``count`` over ``seconds``."""
    if seconds <= 0:
        raise ValueError("a rate needs a window longer than 0 s")
    return count / seconds


def percentile(values, q):
    """The ``q``-th percentile of all ``values`` (linear between order
    statistics)."""
    if not len(values):
        raise ValueError("a percentile of no values")
    return float(np.percentile(np.asarray(values, np.float64), q))


def spread(values):
    """Distance between the first and third quartile (``statistics.
    quantiles(n=4)``) as a share of the median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
