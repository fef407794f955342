"""The benchmark's arithmetic on samples and device intervals."""

import statistics


def percentile(values, q):
    """The ``q``-th percentile (0-100) of ``values``, interpolated linearly
    between the two nearest ranks (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values):
    """The distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def busy_union(intervals):
    """The length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy


def idle_gaps(intervals, lo, hi):
    """The gaps ``(start, end)`` inside ``[lo, hi]`` that no interval covers."""
    gaps, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            gaps.append((at, min(a, hi)))
        at = max(at, b)
    if at < hi:
        gaps.append((at, hi))
    return [(a, b) for a, b in gaps if b > a]
