"""Percentiles of the host-clock samples (linear interpolation over the
sorted samples, as ``repro_torch.bench.schema.latency_percentiles``)."""

from __future__ import annotations


def percentile(samples, p: float):
    """The ``p``-th percentile of ``samples``, or ``None`` for none."""
    s = sorted(float(x) for x in samples)
    if not s:
        return None
    rank = p / 100.0 * (len(s) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (rank - lo)
