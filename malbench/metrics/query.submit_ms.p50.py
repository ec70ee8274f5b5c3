"""query.submit_ms.p50: the median host time of
``MalStoneService.submit`` (encode, snapshot refresh, K5's launch): host
paced, so a per-layer number."""

from malbench.stats import percentile


def read(run):
    samples = run.counters.get("submit_s") or []
    if not samples:
        return None
    return {"value": 1e3 * percentile(samples, 50), "samples": len(samples)}
