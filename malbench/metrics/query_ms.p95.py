"""query_ms.p95: the 95th percentile of every query batch due in the
window, each timed from its due time to its answers on the host (serve
cells)."""

from malbench.stats import percentile


def read(run):
    if run.traffic["kind"] != "serve" or not run.counters["latency_s"]:
        return None
    return {"value": 1e3 * percentile(run.counters["latency_s"], 95),
            "samples": len(run.counters["latency_s"])}
