"""ingest_records_per_s: every record folded in the window, over the
window's whole time (serve cells)."""


def read(run):
    if run.traffic["kind"] != "serve":
        return None
    return {"value": run.counters["records"] / run.window_s}
