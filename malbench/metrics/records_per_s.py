"""records_per_s: every record of every job in the window, over the
window's whole time (batch cells)."""


def read(run):
    if run.traffic["kind"] != "batch":
        return None
    return {"value": run.counters["records"] / run.window_s}
