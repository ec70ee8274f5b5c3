"""device.idle_share.serve: the share of the traced window in which no
operation ran on the device (1 - the union of its activity / the
window), in percent (serve cells)."""


def read(run):
    if run.trace is None or run.traffic["kind"] != "serve":
        return None
    t = run.trace
    return {"value": 100.0 * (1.0 - t["busy_s"] / t["window_s"])}
