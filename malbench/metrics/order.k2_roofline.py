"""order.k2_roofline: the stable scatter of a step's words by destination
(K2) against its roofline."""

from malbench import roofline

KERNELS = ("scatter_tiles_kernel(",)


def read(run):
    calls = (run.launches or {}).get("count_scatter.scatter", 0)
    if run.trace is None or not calls:
        return None
    c = run.config
    b, o = roofline.k2_work(c["nodes"], c["chunk_records"], c["nodes"])
    return roofline.share(calls * b, calls * o,
                          roofline.kernel_seconds(run, KERNELS))
