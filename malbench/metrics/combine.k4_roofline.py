"""combine.k4_roofline: the local combine (K4) of a step's ``[P, n]``
records into ``[P, S, W, 2]`` against its roofline."""

from malbench import roofline

KERNELS = ("segment_hist_kernel(",
           "hot_sites_kernel(int const*, int const*, unsigned char const*")


def read(run):
    calls = (run.launches or {}).get("segment_hist", 0)
    if run.trace is None or not calls:
        return None
    c = run.config
    b, o = roofline.k4_work(c["nodes"], c["chunk_records"],
                            roofline.padded_sites(c), c["num_weeks"])
    return roofline.share(calls * b, calls * o,
                          roofline.kernel_seconds(run, KERNELS))
